"""Faults planted in the program's timed path, each a context manager, for
the test that `correct` comes out false and for the readings that set the
limits (`portbench/calibrate.py --fault`). A training cell can have two:

  unchanged   a step that returns its state unchanged
  half_batch  half of each object's rays left out, the mean taken over the
              rest (`composite_loss` on the first half)

It has no exchange between chips (one card) and no answer produced token
by token, so the other two faults of a run have no place here. One more
is the EMA's own, which only `ema_gap` sees:

  ema_decay   the EMA blended with another decay (0.99) than the
              configuration states
"""

from __future__ import annotations

import contextlib
import dataclasses

from romap_tpu_torch.models import nerf


@contextlib.contextmanager
def _patched(name, fn):
    real = getattr(nerf, name)
    setattr(nerf, name, fn(real))
    try:
        yield
    finally:
        setattr(nerf, name, real)


def unchanged():
    return _patched("_object_train_step", lambda real: lambda state, *a, **k: state)


def half_batch():
    def make(real):
        def loss(raw, batch, train):
            h = raw.shape[1] // 2
            cut = batch._replace(**{f: getattr(batch, f)[:, :h] for f in batch._fields
                                    if f != "valid"})
            return real(raw[:, :h], cut, train)
        return loss
    return _patched("composite_loss", make)


def ema_decay(decay: float = 0.99):
    def make(real):
        def step(state, frames, objects, cfg, *args, **kwargs):
            opt = dataclasses.replace(cfg.optimizer, ema_decay=decay)
            return real(state, frames, objects, dataclasses.replace(cfg, optimizer=opt), *args,
                        **kwargs)
        return step
    return _patched("_object_train_step", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "ema_decay": ema_decay}
