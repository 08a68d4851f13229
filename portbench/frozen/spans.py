"""Frozen copy of the span wrappers of `romap_tpu_torch/tools/profile_step.py::
Spans`: `torch.profiler.record_function` spans around the parts of
`models/nerf.py::_object_train_step`, installed by wrapping the functions it
calls through the module (`restore()` undoes it). The program carries no
spans of its own.

Changes from the copy's original, each so that the spans cover a whole
step of either encode: the hash grid's `encode` is wrapped beside the
MX-grid kernels'; `draw_uniforms` (the step's random draws) counts as
batch generation; the optimizer span opens at `_optimizer_update` and stays
open over the masked update that follows it (rate, parameters, EMA, the
per-slot `where`) until the next step's draws or `close()`.

The backward spans open and close in tensor hooks, on the autograd thread
that launches those kernels.
"""

from __future__ import annotations

import torch

SPANS = ("batch generation", "encode forward", "MLP forward", "render + loss",
         "render + loss backward", "MLP backward", "encode backward", "optimizer")


class Spans:
    def __init__(self, nerf):
        self.nerf = nerf
        self.saved = {name: getattr(nerf, name) for name in
                      ("draw_uniforms", "generate_batch", "apply_mlp", "composite_loss",
                       "_optimizer_update")}
        self.saved_encode = (nerf.mxgrid_cuda.encode, nerf.hashgrid.encode)
        self.open = None  # the backward span now open on the autograd thread
        self.open_main = None  # the optimizer span, open on the caller's thread
        nerf.draw_uniforms = self.draw_uniforms
        nerf.generate_batch = self.spanned("batch generation", self.saved["generate_batch"])
        nerf._optimizer_update = self.optimizer
        nerf.composite_loss = self.composite_loss
        nerf.apply_mlp = self.apply_mlp
        nerf.mxgrid_cuda.encode = self.encoder(self.saved_encode[0])
        nerf.hashgrid.encode = self.encoder(self.saved_encode[1])

    def restore(self):
        self.close()
        for name, fn in self.saved.items():
            setattr(self.nerf, name, fn)
        self.nerf.mxgrid_cuda.encode, self.nerf.hashgrid.encode = self.saved_encode

    def close(self):
        """Close the optimizer span left open by the last step."""
        if self.open_main is not None:
            self.open_main.__exit__(None, None, None)
            self.open_main = None

    @staticmethod
    def spanned(name, fn):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapper

    def switch(self, name):
        """Close the open backward span and open `name` (None: none)."""
        if self.open is not None:
            self.open.__exit__(None, None, None)
        self.open = torch.profiler.record_function(name) if name else None
        if self.open is not None:
            self.open.__enter__()

    def hook(self, tensor, name):
        """When the backward pass has `tensor`'s gradient: the span `name`."""
        if tensor.requires_grad:
            tensor.register_hook(lambda grad: self.switch(name))

    def draw_uniforms(self, *args, **kwargs):
        self.close()
        with torch.profiler.record_function("batch generation"):
            return self.saved["draw_uniforms"](*args, **kwargs)

    def apply_mlp(self, mlp, feats, network):
        with torch.profiler.record_function("MLP forward"):
            raw = self.saved["apply_mlp"](mlp, feats, network)
        self.hook(raw, "MLP backward")       # the loss's backward ends here
        self.hook(feats, "encode backward")  # ... and the MLP's here
        return raw

    def encoder(self, fn):
        def encode(factors, points, spec):
            with torch.profiler.record_function("encode forward"):
                out = fn(factors, points, spec)
            # the tables' gradients leave the encode's backward node together
            self.hook(factors["lines"] if isinstance(factors, dict) else factors, None)
            return out
        return encode

    def composite_loss(self, raw, batch, train):
        with torch.profiler.record_function("render + loss"):
            loss, aux = self.saved["composite_loss"](raw, batch, train)
        self.hook(loss, "render + loss backward")
        return loss, aux

    def optimizer(self, *args, **kwargs):
        self.close()
        self.open_main = torch.profiler.record_function("optimizer")
        self.open_main.__enter__()
        return self.saved["_optimizer_update"](*args, **kwargs)
