"""Checkpoint/resume for the batched NeRF state (counterpart of
romap_tpu/utils/checkpoint.py, which writes with orbax).

The whole TrainState (params, EMA, optimizer moments, step counters, loss)
plus an optional object table is written with `torch.save` to one file, as
nested dicts and lists of CPU tensors (so `torch.load(weights_only=True)`
reads it back); metadata that is not an array goes to the same JSON sidecar
as the reference's, `<path>.meta.json`.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from romap_tpu_torch.models.nerf import ObjectsState


def _plain(tree):
    """NamedTuples -> dicts by field, tuples -> lists, tensors -> CPU."""
    if hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_checkpoint(path: str, state, objects=None, extra: dict | None = None) -> None:
    """Write state (+ optional ObjectsState) to the file `path`; `extra`
    goes to the JSON sidecar."""
    payload: dict[str, Any] = {"state": _plain(state)}
    if objects is not None:
        payload["objects"] = _plain(objects)
    path = os.path.abspath(path)
    torch.save(payload, path)
    if extra:
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)


def load_checkpoint(path: str) -> dict[str, Any]:
    """Read back the raw tree (CPU tensors); the caller re-wraps it into a
    TrainState / ObjectsState. Sidecar metadata under key 'extra'."""
    path = os.path.abspath(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    out = dict(torch.load(path, map_location="cpu", weights_only=True))
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            out["extra"] = json.load(f)
    return out


def _conform(raw, t):
    """Rebuild the plain tree `raw` into the structure of template node `t`,
    matching by name (dict key / NamedTuple field); each leaf moves to the
    template leaf's device."""
    if isinstance(t, dict):
        return {k: _conform(raw[k], v) for k, v in t.items()}
    if hasattr(t, "_fields"):
        return type(t)(*(_conform(raw[f], v) for f, v in zip(t._fields, t)))
    if isinstance(t, (list, tuple)):
        items = [_conform(r, v) for r, v in zip(raw, t)]
        return items if isinstance(t, list) else tuple(items)
    return raw.to(t.device) if torch.is_tensor(t) else raw


def restore_train_state(raw_state: dict, template):
    """A models.nerf.TrainState from a loaded checkpoint's "state": pass a
    freshly initialized TrainState of the same config and capacity as
    `template`."""
    return _conform(raw_state, template)


def restore_objects(raw_objects: dict, device="cpu") -> ObjectsState:
    """An ObjectsState from a loaded checkpoint's "objects", on `device`."""
    return ObjectsState(**{k: raw_objects[k].to(device) for k in ObjectsState._fields})
