"""Plain reference of RO-MAP's object field, in PyTorch, float32, one
object at a time (the field module contract: `portbench/reference/
__init__.py`). It imports nothing of the program under test: every size
comes from the configuration file under `portbench/configs/`, every input
(frames, object table, weights, random draws) from the benchmark.

  encode    the configuration's encoding (`encodings`): the MX-grid or the
            tiny-cuda-nn hash grid
  MLP       one head, bias-free, relu hidden layers, fp32 output (rgb
            logits, log sigma); no view direction
  rays, render, loss, optimizer: `train`

`Precision` rounds the weights at use, the encode's output and the hidden
activations through a narrower type, and their gradients on the way back:
the control of the comparison.
"""

from __future__ import annotations

import torch

from portbench.reference import encodings, train
from portbench.reference.precision import FP32, Precision

fresh_state = train.fresh_state


def _dims(cfg: dict) -> list[int]:
    net = cfg["network"]
    return ([encodings.out_dims(cfg["encoding"])] + [net["n_neurons"]] * net["n_hidden_layers"]
            + [net["output_dims"]])


def leaf_shapes(cfg: dict) -> dict:
    """{leaf name: shape of one object's leaf}, in a fixed order: the
    encoding's, then the head's matrices `w{i}`, (in, out), first to last."""
    shapes = encodings.leaf_shapes(cfg["encoding"])
    d = _dims(cfg)
    for i, shape in enumerate(zip(d[:-1], d[1:])):
        shapes[f"w{i}"] = shape
    return shapes


def init_weights(gen: torch.Generator, cfg: dict, n_objects: int) -> dict:
    """`train.init_leaves` over `leaf_shapes`: MX-grid factors N(0, 0.3^2),
    hash table U(-1e-4, 1e-4), MLP He-uniform."""
    return train.init_leaves(gen, leaf_shapes(cfg), n_objects)


def forward(w: dict, pts: torch.Tensor, dirs, cfg: dict, q: Precision, c):
    """Raw outputs [R, S, 4] of one object's field at `pts` [R, S, 3]; the
    head takes no view direction (`dirs` unused)."""
    h = encodings.encode(w, pts.reshape(-1, 3), cfg["encoding"], q, c)
    n_mats = cfg["network"]["n_hidden_layers"] + 1
    for i in range(n_mats - 1):
        h = q(torch.relu(h @ q(w[f"w{i}"])))
    raw = h @ q(w[f"w{n_mats - 1}"])
    return raw.reshape(*pts.shape[:-1], raw.shape[-1])


def step(state: dict, frames: dict, obj: dict, draws, cfg: dict, q: Precision = FP32):
    """One train step of one object (`train.step` around `forward`)."""
    return train.step(forward, state, frames, obj, draws, cfg, q)
