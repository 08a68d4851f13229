"""Plain reference of instant-ngp's NeRF (NVlabs/instant-ngp,
`configs/nerf/base.json`; Müller et al., SIGGRAPH 2022, §5.4), in PyTorch,
float32, one object at a time (the field module contract: `portbench/
reference/__init__.py`). It imports nothing of the program under test:
every size comes from the configuration file under `portbench/configs/`,
every input (frames, object table, weights, random draws) from the
benchmark.

  encode    the configuration's encoding (`encodings`), the hash grid
  density   bias-free, relu hidden layers, [encoding] -> n_neurons x
            n_hidden_layers -> output_dims; output 0 is the
            log-density, all of them feed the colour network
  direction the 16 real spherical harmonics of degrees 0-3 of the ray's
            unit direction in the object frame (tiny-cuda-nn's
            SphericalHarmonics at degree 4), once a ray, for every sample
  colour    bias-free, relu hidden layers, [density outputs, SH] ->
            rgb_n_neurons x rgb_n_hidden_layers -> 3 rgb logits
  rays, render, loss, optimizer: `train`

`Precision` rounds the weights at use, the encode's output, the hidden
activations and each network's input (the density outputs and the SH
enter the colour network in the compute precision), and their gradients on
the way back; each network's last product, and the log-density, stay fp32.
"""

from __future__ import annotations

import torch

from portbench.reference import encodings, train
from portbench.reference.precision import FP32, Precision

fresh_state = train.fresh_state
SH_DIMS = 16


def sh4(d: torch.Tensor) -> torch.Tensor:
    """[N, 3] unit directions -> [N, 16]: the real spherical harmonics of
    degrees 0-3 in tiny-cuda-nn's order and signs, orthonormal on the
    sphere (Y_l^m with the Condon-Shortley phase)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    pi = torch.pi
    c0 = 0.5 / pi**0.5
    c1 = (3.0 / (4 * pi)) ** 0.5
    c2a, c2b = (15.0 / (4 * pi)) ** 0.5, (5.0 / (16 * pi)) ** 0.5
    c2c = (15.0 / (16 * pi)) ** 0.5
    c3a, c3b = (35.0 / (32 * pi)) ** 0.5, (105.0 / (4 * pi)) ** 0.5
    c3c, c3d = (21.0 / (32 * pi)) ** 0.5, (7.0 / (16 * pi)) ** 0.5
    c3e = (105.0 / (16 * pi)) ** 0.5
    return torch.stack([
        torch.full_like(x, c0),
        -c1 * y, c1 * z, -c1 * x,
        c2a * x * y, -c2a * y * z, c2b * (3 * z * z - 1), -c2a * x * z,
        c2c * (x * x - y * y),
        c3a * y * (y * y - 3 * x * x), c3b * x * y * z, c3c * y * (1 - 5 * z * z),
        c3d * z * (5 * z * z - 3), c3c * x * (1 - 5 * z * z), c3e * z * (x * x - y * y),
        c3a * x * (3 * y * y - x * x),
    ], dim=-1)


def _widths(cfg: dict) -> tuple[list[int], list[int]]:
    net = cfg["network"]
    enc = encodings.out_dims(cfg["encoding"])
    geo = net["output_dims"]
    density = [enc] + [net["n_neurons"]] * net["n_hidden_layers"] + [geo]
    rgb = [geo + SH_DIMS] + [net["rgb_n_neurons"]] * net["rgb_n_hidden_layers"] + [3]
    return density, rgb


def leaf_shapes(cfg: dict) -> dict:
    """{leaf name: shape of one object's leaf}, in a fixed order: the
    encoding's `table`, then `density.w{i}` and `rgb.w{i}`, (in, out),
    first to last."""
    shapes = encodings.leaf_shapes(cfg["encoding"])
    for net, d in zip(("density", "rgb"), _widths(cfg)):
        for i, shape in enumerate(zip(d[:-1], d[1:])):
            shapes[f"{net}.w{i}"] = shape
    return shapes


def init_weights(gen: torch.Generator, cfg: dict, n_objects: int) -> dict:
    """`train.init_leaves` over `leaf_shapes`: hash table U(-1e-4, 1e-4),
    every matrix He-uniform."""
    return train.init_leaves(gen, leaf_shapes(cfg), n_objects)


def _chain(w: dict, net: str, h: torch.Tensor, n_mats: int, q: Precision):
    for i in range(n_mats - 1):
        h = q(torch.relu(h @ q(w[f"{net}.w{i}"])))
    return h @ q(w[f"{net}.w{n_mats - 1}"])


def forward(w: dict, pts: torch.Tensor, dirs: torch.Tensor, cfg: dict, q: Precision, c):
    """Raw outputs [R, S, 4] (rgb logits, log-density) of one object's
    field at `pts` [R, S, 3] on rays of unit directions `dirs` [R, 3]."""
    net = cfg["network"]
    r, s = pts.shape[:2]
    h = encodings.encode(w, pts.reshape(-1, 3), cfg["encoding"], q, c)
    geo = _chain(w, "density", h, net["n_hidden_layers"] + 1, q)
    sh = sh4(dirs)[:, None, :].expand(r, s, SH_DIMS).reshape(-1, SH_DIMS)
    rgb = _chain(w, "rgb", torch.cat([q(geo), q(sh)], dim=-1), net["rgb_n_hidden_layers"] + 1, q)
    return torch.cat([rgb, geo[:, :1]], dim=-1).reshape(r, s, 4)


def step(state: dict, frames: dict, obj: dict, draws, cfg: dict, q: Precision = FP32):
    """One train step of one object (`train.step` around `forward`)."""
    return train.step(forward, state, frames, obj, draws, cfg, q)
