"""Plain reference of NeuS2's neural-surface field (Wang et al., "NeuS2:
Fast Learning of Neural Implicit Surfaces for Multi-view Reconstruction",
ICCV 2023, github.com/19reborn/NeuS2), rendered by NeuS's SDF-to-alpha
rule (Wang et al., NeurIPS 2021, github.com/Totoro97/NeuS,
`models/renderer.py`), in PyTorch, float32, one object at a time (the
field module contract: `portbench/reference/__init__.py`). It imports
nothing of the program under test: every size comes from the configuration
file under `portbench/configs/`, every input (frames, object table,
weights, random draws) from the benchmark.

  encode    the configuration's encoding (`encodings`), the hash grid
  SDF       bias-free, relu hidden layers, [encoding] -> n_neurons x
            n_hidden_layers -> output_dims; output 0 is the signed distance
            f (negative inside), the rest the geometry features z
  normal    n = grad f in the object frame: autograd's gradient in the
            warped point (`create_graph`, so the loss's gradient flows
            through it), divided per axis by the box's extent
  colour    bias-free, relu hidden layers, NeuS's `idr` inputs [warped
            point, n, SH of the ray's direction (`ngp.sh4`), z] ->
            rgb_n_neurons x rgb_n_hidden_layers -> 3 rgb logits
  variance  one scalar v an object; inv_s = clamp(exp(10 v), 1e-6, 1e6)
  render    NeuS's rule at the stratified samples (`loss_of`)
  loss      RGB over the random background (weights and 1 - opacity cut
            on background rays), 0.5 |opacity - is_object|, and NeuS's
            eikonal term, eikonal_lambda times the mean of (|n| - 1)^2 over
            the samples; the logged loss is the console loss
  rays, optimizer: `train.rays`, `train.adam_ema`

`Precision` rounds the weights at use, the encode's output, the hidden
activations and each network's input, and their gradients on the way back
(the normal's too, as autograd forms it through them); each network's last
product, f, n and the render stay fp32.
"""

from __future__ import annotations

import torch

from portbench.reference import encodings, train
from portbench.reference.ngp import SH_DIMS, sh4
from portbench.reference.precision import FP32, Precision

fresh_state = train.fresh_state


def _widths(cfg: dict) -> tuple[list[int], list[int]]:
    net = cfg["network"]
    enc = encodings.out_dims(cfg["encoding"])
    geo = net["output_dims"]
    sdf = [enc] + [net["n_neurons"]] * net["n_hidden_layers"] + [geo]
    rgb = ([3 + 3 + SH_DIMS + geo - 1] + [net["rgb_n_neurons"]] * net["rgb_n_hidden_layers"]
           + [3])
    return sdf, rgb


def leaf_shapes(cfg: dict) -> dict:
    """{leaf name: shape of one object's leaf}, in a fixed order: the
    encoding's `table`, then `sdf.w{i}` and `rgb.w{i}`, (in, out), first to
    last, then `variance` (1,)."""
    shapes = encodings.leaf_shapes(cfg["encoding"])
    for net, d in zip(("sdf", "rgb"), _widths(cfg)):
        for i, shape in enumerate(zip(d[:-1], d[1:])):
            shapes[f"{net}.w{i}"] = shape
    shapes["variance"] = (1,)
    return shapes


def init_weights(gen: torch.Generator, cfg: dict, n_objects: int) -> dict:
    """`train.init_leaves` over the table and the matrices (hash table
    U(-1e-4, 1e-4), every matrix He-uniform); the variance at the
    configuration's `init_variance` (NeuS's 0.3) for every object."""
    shapes = leaf_shapes(cfg)
    w = train.init_leaves(gen, {k: v for k, v in shapes.items() if k != "variance"}, n_objects)
    w["variance"] = torch.full((n_objects, 1), float(cfg["network"]["init_variance"]),
                               device=gen.device)
    return w


def _chain(w: dict, net: str, h: torch.Tensor, n_mats: int, q: Precision):
    for i in range(n_mats - 1):
        h = q(torch.relu(h @ q(w[f"{net}.w{i}"])))
    return h @ q(w[f"{net}.w{n_mats - 1}"])


def forward(w: dict, pts: torch.Tensor, dirs: torch.Tensor, extent: torch.Tensor, cfg: dict,
            q: Precision, c):
    """(rgb logits [R, S, 3], f [R, S], n [R, S, 3], inv_s []) of one
    object's field at warped points `pts` [R, S, 3] on rays of unit
    directions `dirs` [R, 3] in the object frame, the box's `extent` [3]."""
    net = cfg["network"]
    r, s = pts.shape[:2]
    p = pts.reshape(-1, 3).detach().requires_grad_(True)
    h = encodings.encode(w, p, cfg["encoding"], q, c)
    geo = _chain(w, "sdf", h, net["n_hidden_layers"] + 1, q)
    f = geo[:, 0]
    (grad,) = torch.autograd.grad(f.sum(), p, create_graph=True)
    normal = grad / extent
    sh = sh4(dirs)[:, None, :].expand(r, s, SH_DIMS).reshape(-1, SH_DIMS)
    x = torch.cat([q(p.detach()), q(normal), q(sh), q(geo[:, 1:])], dim=-1)
    rgb = _chain(w, "rgb", x, net["rgb_n_hidden_layers"] + 1, q)
    inv_s = torch.clamp(torch.exp(10.0 * w["variance"][0]), 1e-6, 1e6)
    return rgb.reshape(r, s, 3), f.reshape(r, s), normal.reshape(r, s, 3), inv_s


def loss_of(rgb_logits, f, normal, inv_s, dirs, t, stratum, anneal, target, is_obj, bg,
            train_cfg: dict):
    """(training loss, logged loss) of one object's rays from its field's
    values (`forward`): NeuS's render with section lengths t_{i+1} - t_i,
    the last `stratum` [R], and the cosine annealed by `anneal`."""
    rgb = torch.sigmoid(rgb_logits)
    dists = torch.cat([t[:, 1:] - t[:, :-1], stratum[:, None]], dim=1)
    true_cos = (dirs[:, None, :] * normal).sum(-1)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - anneal)
                 + torch.relu(-true_cos) * anneal)
    prev_cdf = torch.sigmoid((f - iter_cos * dists * 0.5) * inv_s)
    next_cdf = torch.sigmoid((f + iter_cos * dists * 0.5) * inv_s)
    alpha = ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).clip(0.0, 1.0)
    ones = torch.ones_like(alpha[:, :1])
    weights = alpha * torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-7], dim=1), dim=1)[:, :-1]
    opacity = weights.sum(1)
    obj = is_obj[:, None]

    w_cut = torch.where(obj, weights, weights.detach())
    rest = 1.0 - opacity
    rest_cut = torch.where(is_obj, rest, rest.detach())
    pred = (w_cut[..., None] * rgb).sum(1) + rest_cut[:, None] * bg
    rgb_loss = ((pred - target) ** 2).sum(-1)
    mask_loss = train_cfg["mask_lambda"] * torch.abs(opacity - is_obj.float())
    n = t.shape[0]
    eikonal = ((torch.linalg.vector_norm(normal, dim=-1) - 1.0) ** 2).mean()
    loss = (rgb_loss + mask_loss).sum() / n + train_cfg["eikonal_lambda"] * eikonal

    shown = (weights.detach()[..., None] * rgb.detach()).sum(1) + rest.detach()[:, None] * bg
    err = ((shown - target) ** 2).mean(-1)
    logged = torch.where(is_obj, err + (1.0 - opacity.detach()), err + opacity.detach()).sum() / n
    return loss, logged


def step(state: dict, frames: dict, obj: dict, draws, cfg: dict, q: Precision = FP32):
    """One train step of one object: `train.rays`, `forward`, `loss_of`,
    the gradient of every leaf, `train.adam_ema`. The last sample's section
    is the stratum width (tmax - tmin) / S, formed from the first and last
    samples and their jitter, t_k = tmin + width (k + jitter_k) (a few fp32
    roundings of t)."""
    tr = cfg["train"]
    u_xy, colors, jitter = draws
    s = tr["samples_per_ray"]
    pts, dirs, t, target, is_obj, bg, any_valid = train.rays(frames, obj, u_xy, colors, jitter, s)
    stratum = (t[:, -1] - t[:, 0]) / (s - 1 + jitter[:, -1] - jitter[:, 0])
    extent = obj["aabb_max"] - obj["aabb_min"]
    anneal = min(1.0, state["step"] / tr["cos_anneal_end"])
    c = encodings.folding(cfg["encoding"], pts.device)
    params = {k: v.detach().requires_grad_(True) for k, v in state["params"].items()}
    with torch.enable_grad():
        rgb, f, normal, inv_s = forward(params, pts, dirs, extent, cfg, q, c)
        loss, logged = loss_of(rgb, f, normal, inv_s, dirs, t, stratum, anneal, target, is_obj,
                               bg, tr)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    if not (obj["active"] and any_valid):
        return state, torch.zeros(()), grads
    new, seen = train.adam_ema(state, grads, cfg["optimizer"])
    return new, logged.detach(), seen
