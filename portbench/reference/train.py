"""What every field's train step shares, one object at a time, as the
reference system defines it (RO-MAP, `Core/src/nerf_model.cu`; the port's
docstrings cite the lines):

  rays      R rays drawn uniformly inside the object's 2D boxes, round robin
            over its boxes; pixels of another instance occlude and drop the
            ray, as does a miss of the object's box; survivors are compacted
            in a stable order and rolled over modulo their count; S stratified
            samples per ray, warped into the unit cube of the box; each ray's
            unit direction in the object frame
  render    emission-absorption over the field's raw outputs (rgb logits,
            log sigma) with exp(clamp(., -15, 15)) densities
  loss      RGB over a random background (density path cut on background
            rays), 0.5 |opacity - is_object|, 0.01 sum sigma on background;
            the logged loss is the console loss
  optimizer zero NaNs, L2 1e-6, Adam(.9, .99, 1e-15), exponential decay of
            the rate, EMA .95; a slot that is inactive or drew no valid ray
            keeps everything

`step` runs them around a field's own `forward(w, pts, dirs, cfg, q, c)`.
"""

from __future__ import annotations

import torch

from portbench.reference import encodings
from portbench.reference.precision import F32, FP32, Precision

# --------------------------------------------------------------------------
# Weights
# --------------------------------------------------------------------------


def is_matrix(name: str) -> bool:
    """A field's matrix leaf: its last path part starts with `w`."""
    return name.rsplit(".", 1)[-1].startswith("w")


def init_leaves(gen: torch.Generator, shapes: dict, n_objects: int) -> dict:
    """Weights of `n_objects` objects from `gen`, on its device, one call a
    leaf in the order of `shapes`: the hash table U(-1e-4, 1e-4), a matrix
    (a leaf whose last path part starts with `w`) He-uniform over its first
    axis, MX-grid factors N(0, 0.3^2); {leaf: [O, *shape]} fp32."""
    out = {}
    for name, shape in shapes.items():
        full = (n_objects, *shape)
        if name == "table":
            u = torch.rand(full, generator=gen, device=gen.device)
            out[name] = (u * 2.0 - 1.0) * 1e-4
        elif is_matrix(name):
            bound = (6.0 / shape[0]) ** 0.5
            u = torch.rand(full, generator=gen, device=gen.device)
            out[name] = u * (2 * bound) - bound
        else:
            out[name] = 0.3 * torch.randn(full, generator=gen, device=gen.device)
    return out


def fresh_state(params: dict) -> dict:
    z = {k: torch.zeros_like(v) for k, v in params.items()}
    return {"params": dict(params), "ema": dict(params), "mu": z, "nu": dict(z), "count": 0,
            "step": 0}


# --------------------------------------------------------------------------
# Rays of one object
# --------------------------------------------------------------------------


def rays(frames: dict, obj: dict, u_xy, colors, jitter, n_samples: int):
    """One object's batch. frames: pixels [F, H, W, 3] u8, instance
    [F, H, W] u8, poses [F, 4, 4], intrinsics [4]. obj: aabb_min/max [3],
    tow [4, 4], instance_id, bboxes [B, 5] (frame, x, y, h, w), n_bbox.
    Draws: u_xy [R, 2], colors [R, 3], jitter [R, S]. Returns points
    [R, S, 3], unit directions in the object frame [R, 3], t [R, S], rgb
    target [R, 3], is_object [R], background colours [R, 3], and whether
    any ray survived."""
    r = u_xy.shape[0]
    dev = u_xy.device
    ray = torch.arange(r, device=dev)
    nb = max(int(obj["n_bbox"]), 1)
    box = obj["bboxes"][ray % nb].long()
    fid = box[:, 0]
    x = box[:, 1] + (u_xy[:, 0] * box[:, 4].float()).long()
    y = box[:, 2] + (u_xy[:, 1] * box[:, 3].float()).long()
    inst = frames["instance"][fid, y, x].long()
    iid = int(obj["instance_id"])
    occluded = (inst != 0) & (inst != iid)

    fx, fy, cx, cy = (frames["intrinsics"][i] for i in range(4))
    d_cam = torch.stack([(x.float() - cx) / fx, (y.float() - cy) / fy,
                         torch.ones(r, device=dev)], dim=-1)
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    pose = frames["poses"][fid]
    r_ow, t_ow = obj["tow"][:3, :3], obj["tow"][:3, 3]
    d = torch.einsum("ij,rj->ri", r_ow, torch.einsum("rij,rj->ri", pose[:, :3, :3], d_cam))
    o = torch.einsum("ij,rj->ri", r_ow, pose[:, :3, 3]) + t_ow

    safe = torch.where(torch.abs(d) < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
    ta = (obj["aabb_min"] - o) / safe
    tb = (obj["aabb_max"] - o) / safe
    tmin = torch.minimum(ta, tb).amax(-1)
    tmax = torch.maximum(ta, tb).amin(-1)
    valid = (tmin <= tmax) & ~occluded
    tmin = torch.clamp(tmin, min=0.0)
    is_obj = valid & (inst != 0)
    pix = frames["pixels"][fid, y, x].float() / 255.0
    target = torch.where(is_obj[:, None], pix, colors)

    # stable compaction: survivors in ray order, then the rest; roll over
    n_valid = int(valid.sum())
    order = torch.cat([torch.nonzero(valid).flatten(), torch.nonzero(~valid).flatten()])
    take = order[ray % max(n_valid, 1)]
    o, d, tmin, tmax = o[take], d[take], tmin[take], tmax[take]
    target, is_obj, bg = target[take], is_obj[take], colors[take]

    n = torch.arange(n_samples, device=dev, dtype=F32)
    t = tmin[:, None] + ((tmax - tmin) / float(n_samples))[:, None] * (n + jitter)
    pts = o[:, None, :] + t[..., None] * d[:, None, :]
    pts = (pts - obj["aabb_min"]) / (obj["aabb_max"] - obj["aabb_min"])
    return pts, d, t, target, is_obj, bg, n_valid > 0


# --------------------------------------------------------------------------
# Render, loss, optimizer, step
# --------------------------------------------------------------------------


def loss_of(raw, t, target, is_obj, bg, train: dict):
    """(training loss, logged loss) of one object's rays from the field's
    raw outputs [R, S, 4] (rgb logits, log sigma)."""
    rgb = torch.sigmoid(raw[..., :3])
    sigma = torch.exp(torch.clamp(raw[..., 3], -15.0, 15.0))
    dt = t - torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)
    sd = sigma * dt
    acc = torch.cumsum(sd, dim=1)
    weights = (1.0 - torch.exp(-sd)) * torch.exp(-(acc - sd))
    t_last = torch.exp(-acc[:, -1])
    opacity = 1.0 - t_last
    obj = is_obj[:, None]

    w_cut = torch.where(obj, weights, weights.detach())
    t_cut = torch.where(is_obj, t_last, t_last.detach())
    pred = (w_cut[..., None] * rgb).sum(1) + t_cut[:, None] * bg
    rgb_loss = ((pred - target) ** 2).sum(-1)
    mask_loss = train["mask_lambda"] * torch.abs(opacity - is_obj.float())
    reg = train["bg_sigma_reg"] * torch.where(is_obj, torch.zeros_like(opacity), sigma.sum(-1))
    n = t.shape[0]
    loss = (rgb_loss + mask_loss + reg).sum() / n

    shown = (weights.detach()[..., None] * rgb.detach()).sum(1) + t_last.detach()[:, None] * bg
    err = ((shown - target) ** 2).mean(-1)
    logged = torch.where(is_obj, err + (1.0 - opacity.detach()), err + opacity.detach()).sum() / n
    return loss, logged


def adam_ema(state: dict, grads: dict, opt: dict) -> tuple[dict, dict]:
    """(new state, gradient as the optimizer gets it {leaf}) after one
    update of every leaf. The EMA blends the new parameters in:
    ema <- decay ema + (1 - decay) params."""
    count = state["count"] + 1
    b1, b2 = opt["beta1"], opt["beta2"]
    n = max(0, (state["step"] - opt["decay_start"]) // opt["decay_interval"] + 1)
    lr = opt["learning_rate"] * opt["decay_base"] ** n
    decay = opt["ema_decay"]
    new = {"params": {}, "ema": {}, "mu": {}, "nu": {}, "count": count,
           "step": state["step"] + 1}
    seen = {}
    for k, p in state["params"].items():
        g = torch.nan_to_num(grads[k], nan=0.0, posinf=float("inf"), neginf=float("-inf"))
        g = g + opt["l2_reg"] * p
        seen[k] = g
        mu = b1 * state["mu"][k] + (1 - b1) * g
        nu = b2 * state["nu"][k] + (1 - b2) * g * g
        up = (mu / (1 - b1**count)) / (torch.sqrt(nu / (1 - b2**count)) + opt["epsilon"])
        new["params"][k] = p - lr * up
        new["ema"][k] = decay * state["ema"][k] + (1 - decay) * new["params"][k]
        new["mu"][k], new["nu"][k] = mu, nu
    return new, seen


def step(forward, state: dict, frames: dict, obj: dict, draws, cfg: dict,
         q: Precision = FP32):
    """One train step of one object through the field `forward(w, pts,
    dirs, cfg, q, c)`, which returns raw outputs [R, S, 4] of points
    [R, S, 3] on rays of unit directions [R, 3] (`c`: the encoding's
    `folding`). state: {"params", "ema", "mu", "nu": {leaf: tensor},
    "count", "step"}; returns (new state, logged loss, gradient as the
    optimizer gets it {leaf: tensor})."""
    train = cfg["train"]
    u_xy, colors, jitter = draws
    pts, dirs, t, target, is_obj, bg, any_valid = rays(frames, obj, u_xy, colors, jitter,
                                                       train["samples_per_ray"])
    c = encodings.folding(cfg["encoding"], pts.device)
    params = {k: v.detach().requires_grad_(True) for k, v in state["params"].items()}
    with torch.enable_grad():
        raw = forward(params, pts, dirs, cfg, q, c)
        loss, logged = loss_of(raw, t, target, is_obj, bg, train)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    if not (obj["active"] and any_valid):
        return state, torch.zeros(()), grads
    new, seen = adam_ema(state, grads, cfg["optimizer"])
    return new, logged.detach(), seen
