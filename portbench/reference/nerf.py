"""Plain reference of one batched train step of RO-MAP's object NeRFs, in
PyTorch, float32, one object at a time. It imports nothing of the program
under test: every size comes from the configuration file under
`portbench/configs/`, every input (frames, object table, weights, random
draws) from the benchmark.

One step of one object, as the reference system defines it (RO-MAP,
`Core/src/nerf_model.cu`; the port's docstrings cite the lines):

  rays      R rays drawn uniformly inside the object's 2D boxes, round robin
            over its boxes; pixels of another instance occlude and drop the
            ray, as does a miss of the object's box; survivors are compacted
            in a stable order and rolled over modulo their count; S stratified
            samples per ray, warped into the unit cube of the box
  encode    MX-grid: CP lines folded through the finest level's tent basis,
            multiplied over x, y, z, plus plane x line pairs; or the
            tiny-cuda-nn hash grid (16 levels x 2 features, trilinear)
  MLP       bias-free, relu hidden layers, fp32 output (rgb logits, log sigma)
  render    emission-absorption with exp(clamp(., -15, 15)) densities
  loss      RGB over a random background (density path cut on background
            rays), 0.5 |opacity - is_object|, 0.01 sum sigma on background;
            the logged loss is the console loss
  optimizer zero NaNs, L2 1e-6, Adam(.9, .99, 1e-15), exponential decay of
            the rate, EMA .95; a slot that is inactive or drew no valid ray
            keeps everything

`Precision` rounds the weights at use, the encode's output and the hidden
activations through a narrower type, and their gradients on the way back:
the control of the comparison.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


# --------------------------------------------------------------------------
# Precision of the forward values
# --------------------------------------------------------------------------


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x through `dtype` and back to fp32; an 8-bit float is scaled per
    tensor to its largest value first."""
    scale = 1.0
    if torch.finfo(dtype).bits == 8:
        scale = torch.finfo(dtype).max / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(F32) / scale


class _Rounded(torch.autograd.Function):
    """A value rounded forward, and its gradient rounded backward."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return _round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype), None


class Precision:
    """None: fp32. Otherwise a torch dtype that every weight at use, the
    encode's output and each hidden activation is rounded to, and each of
    their gradients on the way back (sums stay fp32, as tensor cores keep
    them): the forward and backward of a path that computes in `dtype`."""

    def __init__(self, dtype=None):
        self.dtype = dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return x
        return _Rounded.apply(x, self.dtype)


FP32 = Precision()


# --------------------------------------------------------------------------
# Sizes from the configuration file
# --------------------------------------------------------------------------


def mx_sizes(enc: dict) -> dict:
    """The MX-grid ladder: per-level resolutions (geometric from
    base_resolution to mx_max_resolution), their row offsets, the plane
    levels (ru, rv, k) and the plane pairs' (u, v, line) axes."""
    n, base, top = enc["mx_levels"], enc["base_resolution"], enc["mx_max_resolution"]
    b = (top / base) ** (1.0 / (n - 1)) if n > 1 else 1.0
    res = [int(round(base * b**l)) for l in range(n)]
    offsets = [sum(res[:l]) for l in range(n)]
    pr = enc["mx_plane_res"]
    ru, rv = (pr, pr) if isinstance(pr, int) else pr
    planes = [(ru, rv, enc["mx_plane_features"])] if enc["mx_plane_features"] > 0 else []
    if enc.get("mx_plane_specs") is not None:
        planes = [tuple(p) if len(p) == 3 else (p[0], p[0], p[1]) for p in enc["mx_plane_specs"]]
    axes = {"uuv": [(0, 1, 2), (0, 2, 1), (1, 2, 0)],
            "balanced": [(0, 1, 2), (2, 0, 1), (1, 2, 0)]}[enc["mx_plane_axes"]]
    return dict(res=res, offsets=offsets, total=sum(res), features=enc["mx_features"],
                planes=planes, axes=axes, snap=enc["mx_snap_levels"])


def hash_sizes(enc: dict) -> dict:
    """tiny-cuda-nn's HashGrid: scale_l = 2^(l log2 b) N_min - 1 with b from
    the desired resolution 2048; resolution ceil(scale) + 1; a level holds
    min(2^log2_T, res^3) rows rounded up to 8, dense where res^3 fits."""
    n, base = enc["n_levels"], enc["base_resolution"]
    b = math.exp(math.log(enc["desired_resolution"] / base) / (n - 1)) if n > 1 else 1.0
    t = 1 << enc["log2_hashmap_size"]
    levels, off = [], 0
    for l in range(n):
        scale = 2.0 ** (l * math.log2(b)) * base - 1.0
        res = int(math.ceil(scale)) + 1
        size = -(-min(t, res**3 if res < 2048 else t + 1) // 8) * 8
        levels.append(dict(scale=scale, res=res, size=size, offset=off, dense=res**3 <= size))
        off += size
    return dict(levels=levels, total=off, features=enc["n_features_per_level"])


def out_dims(cfg: dict) -> int:
    enc = cfg["encoding"]
    if enc["kind"] == "hashgrid":
        return enc["n_levels"] * enc["n_features_per_level"]
    s = mx_sizes(enc)
    return s["features"] + 3 * sum(k for _, _, k in s["planes"])


def leaf_shapes(cfg: dict) -> dict:
    """{leaf name: shape of one object's leaf}, in a fixed order."""
    enc, net = cfg["encoding"], cfg["network"]
    shapes = {}
    if enc["kind"] == "hashgrid":
        h = hash_sizes(enc)
        shapes["table"] = (h["total"], h["features"])
    else:
        s = mx_sizes(enc)
        shapes["lines"] = (3, s["total"], s["features"])
        for i, (ru, rv, k) in enumerate(s["planes"]):
            shapes[f"planes{i}"] = (3, ru, rv, k)
            shapes[f"plane_lines{i}"] = (3, max(ru, rv), k)
    dims = [out_dims(cfg)] + [net["n_neurons"]] * net["n_hidden_layers"] + [net["output_dims"]]
    for i in range(len(dims) - 1):
        shapes[f"w{i}"] = (dims[i], dims[i + 1])
    return shapes


def init_weights(gen: torch.Generator, cfg: dict, n_objects: int) -> dict:
    """Weights of `n_objects` objects from `gen`, on its device, in a few
    large calls: MX-grid factors N(0, 0.3^2), hash table U(-1e-4, 1e-4),
    MLP He-uniform; {leaf: [O, *shape]} fp32."""
    out = {}
    for name, shape in leaf_shapes(cfg).items():
        full = (n_objects, *shape)
        if name == "table":
            u = torch.rand(full, generator=gen, device=gen.device)
            out[name] = (u * 2.0 - 1.0) * 1e-4
        elif name.startswith("w"):
            bound = (6.0 / shape[0]) ** 0.5
            u = torch.rand(full, generator=gen, device=gen.device)
            out[name] = u * (2 * bound) - bound
        else:
            out[name] = 0.3 * torch.randn(full, generator=gen, device=gen.device)
    return out


# --------------------------------------------------------------------------
# Encodes (one object, points [N, 3] in the unit cube)
# --------------------------------------------------------------------------


def _tent(x: torch.Tensor, r: int, table: torch.Tensor) -> torch.Tensor:
    """sum_i max(0, 1 - |x (r-1) - i|) table[i] over rows i: two taps."""
    pos = x * (r - 1)
    i0 = torch.clamp(torch.floor(pos), 0, r - 2).long()
    w0 = torch.clamp(1.0 - torch.abs(pos - i0), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(pos - i0 - 1), min=0.0)
    return w0[:, None] * table[i0] + w1[:, None] * table[i0 + 1]


def fold(s: dict, device) -> torch.Tensor:
    """[total, rf]: row (level l, index b) is level l's hat b sampled at the
    finest level's rf nodes (float64 arithmetic, fp32 result)."""
    rf = max(s["res"])
    c = torch.zeros((s["total"], rf), dtype=torch.float64, device=device)
    nodes = torch.arange(rf, dtype=torch.float64, device=device) / (rf - 1)
    for r, off in zip(s["res"], s["offsets"]):
        z = nodes[None, :] * (r - 1) - torch.arange(r, dtype=torch.float64, device=device)[:, None]
        c[off : off + r] = torch.clamp(1.0 - torch.abs(z), min=0.0)
    return c.to(F32)


def encode_mx(w: dict, p: torch.Tensor, s: dict, q: Precision, c: torch.Tensor | None):
    """MX-grid features [N, K + 3 sum kp]: the CP product over axes, then
    each plane level's three (plane x line) pairs."""
    lines = q(w["lines"])
    cp = None
    for d in range(3):
        if s["snap"]:
            eff = torch.einsum("rk,rf->fk", lines[d], c)
            a = _tent(p[:, d], eff.shape[0], eff)
        else:
            a = sum(_tent(p[:, d], r, lines[d, off : off + r])
                    for r, off in zip(s["res"], s["offsets"]))
        cp = a if cp is None else cp * a
    blocks = [cp]
    for lvl, (ru, rv, k) in enumerate(s["planes"]):
        planes, plines = q(w[f"planes{lvl}"]), q(w[f"plane_lines{lvl}"])
        for i, (u, v, ax) in enumerate(s["axes"]):
            # bilinear on [ru, rv]: tent over u of (tent over v of the plane)
            pu, pv = p[:, u] * (ru - 1), p[:, v] * (rv - 1)
            iu = torch.clamp(torch.floor(pu), 0, ru - 2).long()
            iv = torch.clamp(torch.floor(pv), 0, rv - 2).long()
            f_pl = 0.0
            for du in (0, 1):
                wu = torch.clamp(1.0 - torch.abs(pu - iu - du), min=0.0)
                for dv in (0, 1):
                    wv = torch.clamp(1.0 - torch.abs(pv - iv - dv), min=0.0)
                    f_pl = f_pl + (wu * wv)[:, None] * planes[i][iu + du, iv + dv]
            f_li = _tent(p[:, ax], max(ru, rv), plines[i])
            blocks.append(f_pl * f_li)
    return q(torch.cat(blocks, dim=-1))


_PY, _PZ, _M32 = 2654435761, 805459861, 0xFFFFFFFF


def _mul32(a: torch.Tensor, prime: int) -> torch.Tensor:
    """(a * prime) mod 2^32 in int64 without overflow: 16-bit halves of the prime."""
    return ((a * (prime >> 16)) % 65536 * 65536 + a * (prime & 0xFFFF)) % (1 << 32)


def encode_hash(w: dict, p: torch.Tensor, h: dict, q: Precision):
    """Hash-grid features [N, L F], level-major."""
    table = q(w["table"])
    outs = []
    for lv in h["levels"]:
        pos = p * lv["scale"] + 0.5
        cell = torch.floor(pos)
        frac = pos - cell
        ci = cell.long()
        feat = 0.0
        for corner in range(8):
            bit = [(corner >> d) & 1 for d in range(3)]
            c = [(ci[:, d] + bit[d]) & _M32 for d in range(3)]
            if lv["dense"]:
                idx = (c[0] + c[1] * lv["res"] + c[2] * lv["res"] ** 2) & _M32
            else:
                idx = c[0] ^ _mul32(c[1], _PY) ^ _mul32(c[2], _PZ)
            row = idx % lv["size"] + lv["offset"]
            wt = 1.0
            for d in range(3):
                wt = wt * (frac[:, d] if bit[d] else 1.0 - frac[:, d])
            feat = feat + wt[:, None] * table[row]
        outs.append(feat)
    return q(torch.cat(outs, dim=-1))


# --------------------------------------------------------------------------
# Rays of one object
# --------------------------------------------------------------------------


def rays(frames: dict, obj: dict, u_xy, colors, jitter, n_samples: int):
    """One object's batch. frames: pixels [F, H, W, 3] u8, instance
    [F, H, W] u8, poses [F, 4, 4], intrinsics [4]. obj: aabb_min/max [3],
    tow [4, 4], instance_id, bboxes [B, 5] (frame, x, y, h, w), n_bbox.
    Draws: u_xy [R, 2], colors [R, 3], jitter [R, S]. Returns points
    [R, S, 3], t [R, S], rgb target [R, 3], is_object [R], background
    colours [R, 3], and whether any ray survived."""
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
    return pts, t, target, is_obj, bg, n_valid > 0


# --------------------------------------------------------------------------
# Render, loss, step
# --------------------------------------------------------------------------


def loss_of(raw, t, target, is_obj, bg, train: dict):
    """(training loss, logged loss) of one object's rays."""
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


def forward(w: dict, pts: torch.Tensor, cfg: dict, q: Precision, c):
    """Raw outputs [R, S, 4] of one object's field at `pts` [R, S, 3]."""
    enc = cfg["encoding"]
    p = pts.reshape(-1, 3)
    if enc["kind"] == "hashgrid":
        h = encode_hash(w, p, hash_sizes(enc), q)
    else:
        h = encode_mx(w, p, mx_sizes(enc), q, c)
    n_mats = cfg["network"]["n_hidden_layers"] + 1
    for i in range(n_mats - 1):
        h = q(torch.relu(h @ q(w[f"w{i}"])))
    raw = h @ q(w[f"w{n_mats - 1}"])
    return raw.reshape(*pts.shape[:-1], raw.shape[-1])


def step(state: dict, frames: dict, obj: dict, draws, cfg: dict, q: Precision = FP32):
    """One train step of one object. state: {"params", "ema", "mu", "nu":
    {leaf: tensor}, "count", "step"}; returns (new state, logged loss,
    gradient as the optimizer gets it {leaf: tensor}). The EMA blends the
    new parameters in: ema <- decay ema + (1 - decay) params."""
    train, opt = cfg["train"], cfg["optimizer"]
    u_xy, colors, jitter = draws
    pts, t, target, is_obj, bg, any_valid = rays(frames, obj, u_xy, colors, jitter,
                                                 train["samples_per_ray"])
    enc = cfg["encoding"]
    c = None
    if enc["kind"] == "mxgrid" and enc["mx_snap_levels"]:
        c = fold(mx_sizes(enc), pts.device)
    params = {k: v.detach().requires_grad_(True) for k, v in state["params"].items()}
    with torch.enable_grad():
        raw = forward(params, pts, cfg, q, c)
        loss, logged = loss_of(raw, t, target, is_obj, bg, train)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    if not (obj["active"] and any_valid):
        return state, torch.zeros(()), grads
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
    return new, logged.detach(), seen


def fresh_state(params: dict) -> dict:
    z = {k: torch.zeros_like(v) for k, v in params.items()}
    return {"params": dict(params), "ema": dict(params), "mu": z, "nu": dict(z), "count": 0,
            "step": 0}
