"""Plain reference of nerfstudio's nerfacto (Tancik et al., "Nerfstudio: A
Modular Framework for Neural Radiance Field Development", SIGGRAPH 2023;
github.com/nerfstudio-project/nerfstudio, `models/nerfacto.py`,
`fields/nerfacto_field.py`, `fields/density_fields.py`,
`model_components/ray_samplers.py`, `model_components/losses.py`), in
PyTorch, float32, one object at a time (the field module contract:
`portbench/reference/__init__.py`). It imports nothing of the program
under test: every size comes from the configuration file under
`portbench/configs/`, every input (frames, object table, weights, random
draws) from the benchmark.

  rays      as `train.rays` draws them (a copy that also keeps each ray's
            origin, section [tmin, tmax] and frame), without the samples
  sampler   in the normalised distance s, t = tmin + s (tmax - tmin):
            `UniformSampler` (proposal_samples[0] bins, one jitter a ray:
            jitter column 0), proposal field 1 at the bins' midpoints,
            `PDFSampler` (proposal_samples[1] bins from field 1's weights
            raised to the anneal exponent; jitter column 1), proposal field
            2, `PDFSampler` again (samples_per_ray bins; jitter column 2);
            the bins detached
  proposal  `HashMLPDensityField`: the configuration's proposal hash grid
            (`encodings`), a bias-free relu net to 1 output, the
            log-density
  field     instant-ngp's density network (output 0 the log-density,
            outputs 1 on the geometry features), the colour network on
            [geometry features, `ngp.sh4` of the ray's direction, the
            appearance code of the ray's frame]
  weights   (1 - exp(-sigma d)) exp(-(cumsum(sigma d) - sigma d)), d the
            bin's length, sigma = exp(clamp(., +-15)), at every level
  anneal    10 x / (9 x + 1), x = min(step / 1000, 1) (NerfactoModelConfig's
            proposal_weights_anneal_slope and _max_num_iters), of the
            object's own step count
  loss      the system's composite (RGB over a random background with the
            density path cut on background rays, 0.5 |opacity - is_object|,
            0.01 sum sigma on background) over the field's bins, plus
            `interlevel_loss` and `distortion_loss` at their weights; the
            logged loss is the system's console loss
  optimizer `train.adam_ema`

`Precision` rounds the weights at use (tables and codes included), each
encode's output, the hidden activations and each network's input, and
their gradients on the way back; each network's last product, the
densities, the weights, the sampler and the losses stay fp32.
"""

from __future__ import annotations

import torch

from portbench.reference import encodings, train
from portbench.reference.ngp import SH_DIMS, sh4
from portbench.reference.precision import F32, FP32, Precision

fresh_state = train.fresh_state
ANNEAL_SLOPE, ANNEAL_STEPS = 10.0, 1000


def proposal_encoding(cfg: dict, level: int) -> dict:
    """The encoding section of proposal field `level`'s hash grid."""
    net = cfg["network"]
    return dict(kind="hashgrid", n_levels=net["proposal_levels"],
                n_features_per_level=net["proposal_features"],
                log2_hashmap_size=net["proposal_log2_hashmap_size"],
                base_resolution=net["proposal_base_resolution"],
                desired_resolution=float(net["proposal_max_resolutions"][level]))


def _widths(cfg: dict) -> tuple[list[int], list[int], list[list[int]]]:
    net = cfg["network"]
    geo = net["output_dims"]
    density = ([encodings.out_dims(cfg["encoding"])] + [net["n_neurons"]] * net["n_hidden_layers"]
               + [geo])
    rgb = ([geo - 1 + SH_DIMS + net["appearance_dims"]]
           + [net["rgb_n_neurons"]] * net["rgb_n_hidden_layers"] + [3])
    props = [[encodings.out_dims(proposal_encoding(cfg, k))]
             + [net["proposal_n_neurons"]] * net["proposal_n_hidden_layers"] + [1]
             for k in range(len(net["proposal_max_resolutions"]))]
    return density, rgb, props


def leaf_shapes(cfg: dict) -> dict:
    """{leaf name: shape of one object's leaf}, in a fixed order: the
    encoding's `table`, `density.w{i}`, `rgb.w{i}`, then each proposal
    field's `prop{k}.table` and `prop{k}.w{i}`, then `appearance`
    (frames, dims); matrices (in, out), first to last."""
    density, rgb, props = _widths(cfg)
    shapes = encodings.leaf_shapes(cfg["encoding"])
    for net, d in (("density", density), ("rgb", rgb)):
        for i, shape in enumerate(zip(d[:-1], d[1:])):
            shapes[f"{net}.w{i}"] = shape
    for k, d in enumerate(props):
        h = encodings.hash_sizes(proposal_encoding(cfg, k))
        shapes[f"prop{k}.table"] = (h["total"], h["features"])
        for i, shape in enumerate(zip(d[:-1], d[1:])):
            shapes[f"prop{k}.w{i}"] = shape
    net = cfg["network"]
    shapes["appearance"] = (net["appearance_frames"], net["appearance_dims"])
    return shapes


def init_weights(gen: torch.Generator, cfg: dict, n_objects: int) -> dict:
    """One draw a leaf in the order of `leaf_shapes`: every hash table
    U(-1e-4, 1e-4) (tiny-cuda-nn's), every matrix He-uniform over its first
    axis (`train.init_leaves`), the appearance codes N(0, 1)
    (torch.nn.Embedding's); {leaf: [O, *shape]} fp32."""
    out = {}
    for name, shape in leaf_shapes(cfg).items():
        full = (n_objects, *shape)
        if name.endswith("table"):
            u = torch.rand(full, generator=gen, device=gen.device)
            out[name] = (u * 2.0 - 1.0) * 1e-4
        elif train.is_matrix(name):
            bound = (6.0 / shape[0]) ** 0.5
            u = torch.rand(full, generator=gen, device=gen.device)
            out[name] = u * (2 * bound) - bound
        else:
            out[name] = torch.randn(full, generator=gen, device=gen.device)
    return out


# --------------------------------------------------------------------------
# Rays of one object
# --------------------------------------------------------------------------


def rays(frames: dict, obj: dict, u_xy, colors):
    """`train.rays` without its samples: (origins [R, 3], unit directions
    [R, 3], tmin [R], tmax [R], frame [R], rgb target [R, 3], is_object
    [R], background colours [R, 3], whether any ray survived), all in the
    object frame and after the compaction."""
    r = u_xy.shape[0]
    dev = u_xy.device
    ray = torch.arange(r, device=dev)
    nb = max(int(obj["n_bbox"]), 1)
    box = obj["bboxes"][ray % nb].long()
    fid = box[:, 0]
    x = box[:, 1] + (u_xy[:, 0] * box[:, 4].float()).long()
    y = box[:, 2] + (u_xy[:, 1] * box[:, 3].float()).long()
    inst = frames["instance"][fid, y, x].long()
    occluded = (inst != 0) & (inst != int(obj["instance_id"]))

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

    n_valid = int(valid.sum())
    order = torch.cat([torch.nonzero(valid).flatten(), torch.nonzero(~valid).flatten()])
    take = order[ray % max(n_valid, 1)]
    return (o[take], d[take], tmin[take], tmax[take], fid[take], target[take], is_obj[take],
            colors[take], n_valid > 0)


# --------------------------------------------------------------------------
# The sampler
# --------------------------------------------------------------------------


def uniform_edges(n: int, jitter, device) -> torch.Tensor:
    """`UniformSampler` with `single_jitter`: [R, n + 1] edges in s, each
    moved by the ray's jitter [R] between the midpoints around it; without
    jitter [n + 1] (the render's)."""
    bins = torch.linspace(0.0, 1.0, n + 1, device=device)
    if jitter is None:
        return bins
    centers = (bins[1:] + bins[:-1]) / 2.0
    upper = torch.cat([centers, bins[-1:]])
    lower = torch.cat([bins[:1], centers])
    return lower + (upper - lower) * jitter[:, None]


def pdf_edges(s, weights, n: int, jitter) -> torch.Tensor:
    """`PDFSampler` (`include_original=False`, `single_jitter`): [R, n + 1]
    edges in s drawn from the histogram of `weights` [R, B] over edges s
    [R, B + 1]; jitter [R], or None for the levels' midpoints."""
    w = weights + 0.01
    w_sum = torch.sum(w, dim=-1, keepdim=True)
    padding = torch.relu(1e-5 - w_sum)
    w = w + padding / w.shape[-1]
    w_sum = w_sum + padding
    pdf = w / w_sum
    cdf = torch.min(torch.ones_like(pdf), torch.cumsum(pdf, dim=-1))
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    num_bins = n + 1
    u = torch.linspace(0.0, 1.0 - (1.0 / num_bins), steps=num_bins, device=cdf.device)
    u = u.expand(size=(*cdf.shape[:-1], num_bins))
    if jitter is None:
        u = u + 1.0 / (2 * num_bins)
    else:
        u = u + jitter[:, None] / num_bins
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, side="right")
    below = torch.clamp(inds - 1, 0, s.shape[-1] - 1)
    above = torch.clamp(inds, 0, s.shape[-1] - 1)
    cdf_g0, bins_g0 = torch.gather(cdf, -1, below), torch.gather(s, -1, below)
    cdf_g1, bins_g1 = torch.gather(cdf, -1, above), torch.gather(s, -1, above)
    t = torch.clip(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), 0), 0, 1)
    return (bins_g0 + t * (bins_g1 - bins_g0)).detach()


def anneal(step: int) -> torch.Tensor:
    """nerfacto's `bias(train_frac, slope)` in fp32."""
    x = torch.clamp(torch.tensor(step, dtype=F32) / ANNEAL_STEPS, max=1.0)
    return ANNEAL_SLOPE * x / ((ANNEAL_SLOPE - 1) * x + 1)


def bins_in_space(s, o, d, tmin, tmax, obj):
    """(warped midpoints [R, B, 3], their distances [R, B], lengths [R, B])
    of the bins between edges s [R, B + 1]."""
    t = tmin[:, None] + s * (tmax - tmin)[:, None]
    start, end = t[:, :-1], t[:, 1:]
    mid = (start + end) / 2.0
    pts = o[:, None, :] + mid[..., None] * d[:, None, :]
    pts = (pts - obj["aabb_min"]) / (obj["aabb_max"] - obj["aabb_min"])
    return pts, mid, end - start


def weights_of(log_sigma, lengths):
    """`RaySamples.get_weights` with the system's density and an exclusive
    sum formed as cumsum - own term."""
    sd = torch.exp(torch.clamp(log_sigma, -15.0, 15.0)) * lengths
    acc = torch.cumsum(sd, dim=-1)
    return (1.0 - torch.exp(-sd)) * torch.exp(-(acc - sd))


# --------------------------------------------------------------------------
# Fields
# --------------------------------------------------------------------------


def _chain(w: dict, net: str, h: torch.Tensor, n_mats: int, q: Precision):
    for i in range(n_mats - 1):
        h = q(torch.relu(h @ q(w[f"{net}.w{i}"])))
    return h @ q(w[f"{net}.w{n_mats - 1}"])


def proposal_forward(w: dict, k: int, pts: torch.Tensor, cfg: dict, q: Precision):
    """Proposal field k's log-density [R, B] at warped points [R, B, 3]."""
    r, b = pts.shape[:2]
    enc = proposal_encoding(cfg, k)
    h = encodings.encode_hash({"table": w[f"prop{k}.table"]}, pts.reshape(-1, 3),
                              encodings.hash_sizes(enc), q)
    out = _chain(w, f"prop{k}", h, cfg["network"]["proposal_n_hidden_layers"] + 1, q)
    return out[:, 0].reshape(r, b)


def forward(w: dict, pts: torch.Tensor, dirs: torch.Tensor, frame, cfg: dict, q: Precision):
    """Raw outputs [R, S, 4] (rgb logits, log-density) of the field at
    `pts` [R, S, 3] on rays of unit directions `dirs` [R, 3] drawn from the
    frames `frame` [R] (None: the mean appearance code)."""
    net = cfg["network"]
    r, s = pts.shape[:2]
    h = encodings.encode(w, pts.reshape(-1, 3), cfg["encoding"], q, None)
    geo = _chain(w, "density", h, net["n_hidden_layers"] + 1, q)
    sh = sh4(dirs)[:, None, :].expand(r, s, SH_DIMS).reshape(-1, SH_DIMS)
    codes = q(w["appearance"])
    if frame is None:
        app = codes.mean(dim=0)[None, :].expand(r * s, -1)
    else:
        app = codes[frame % codes.shape[0]][:, None, :].expand(r, s, -1).reshape(r * s, -1)
    x = torch.cat([q(geo[:, 1:]), q(sh), app], dim=-1)
    rgb = _chain(w, "rgb", x, net["rgb_n_hidden_layers"] + 1, q)
    return torch.cat([rgb, geo[:, :1]], dim=-1).reshape(r, s, 4)


def sample(w: dict, o, d, tmin, tmax, obj, jitter, a, cfg: dict, q: Precision):
    """`ProposalNetworkSampler` over one object's rays: (edges of the
    field's bins [R, S + 1], [(edges, weights) of each proposal level])."""
    tr = cfg["train"]
    counts = (*tr["proposal_samples"], tr["samples_per_ray"])
    col = (lambda k: None) if jitter is None else (lambda k: jitter[:, k])
    s = uniform_edges(counts[0], col(0), o.device).expand(o.shape[0], -1)
    levels = []
    for k in range(len(counts) - 1):
        pts, _, lengths = bins_in_space(s, o, d, tmin, tmax, obj)
        wk = weights_of(proposal_forward(w, k, pts, cfg, q), lengths)
        levels.append((s, wk))
        s = pdf_edges(s, torch.pow(wk.detach(), a), counts[k + 1], col(k + 1))
    return s, levels


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def outer(t0_starts, t0_ends, t1_starts, t1_ends, y1):
    """nerfstudio's `outer`."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    idx_lo = torch.searchsorted(t1_starts.contiguous(), t0_starts.contiguous(), side="right") - 1
    idx_lo = torch.clamp(idx_lo, min=0, max=y1.shape[-1] - 1)
    idx_hi = torch.searchsorted(t1_ends.contiguous(), t0_ends.contiguous(), side="right")
    idx_hi = torch.clamp(idx_hi, min=0, max=y1.shape[-1] - 1)
    cy1_lo = torch.take_along_dim(cy1[..., :-1], idx_lo, dim=-1)
    cy1_hi = torch.take_along_dim(cy1[..., 1:], idx_hi, dim=-1)
    return cy1_hi - cy1_lo


def lossfun_outer(t, w, t_env, w_env):
    """nerfstudio's `lossfun_outer`."""
    w_outer = outer(t[..., :-1], t[..., 1:], t_env[..., :-1], t_env[..., 1:], w_env)
    return torch.clip(w - w_outer, min=0) ** 2 / (w + 1e-7)


def interlevel_loss(edges, weights, levels):
    """nerfstudio's `interlevel_loss`: the field's edges and weights
    detached."""
    c, w = edges.detach(), weights.detach()
    return sum(torch.mean(lossfun_outer(c, w, cp, wp)) for cp, wp in levels)


def distortion_loss(t, w):
    """nerfstudio's `distortion_loss` (`lossfun_distortion`), the mean over
    rays."""
    ut = (t[..., 1:] + t[..., :-1]) / 2
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
    loss_intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3
    return torch.mean(loss_inter + loss_intra)


def loss_of(raw, lengths, target, is_obj, bg, tr: dict):
    """(composite loss, logged loss, the field's weights) of one object's
    rays from its raw outputs [R, S, 4] over bins of `lengths` [R, S]."""
    rgb = torch.sigmoid(raw[..., :3])
    sigma = torch.exp(torch.clamp(raw[..., 3], -15.0, 15.0))
    sd = sigma * lengths
    acc = torch.cumsum(sd, dim=1)
    weights = (1.0 - torch.exp(-sd)) * torch.exp(-(acc - sd))
    t_last = torch.exp(-acc[:, -1])
    opacity = 1.0 - t_last
    obj = is_obj[:, None]

    w_cut = torch.where(obj, weights, weights.detach())
    t_cut = torch.where(is_obj, t_last, t_last.detach())
    pred = (w_cut[..., None] * rgb).sum(1) + t_cut[:, None] * bg
    rgb_loss = ((pred - target) ** 2).sum(-1)
    mask_loss = tr["mask_lambda"] * torch.abs(opacity - is_obj.float())
    reg = tr["bg_sigma_reg"] * torch.where(is_obj, torch.zeros_like(opacity), sigma.sum(-1))
    n = raw.shape[0]
    loss = (rgb_loss + mask_loss + reg).sum() / n

    shown = (weights.detach()[..., None] * rgb.detach()).sum(1) + t_last.detach()[:, None] * bg
    err = ((shown - target) ** 2).mean(-1)
    logged = torch.where(is_obj, err + (1.0 - opacity.detach()), err + opacity.detach()).sum() / n
    return loss, logged, weights


def step(state: dict, frames: dict, obj: dict, draws, cfg: dict, q: Precision = FP32):
    """One train step of one object: `rays`, `sample`, `forward` at the
    field's bins' midpoints, `loss_of` with the interlevel and distortion
    terms, the gradient of every leaf, `train.adam_ema`."""
    tr = cfg["train"]
    u_xy, colors, jitter = draws
    o, d, tmin, tmax, frame, target, is_obj, bg, any_valid = rays(frames, obj, u_xy, colors)
    a = anneal(state["step"]).to(o.device)
    params = {k: v.detach().requires_grad_(True) for k, v in state["params"].items()}
    with torch.enable_grad():
        edges, levels = sample(params, o, d, tmin, tmax, obj, jitter, a, cfg, q)
        pts, _, lengths = bins_in_space(edges, o, d, tmin, tmax, obj)
        raw = forward(params, pts, d, frame, cfg, q)
        loss, logged, weights = loss_of(raw, lengths, target, is_obj, bg, tr)
        loss = (loss + tr["interlevel_lambda"] * interlevel_loss(edges, weights, levels)
                + tr["distortion_lambda"] * distortion_loss(edges, weights))
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    if not (obj["active"] and any_valid):
        return state, torch.zeros(()), grads
    new, seen = train.adam_ema(state, grads, cfg["optimizer"])
    return new, logged.detach(), seen
