"""Photometric refinement of held-out view poses (counterpart of
romap_tpu/runtime/pose_refine.py).

The held-out views of an online session keep their raw tracking poses, so
their renders are compared against misaligned ground truth. Each view's
SE(3) pose is optimized by Adam on the photometric and silhouette loss
against the trained, frozen field, from several starts at once; the best
pose seen for each view wins, and it is kept only where it beats the start.

The points carry a gradient here, and so do the rays' directions, which a
view-dependent field takes. On the card `field_apply` runs the
forward kernels of the spec's path and, for the points' gradient, K0 (an
MX-grid) or H0 (a hash grid); on the CPU the plain encodes.

Differences from the reference, none of which changes a result:
- the start jitters are an argument (`noise`), drawn by the host wrapper
  from a generator seeded 17 (the reference draws from PRNGKey(17) inside
  its jit), so a test can hand both sides the same draws;
- the host wrapper refines the views it was given: the reference pads the
  view axis to 4, 8, 16, ... to limit its jit recompiles, and the padded
  views are invalid, so they change no valid view's result.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from romap_tpu_torch.models.nerf import field_apply, params_device
from romap_tpu_torch.ops.geometry import (
    camera_rays,
    ray_aabb_intersect,
    se3_exp,
    stratified_distances,
    warp_point,
)
from romap_tpu_torch.ops.mlp import nerfacto, signed_distance
from romap_tpu_torch.ops.render import volume_render

N_PIXELS = 1536  # sampled pixels per view (2/3 object, 1/3 background)
N_STEPS = 300  # real-session traces still descend at 150 (scripts/debug_refine.py)
N_STARTS = 4  # multi-start basins per view (start 0 = identity)
N_SAMPLES = 32  # samples per ray (pose only needs coarse geometry)
LR = 3e-3
MASK_LAMBDA = 0.5
JITTER_SEED = 17


def _pad_views(n: int) -> int:
    """Pad the view axis to limit jit recompiles (4, 8, 16, ...)."""
    v = 4
    while v < n:
        v *= 2
    return v


def build_refine_batch(boxes, crops, n_px: int = N_PIXELS, seed: int = 0):
    """Select supervision pixels from per-view bbox crops (a copy of the
    reference's numpy function).

    Args:
      boxes: [(x, y, h, w)] per view (absolute image coords).
      crops: [(rgb u8 [h,w,3], mask u8 [h,w])] per view, bbox-sized.
      n_px: pixels per view (static).

    Returns dict of numpy arrays (xy [V,R,2] absolute pixel coords,
    rgb [V,R,3] in [0,1], w_rgb [V,R], mask [V,R], view_valid [V]) with
    V padded; or None if no view has enough object pixels.
    """
    v_pad = _pad_views(len(boxes))
    xy = np.zeros((v_pad, n_px, 2), np.float32)
    rgb = np.zeros((v_pad, n_px, 3), np.float32)
    w_rgb = np.zeros((v_pad, n_px), np.float32)
    mask_t = np.zeros((v_pad, n_px), np.float32)
    valid = np.zeros((v_pad,), bool)
    rng = np.random.default_rng(seed)
    n_obj_px = (2 * n_px) // 3
    for i, ((x0, y0, h, w), (crgb, cmask)) in enumerate(zip(boxes, crops)):
        m = np.asarray(cmask) > 0
        oy, ox = np.nonzero(m)
        by, bx = np.nonzero(~m)
        if len(oy) < 32:
            continue  # too little object evidence to anchor the pose
        take_o = rng.choice(len(oy), n_obj_px, replace=len(oy) < n_obj_px)
        n_bg = n_px - n_obj_px
        if len(by) > 0:
            take_b = rng.choice(len(by), n_bg, replace=len(by) < n_bg)
            ys = np.concatenate([oy[take_o], by[take_b]])
            xs = np.concatenate([ox[take_o], bx[take_b]])
            is_obj = np.concatenate([np.ones(n_obj_px), np.zeros(n_bg)])
        else:
            take_o2 = rng.choice(len(oy), n_px, replace=True)
            ys, xs = oy[take_o2], ox[take_o2]
            is_obj = np.ones(n_px)
        xy[i, :, 0] = xs + x0
        xy[i, :, 1] = ys + y0
        rgb[i] = np.asarray(crgb, np.float32)[ys, xs] / 255.0
        w_rgb[i] = is_obj  # photometric term only where GT shows the object
        mask_t[i] = is_obj  # silhouette target on every sampled pixel
        valid[i] = True
    if not valid.any():
        return None
    return dict(xy=xy, rgb=rgb, w_rgb=w_rgb, mask=mask_t, valid=valid)


def make_view_loss(params_one, intrinsics, twc0, tow, aabb_min, aabb_max, xy, rgb_t, w_rgb,
                   mask_t, view_valid, cfg, spec, n_starts: int, n_samples: int = N_SAMPLES):
    """The loss of every start of every view as a function of the SE(3)
    deltas [V*S, 6] (view-major), against the frozen field: `view_loss`
    returns the per-start losses [V*S] and the leaf they were taken from.
    Every evaluation takes the points' gradient path, so the losses
    compared by `refine_poses` all come from the same encode. Arguments as
    `refine_poses` takes them; S = n_starts. An SDF field raises: its
    normal's gradient in the pose would take the distance's second
    derivative in the points, which is not ported. nerfacto's field raises
    too: its samples come from its proposal fields, and this loss samples
    the stratified way."""
    if signed_distance(cfg.network):
        raise NotImplementedError("pose refinement of an SDF field is not ported (it needs "
                                  "the distance's Hessian in the points)")
    if nerfacto(cfg.network):
        raise NotImplementedError("pose refinement of a nerfacto field is not ported (its "
                                  "samples come from its proposal fields)")
    params_one = pytree.tree_map(lambda a: a.detach(), params_one)
    one = pytree.tree_map(lambda a: a[None], params_one)
    dev = twc0.device
    bg = torch.full((3,), 1.0, dtype=torch.float32, device=dev)  # gray background
    ex = lambda a: torch.repeat_interleave(a, n_starts, dim=0)  # [V*S, ...], view-major
    twc0_e, xy_e = ex(twc0), ex(xy)
    rgb_e, w_e, mask_e, valid_e = ex(rgb_t), ex(w_rgb), ex(mask_t), ex(view_valid)

    def view_loss(delta):
        delta = delta.detach().requires_grad_(True)
        with torch.enable_grad():
            twc = twc0_e @ se3_exp(delta)  # [V*S, 4, 4]
            o, d, _ = camera_rays(xy_e[..., 0], xy_e[..., 1], intrinsics, twc[:, None], tow)
            tmin, tmax, hit = ray_aabb_intersect(o, d, aabb_min, aabb_max)
            # MISS rays get a tiny finite segment: +-inf distances would turn
            # into NaN that survives the where(hit, ...) backward (0 * NaN)
            tmin = torch.where(hit, torch.clamp(tmin, min=0.0), torch.zeros_like(tmin))
            tmax = torch.where(hit, tmax, torch.full_like(tmax, 1e-3))
            t = stratified_distances(tmin, tmax, torch.full_like(tmin[..., None], 0.5),
                                     n_samples)
            pts = warp_point(o[..., None, :] + t[..., None] * d[..., None, :],
                             aabb_min, aabb_max)
            raw = field_apply(one, pts[None], d[None], cfg, spec, dtype=torch.float32)[0]
            out = volume_render(raw, t, bg)
            opacity = torch.where(hit, out.mask, torch.zeros_like(out.mask))
            rgb_pred = torch.where(hit[..., None], out.rgb, bg)
            # photometric term on GT-object pixels; silhouette term everywhere
            rgb_err = torch.sum((rgb_pred - rgb_e) ** 2, dim=-1)
            per_view = (torch.sum(w_e * rgb_err, dim=-1)
                        / torch.clamp(torch.sum(w_e, dim=-1), min=1.0)
                        + MASK_LAMBDA * torch.mean(torch.abs(opacity - mask_e), dim=-1))
            per_view = torch.where(valid_e, per_view, torch.zeros_like(per_view))
        return per_view, delta

    return view_loss


def refine_poses(params_one, intrinsics, twc0, tow, aabb_min, aabb_max, xy, rgb_t, w_rgb,
                 mask_t, view_valid, cfg, spec, noise, n_steps: int = N_STEPS,
                 n_samples: int = N_SAMPLES, lr: float = LR):
    """Batched pose-only Adam against the frozen field.

    Each view optimizes from S starts (S = noise.shape[1]): the zero delta
    and S - 1 SE(3) jitters, noise [V, S, 6] (unit normal draws) scaled to
    ~1.7 degrees of rotation and 3 % of the box's mean side of translation.
    The per-view argmin over starts and steps wins.

    Args: tensors on one device; twc0 [V, 4, 4] initial camera-to-world
    poses, tow [4, 4], xy [V, R, 2], rgb_t [V, R, 3], w_rgb, mask_t [V, R],
    view_valid [V] bool.
    Returns (twc_refined [V, 4, 4], loss0 [V], loss_final [V]).
    """
    dev = twc0.device
    n_views, s = noise.shape[:2]
    view_loss = make_view_loss(params_one, intrinsics, twc0, tow, aabb_min, aabb_max, xy,
                               rgb_t, w_rgb, mask_t, view_valid, cfg, spec, s, n_samples)

    box_scale = torch.mean(aabb_max - aabb_min)
    scale = torch.cat([torch.full((3,), 0.03, device=dev),
                       torch.full((3,), 1.0, device=dev) * 0.03 * box_scale])
    d0 = noise.to(dev, torch.float32) * scale
    d0[:, 0, :] = 0.0  # start 0 = identity
    delta0 = d0.reshape(n_views * s, 6)
    pv_init = view_loss(delta0)[0].detach()
    loss0 = pv_init.reshape(n_views, s)[:, 0]  # identity-start loss

    delta, m, v = delta0, torch.zeros_like(delta0), torch.zeros_like(delta0)
    best_delta, best_pv = delta0, pv_init
    for i in range(n_steps):
        # best-so-far per view: Adam can overshoot near a shallow optimum,
        # and final-step acceptance would discard the good intermediate pose
        pv, leaf = view_loss(delta)
        (g,) = torch.autograd.grad(pv.sum(), leaf)
        pv = pv.detach()
        improved = pv < best_pv
        best_delta = torch.where(improved[:, None], delta, best_delta)
        best_pv = torch.minimum(pv, best_pv)
        # Adam (views independent: the summed loss has disjoint gradients)
        m = 0.9 * m + 0.1 * g
        v = 0.99 * v + 0.01 * g * g
        mh = m / (1.0 - 0.9 ** (i + 1))
        vh = v / (1.0 - 0.99 ** (i + 1))
        step_lr = lr * 0.1 ** (i / n_steps)  # one decade over the run
        delta = delta - step_lr * mh / (torch.sqrt(vh) + 1e-8)
    loss_last = view_loss(delta)[0].detach()
    use_last = loss_last < best_pv
    best_delta = torch.where(use_last[:, None], delta, best_delta)
    best_pv = torch.minimum(loss_last, best_pv)
    # per-view argmin over starts
    pv_vs = best_pv.reshape(n_views, s)
    start_ix = torch.argmin(pv_vs, dim=1)  # [V]
    loss_f = torch.gather(pv_vs, 1, start_ix[:, None])[:, 0]
    best_delta = best_delta.reshape(n_views, s, 6)[torch.arange(n_views, device=dev), start_ix]
    # keep a refined pose only where it improved on the initial one
    better = (loss_f < loss0) & view_valid
    twc = torch.where(better[:, None, None], twc0 @ se3_exp(best_delta), twc0)
    return twc, loss0, loss_f


def refine_view_poses_host(params_one, intrinsics, twcs, tow, aabb_min, aabb_max, boxes,
                           crops, cfg, spec, n_steps: int | None = None,
                           n_starts: int | None = None, noise=None):
    """Host wrapper: pixel selection, then `refine_poses` on the params'
    device. `n_steps`, `n_starts` default to N_STEPS, N_STARTS; the pixels
    a view and samples a ray are N_PIXELS and N_SAMPLES, read at the call;
    `noise` [n, n_starts, 6] defaults to unit normal draws of a CPU
    generator seeded 17.

    Args mirror render_nerfs_test; `crops` is a per-view list of
    (rgb u8 [h,w,3], mask u8 [h,w]) bbox crops of the ORIGINAL images.
    Returns (refined twcs as a list of [4,4] float32 arrays, stats dict).
    """
    n_steps = N_STEPS if n_steps is None else n_steps
    n_starts = N_STARTS if n_starts is None else n_starts
    batch = build_refine_batch(boxes, crops, N_PIXELS)
    if batch is None:
        return [np.asarray(t, np.float32) for t in twcs], {"refined": 0}
    n = len(twcs)
    if noise is None:
        noise = torch.randn((n, n_starts, 6),
                            generator=torch.Generator().manual_seed(JITTER_SEED))
    dev = params_device(params_one)
    on = lambda a: torch.tensor(np.asarray(a), device=dev)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    twc, loss0, loss_f = refine_poses(
        params_one, f32(intrinsics), f32(np.stack(twcs)), f32(tow), f32(aabb_min),
        f32(aabb_max), on(batch["xy"][:n]), on(batch["rgb"][:n]), on(batch["w_rgb"][:n]),
        on(batch["mask"][:n]), on(batch["valid"][:n]), cfg, spec, torch.as_tensor(noise),
        n_steps=n_steps, n_samples=N_SAMPLES)
    twc, loss0, loss_f = (t.cpu().numpy() for t in (twc, loss0, loss_f))
    valid = batch["valid"][:n]
    stats = {
        "refined": int(np.sum(loss_f < loss0)),
        "mean_loss_before": float(np.mean(loss0[valid])) if valid.any() else 0.0,
        "mean_loss_after": float(np.mean(np.minimum(loss_f, loss0)[valid]))
        if valid.any() else 0.0,
    }
    return [twc[i] for i in range(n)], stats
