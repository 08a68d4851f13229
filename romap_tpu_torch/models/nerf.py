"""The batched multi-object NeRF: one parameter table, one train step
(counterpart of romap_tpu/models/nerf.py, train path and ray render).

Every object NeRF is one row of a parameter tree whose leaves carry a
leading object axis O. One `train_objects` step trains every slot at once:

  generate_batch   R rays x S samples per object from per-frame bboxes,
                   occlusion and AABB gates, stable compaction + rollover
                   (`draw_rays`); nerfacto's field samples its rays through
                   its two proposal fields instead (`_proposal_batch`,
                   `ops/sampler.py`)
  field_apply      MX-grid encode (kernels K0-K10 on the card) or hash grid, + MLP
                   (RO-MAP's head, instant-ngp's density and colour networks
                   over the rays' directions, or NeuS2's SDF and colour
                   networks with the SDF's normal, H0 forward and H3 backward,
                   or nerfacto's: instant-ngp's networks with a code a frame)
  composite_loss   volume render + RGB, depth, mask and background-sigma terms
                   (an SDF field: NeuS's render, and the eikonal term;
                   nerfacto's: the render over bins, and nerfstudio's
                   interlevel and distortion terms)
  optimizer        zero_nans -> L2 1e-6 -> Adam(.9, .99, 1e-15) -> exp-decay
                   rate -> EMA .95, masked per slot (kernel A1 on the card,
                   `ops/optimizer_cuda.py`)

Where JAX vmaps over objects this module writes the object axis out, and
where JAX draws from per-object keys it takes uniforms from a
`torch.Generator` (or from a replay source in the parity tests). On the
card, with tracing off, `train_objects` replays the step as a CUDA graph
(`_StepGraph`): the same kernels, without the host's launches a step.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from romap_tpu_torch.config import NerfConfig
from romap_tpu_torch.data.frame_store import FrameArrays
from romap_tpu_torch.ops import (
    cuda_lib, hashgrid, hashgrid_cuda, mxgrid, mxgrid_cuda, optimizer_cuda, sampler)
from romap_tpu_torch.ops.geometry import (
    camera_rays,
    ray_aabb_intersect,
    stratified_distances,
    warp_point,
)
from romap_tpu_torch.ops.losses import ProposalBatch, RayBatch, composite_loss
from romap_tpu_torch.ops.mlp import (
    apply_mlp,
    apply_proposal,
    apply_rgb,
    apply_sdf,
    init_mlp,
    nerfacto,
    proposal_specs,
    signed_distance,
    view_dependent,
)
from romap_tpu_torch.ops.render import (
    density_activation,
    render_composite,
    sdf_render,
    volume_render,
)
from romap_tpu_torch.ops.sh import sh_encode
from romap_tpu_torch.utils import tracing

# --------------------------------------------------------------------------
# Parameters and state
# --------------------------------------------------------------------------


def make_field_spec(cfg: NerfConfig):
    """Static encoding spec from the config: an MX-grid spec, or for
    kind="hashgrid" a hash-grid spec (its gather path; `hash_impl="sorted"`,
    a workaround for the TPU's scatter, is not ported and raises).
    MX_SNAP=1/0 in the environment overrides `mx_snap_levels`, as in the
    reference (romap_tpu/models/nerf.py:58-67)."""
    e = cfg.encoding
    if signed_distance(cfg.network) and e.kind != "hashgrid":
        raise NotImplementedError("an SDF field's normal is ported over the hash grid (H0, "
                                  "H3) only")
    if e.kind != "mxgrid":
        if e.hash_impl != "gather":
            raise NotImplementedError(
                f"hash_impl={e.hash_impl!r} is not ported (the gather path only)")
        return hashgrid.make_spec(e)
    snap_env = os.environ.get("MX_SNAP")
    return mxgrid.make_mxspec(
        n_levels=e.mx_levels, base_resolution=e.base_resolution,
        max_resolution=e.mx_max_resolution, features=e.mx_features,
        plane_specs=e.plane_specs, plane_axes=e.mx_plane_axes,
        snap_levels=e.mx_snap_levels if snap_env is None else snap_env != "0",
    )


def compute_dtype(cfg: NerfConfig, device: torch.device) -> torch.dtype:
    """The config's compute dtype; "auto" is bfloat16 on CUDA, float32 on
    the CPU (params are stored fp32 and cast at use)."""
    cd = cfg.train.compute_dtype
    if cd == "auto":
        cd = "float32" if device.type == "cpu" else "bfloat16"
    return torch.bfloat16 if cd == "bfloat16" else torch.float32


def params_device(params) -> torch.device:
    """The device of a params tree (any of its leaves)."""
    return pytree.tree_leaves(params)[0].device


# leaves under params["mlp"] that `_features` does not cast: an SDF field's
# variance (fp32) and nerfacto's proposal fields (cast where they run)
_CAST_ELSEWHERE = ("variance", "prop0", "prop1")


def _features(params, points: torch.Tensor, spec, dtype):
    """The encode of `field_apply`: features [O, N, C] of points [O, ..., 3]
    in `dtype`, the network's weights cast to it (an SDF field's variance
    stays fp32 in `params`) and the table as the encode read it."""
    table = pytree.tree_map(lambda a: a.to(dtype), params["table"])
    mlp = {k: pytree.tree_map(lambda a: a.to(dtype), v) for k, v in params["mlp"].items()
           if k not in _CAST_ELSEWHERE}
    with tracing.span("encode.fwd"):
        if isinstance(spec, hashgrid.HashGridSpec):
            feats = hashgrid_cuda.encode(table, points, spec)
        elif points.device.type == "cuda":
            feats = mxgrid_cuda.encode(table, points, spec)
        else:
            feats = mxgrid.encode(table, points, spec)
    tracing.backward_span(feats, "encode.bwd")
    return feats.reshape(points.shape[0], -1, spec.n_output_dims), mlp, table


def _ray_sh(dirs: torch.Tensor, o: int, n: int, dtype) -> torch.Tensor:
    """The 16 SH values [O, N, 16] in `dtype` of each ray's direction (dirs
    [O, ..., 3]), once a ray, broadcast over its samples."""
    with tracing.span("dir.encode"):
        sh = sh_encode(dirs.reshape(o, -1, 3).float()).to(dtype)
        return sh[:, :, None, :].expand(-1, -1, n // sh.shape[1], -1).reshape(o, n, -1)


def _view_head(mlp, feats: torch.Tensor, dirs: torch.Tensor, cfg: NerfConfig):
    """instant-ngp's two networks: the density network on the features,
    the 16 SH values of each ray's direction (once a ray, broadcast over its
    samples), the colour network on both. Returns raw [O, N, 4] in fp32:
    rgb logits, then the density network's output 0 (log-density)."""
    o, n = feats.shape[:2]
    net = cfg.network
    tracing.count("field.view_points", o * n)
    with tracing.span("mlp.density"):
        geo = apply_mlp(mlp["density"], feats, net)
    sh = _ray_sh(dirs, o, n, feats.dtype)
    with tracing.span("mlp.rgb"):
        rgb = apply_rgb(mlp["rgb"], torch.cat([geo.to(feats.dtype), sh], dim=-1), net)
    return torch.cat([rgb, geo[..., :1]], dim=-1)


def _appearance(codes: torch.Tensor, frame, o: int, n: int) -> torch.Tensor:
    """[O, N, A]: each sample's code, row (frame mod rows) of its slot's
    table codes [O, rows, A] for its ray's frame (frame [O, R], the N
    samples ray-major), or where frame is None the mean of the slot's rows
    (nerfstudio's `use_average_appearance_embedding`)."""
    if frame is None:
        return codes.mean(dim=1, keepdim=True).expand(o, n, -1)
    idx = torch.remainder(frame, codes.shape[1])
    rows = torch.gather(codes, 1, idx[..., None].expand(*idx.shape, codes.shape[2]))
    per_ray = n // idx.shape[1]
    return rows[:, :, None, :].expand(-1, -1, per_ray, -1).reshape(o, n, -1)


def _nerfacto_head(mlp, feats: torch.Tensor, dirs: torch.Tensor, frame, cfg: NerfConfig):
    """nerfacto's field on the features: the density network (output 0 the
    log-density), then the colour network on [geometry features (outputs 1
    on), the SH of each ray's direction, the appearance code of its frame
    (`_appearance`)], padded to a multiple of 8 (63 -> 64 at nerfacto's
    widths). Returns raw [O, N, 4] in fp32, as `_view_head`."""
    o, n = feats.shape[:2]
    net, dt = cfg.network, feats.dtype
    tracing.count("field.view_points", o * n)
    with tracing.span("mlp.density"):
        geo = apply_mlp(mlp["density"], feats, net)
    sh = _ray_sh(dirs, o, n, dt)
    with tracing.span("mlp.rgb"):
        parts = [geo[..., 1:].to(dt), sh, _appearance(mlp["appearance"], frame, o, n)]
        rgb, x = _aligned_input(mlp["rgb"], parts)
        rgb = apply_rgb(rgb, x, net)
    return torch.cat([rgb, geo[..., :1]], dim=-1)


def _sdf_geometry(mlp, table, feats: torch.Tensor, pts: torch.Tensor, extent, cfg: NerfConfig,
                  spec):
    """NeuS2's SDF network on the features [O, N, C] of the warped points
    pts [O, N, 3]: (outputs [O, N, output_dims] fp32, output 0 the distance
    f; the normal n = grad f [O, N, 3] fp32 in the object frame, the
    gradient in the warped point divided per axis by the box's extent [O,
    3]). The normal is H0 over df/dfeatures (`hashgrid_cuda.
    encode_points_gradient`): its backward, H3, runs under `encode.bwd`,
    the product that formed df/dfeatures under `mlp.bwd`."""
    o, n = feats.shape[:2]
    with tracing.span("mlp.sdf"):
        geo, dfdh = apply_sdf(mlp["sdf"], feats, cfg.network)
    with tracing.span("sdf.normal"):
        tracing.count("field.sdf_points", o * n)
        with tracing.span("encode.fwd"):
            grad = hashgrid_cuda.encode_points_gradient(table, pts, dfdh, spec)
        tracing.backward_span(grad, "encode.bwd")
        tracing.backward_span(dfdh, "mlp.bwd")
        normal = grad / extent[:, None, :]
    return geo, normal


def _aligned_input(net: dict, parts: list):
    """(net, x): the parts [O, N, .] concatenated, with zero columns to a
    multiple of 8, and net's first matrix with as many zero rows: the same
    product, whose operands cuBLAS then takes 16-byte aligned."""
    pad = -sum(p.shape[-1] for p in parts) % 8
    if pad:
        first = parts[0]
        parts = parts + [first.new_zeros(1, 1, 1).expand(*first.shape[:2], pad)]
        w0 = net["w0"]
        net = dict(net, w0=torch.cat([w0, w0.new_zeros(w0.shape[0], pad, w0.shape[2])], 1))
    return net, torch.cat(parts, dim=-1)


def _sdf_colour(mlp, pts, normal, sh, geo, cfg: NerfConfig) -> torch.Tensor:
    """NeuS's colour network on its `idr` inputs, in the SH's dtype: the
    warped point, the normal, the SH of the view direction and the geometry
    features (outputs 1 on). Returns rgb logits [O, N, 3] fp32.

    The inputs (37 at NeuS2's widths) are padded with zero columns to a
    multiple of 8, and the first matrix with as many zero rows: the same
    product, whose operands cuBLAS then takes 16-byte aligned (unaligned,
    its weight gradient took a 32 x 32-tile kernel that ran 3.2 ms a step
    at O=10 x 131,072; NVIDIA H100). The padding rows' gradient is dropped."""
    dt = sh.dtype
    with tracing.span("mlp.rgb"):
        rgb, x = _aligned_input(mlp["rgb"], [pts.to(dt), normal.to(dt), sh, geo[..., 1:].to(dt)])
        return apply_rgb(rgb, x, cfg.network)


def _sdf_head(params, mlp, table, feats, points, dirs, extent, anneal, cfg: NerfConfig,
              spec) -> torch.Tensor:
    """NeuS2's field at points [O, ..., 3] on rays of directions dirs: raw
    [O, N, SDF_CHANNELS] fp32 (`ops/render.py`): rgb logits, f, the normal,
    inv_s = clamp(exp(10 v), 1e-6, 1e6) of the slot's variance v and the
    cosine's anneal ratio (`anneal`, [O] or a number)."""
    o, n = feats.shape[:2]
    pts = points.reshape(o, -1, 3).float()
    geo, normal = _sdf_geometry(mlp, table, feats, pts, extent, cfg, spec)
    rgb = _sdf_colour(mlp, pts, normal, _ray_sh(dirs, o, n, feats.dtype), geo, cfg)
    inv_s = torch.clamp(torch.exp(10.0 * params["mlp"]["variance"]), 1e-6, 1e6)  # [O, 1]
    ratio = torch.as_tensor(anneal, dtype=torch.float32, device=feats.device)
    slot = torch.cat([inv_s, ratio.reshape(-1, 1).expand(o, 1)], dim=-1)
    return torch.cat([rgb, geo[..., :1], normal, slot[:, None, :].expand(o, n, 2)], dim=-1)


def field_apply(params, points: torch.Tensor, dirs: torch.Tensor | None, cfg: NerfConfig,
                spec, dtype=None, extent: torch.Tensor | None = None, anneal=1.0, frame=None):
    """points [O, ..., S, 3] in [0,1]^3 on rays of unit directions dirs
    [O, ..., 3] (object frame, before the box warp; one a ray, the samples
    axis S left out) -> raw (rgb logits, log-sigma) [O, ..., S, 4].

    RO-MAP's head takes no direction (`dirs` unused, may be None);
    instant-ngp's (`ops/mlp.view_dependent`) needs it. NeuS2's SDF field
    (`ops/mlp.signed_distance`, a hash grid) needs it and the boxes' extent
    [O, 3] (aabb_max - aabb_min), and returns raw [O, ..., S, SDF_CHANNELS]
    (`_sdf_head`), `anneal` the cosine's anneal ratio ([O] or a number; 1,
    fully annealed, where no step is at hand). nerfacto's field needs the
    directions and takes each ray's frame `frame` [O, ...] (int64) for its
    appearance code, or None for the mean code of the slot (renders and
    meshes); its proposal fields run apart (`_proposal_stages`).

    A hash-grid spec takes `hashgrid_cuda.encode` (`hashgrid.encode`) on any
    device, which picks by the points' device: the kernels H1 (forward), H2
    (the table's gradient) and H0 (the points') for a CUDA tensor, their
    plain twins for a CPU one. For an MX-grid spec the device picks the
    encode: a CUDA tensor goes through the kernels the spec selects
    (`mxgrid_cuda.encode`, K1-K10, and K0 for the points' gradient in pose
    refinement; a spec none of them covers raises), a CPU tensor through the
    plain `mxgrid.encode`. `dtype`
    overrides the compute dtype; the render, mesh and refinement paths pass
    float32. Hidden activations run in the compute dtype; each network's
    last product accumulates to fp32.
    """
    if dtype is None:
        dtype = compute_dtype(cfg, points.device)
    sdf = signed_distance(cfg.network)
    if sdf and (dirs is None or extent is None):
        raise ValueError("an SDF field needs the rays' directions and the boxes' extent")
    feats, mlp, table = _features(params, points, spec, dtype)
    with tracing.span("mlp.fwd"):
        if sdf:
            raw = _sdf_head(params, mlp, table, feats, points, dirs, extent, anneal, cfg, spec)
        elif nerfacto(cfg.network):
            if dirs is None:
                raise ValueError("nerfacto's field needs the rays' directions")
            raw = _nerfacto_head(mlp, feats, dirs, frame, cfg)
        elif view_dependent(cfg.network):
            if dirs is None:
                raise ValueError("a view-dependent field needs the rays' directions")
            raw = _view_head(mlp, feats, dirs, cfg)
        else:
            raw = apply_mlp(mlp, feats, cfg.network)
    tracing.backward_span(raw, "mlp.bwd")
    return raw.reshape(*points.shape[:-1], raw.shape[-1])


def _geometry_output(params, points: torch.Tensor, cfg: NerfConfig, spec):
    """Output 0 [O, ...] (fp32) of the first network at points [O, ..., 3],
    with no direction: the log-density (RO-MAP's head's output 3,
    `field_apply`; instant-ngp's density network alone) or an SDF field's
    distance f (its SDF network alone)."""
    if not view_dependent(cfg.network):
        return field_apply(params, points, None, cfg, spec, dtype=torch.float32)[..., 3]
    feats, mlp, _ = _features(params, points, spec, torch.float32)
    key = "sdf" if signed_distance(cfg.network) else "density"
    with tracing.span("mlp.fwd"):
        raw = apply_mlp(mlp[key], feats, cfg.network)[..., 0]
    return raw.reshape(points.shape[:-1])


class ObjectsState(NamedTuple):
    """Fixed-capacity object table (leading axis O = object slots)."""

    aabb_min: torch.Tensor  # [O, 3] object-frame bbox (already inflated)
    aabb_max: torch.Tensor  # [O, 3]
    tow: torch.Tensor  # [O, 4, 4] world -> object transforms
    instance_id: torch.Tensor  # [O] int32 instance id in the masks
    bboxes: torch.Tensor  # [O, B, 5] int32 (frame_id, x, y, h, w)
    n_bbox: torch.Tensor  # [O] int32 valid rows in bboxes
    active: torch.Tensor  # [O] bool slot in use and allowed to train

    @property
    def capacity(self) -> int:
        return self.aabb_min.shape[0]


def empty_objects(capacity: int, max_bboxes: int, device="cpu") -> ObjectsState:
    """An object table of `capacity` unused slots (romap_tpu/models/nerf.py:136-145).

    Kept for parity with the JAX API, whose manager warms its jit with it;
    the port's manager builds its table from numpy (`_objects_state`)."""
    f32 = dict(dtype=torch.float32, device=device)
    return ObjectsState(
        aabb_min=torch.zeros((capacity, 3), **f32),
        aabb_max=torch.ones((capacity, 3), **f32),
        tow=torch.eye(4, **f32).repeat(capacity, 1, 1),
        instance_id=torch.zeros(capacity, dtype=torch.int32, device=device),
        bboxes=torch.zeros((capacity, max_bboxes, 5), dtype=torch.int32, device=device),
        n_bbox=torch.zeros(capacity, dtype=torch.int32, device=device),
        active=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


class AdamState(NamedTuple):
    """The optimizer chain's state, per object (optax's zero_nans and
    scale_by_adam states; the weight-decay stage has none)."""

    found_nan: Any  # tree of [O] bool: a NaN was zeroed in that leaf
    count: torch.Tensor  # [O] int32 Adam step count
    mu: Any  # tree like params
    nu: Any  # tree like params


class TrainState(NamedTuple):
    """Per-object training state; every leaf carries a leading O axis."""

    params: Any
    ema: Any  # EMA of params, used for render
    opt: AdamState
    step: torch.Tensor  # [O] int32
    loss: torch.Tensor  # [O] float32 last logged loss


def init_train_state(generator: torch.Generator, capacity: int, cfg: NerfConfig,
                     spec, device="cpu") -> TrainState:
    """Fresh state for `capacity` slots: params {"table": MX-grid factors or
    the hash table, "mlp": {"w0", "w1"}, or {"density": {"w0", "w1"}, "rgb":
    {"w0", "w1", "w2"}} for instant-ngp's field, or {"sdf": {"w0", "w1"},
    "rgb": {...}, "variance"} for NeuS2's (`init_mlp`)} drawn from
    `generator`, EMA = params, zero Adam moments, step 0."""
    if isinstance(spec, hashgrid.HashGridSpec):
        table = hashgrid.init_table(generator, spec, capacity, device=device)
    else:
        table = mxgrid.init_mxgrid(generator, spec, capacity, device=device)
    params = {
        "table": table,
        "mlp": init_mlp(generator, spec.n_output_dims, cfg.network, capacity,
                        device=device),
    }
    zeros = lambda a: torch.zeros_like(a)
    return TrainState(
        params=params,
        ema=pytree.tree_map(torch.clone, params),
        opt=AdamState(
            found_nan=pytree.tree_map(
                lambda a: torch.zeros(capacity, dtype=torch.bool, device=device), params),
            count=torch.zeros(capacity, dtype=torch.int32, device=device),
            mu=pytree.tree_map(zeros, params),
            nu=pytree.tree_map(zeros, params),
        ),
        step=torch.zeros(capacity, dtype=torch.int32, device=device),
        loss=torch.zeros(capacity, dtype=torch.float32, device=device),
    )


def reinit_slot(state: TrainState, generator: torch.Generator, idx: int, cfg: NerfConfig,
                spec) -> TrainState:
    """A state whose row `idx` of every leaf is fresh (params drawn from
    `generator`, EMA = params, zero Adam moments, step 0, loss 0) and whose
    other rows are the old ones (romap_tpu/models/nerf.py:202-215). Used when
    an object's training volume changes. The old state's tensors are left
    as they are: every leaf is copied, then its row written."""
    device = state.step.device
    fresh = init_train_state(generator, 1, cfg, spec, device=device)

    def put(a, b):
        a = a.clone()
        a[idx] = b[0]
        return a

    return pytree.tree_map(put, state, fresh)


# --------------------------------------------------------------------------
# Batch generation (ref GenerateRays nerf_model.cu:369-446)
# --------------------------------------------------------------------------


def draw_uniforms(generator: torch.Generator, n_objects: int, cfg: NerfConfig):
    """One step's uniforms (pixel offsets [O,R,2], background colours
    [O,R,3], sample jitter [O,R,S]) from `generator`, on its device."""
    r, s = cfg.train.rays_per_batch, cfg.train.samples_per_ray
    rand = lambda *shape: torch.rand((n_objects, *shape), generator=generator,
                                     device=generator.device)
    return rand(r, 2), rand(r, 3), rand(r, s)


class Rays(NamedTuple):
    """One step's compacted rays, leading [O, R] (`draw_rays`)."""

    o: torch.Tensor  # [O, R, 3] origins in the object frame
    d: torch.Tensor  # [O, R, 3] unit directions in the object frame
    tmin: torch.Tensor  # [O, R] the section inside the box
    tmax: torch.Tensor
    rgb_target: torch.Tensor  # [O, R, 3]
    depth_target: torch.Tensor  # [O, R]
    is_object: torch.Tensor  # [O, R] bool
    bg_color: torch.Tensor  # [O, R, 3]
    valid: torch.Tensor  # [O] bool: any ray survived the gates
    frame: torch.Tensor | None  # [O, R] int64 the ray's frame (nerfacto's only)


def draw_rays(frames: FrameArrays, aabb_min, aabb_max, tow, instance_id, bboxes, n_bbox,
              cfg: NerfConfig, uniforms, *, use_depth: bool) -> Rays:
    """R rays for every object slot, as `generate_batch` draws them, before
    they are sampled.

    Rays are drawn uniformly inside the per-frame 2D bboxes, round-robin
    over the bboxes. Pixels of other objects occlude and their rays are
    dropped, as are rays missing the object's AABB. Survivors are compacted
    in a stable order and rolled over modulo their count to fill the batch.
    nerfacto's rays also carry their frame (its appearance codes)."""
    u_xy, colors, _ = uniforms
    o_n = aabb_min.shape[0]
    r = cfg.train.rays_per_batch
    dev = aabb_min.device
    i = torch.arange(r, device=dev)
    idx_box = i[None, :] % torch.clamp(n_bbox.long(), min=1)[:, None]  # [O, R]
    box = torch.gather(bboxes.long(), 1, idx_box[..., None].expand(o_n, r, 5))
    fid, bx, by = box[..., 0], box[..., 1], box[..., 2]
    bh, bw = box[..., 3].float(), box[..., 4].float()
    x = bx + (u_xy[..., 0] * bw).long()
    y = by + (u_xy[..., 1] * bh).long()

    _, h, w = frames.instance.shape
    lin = (fid * h + y) * w + x
    inst = frames.instance.reshape(-1)[lin].long()
    occluded = (inst != 0) & (inst != instance_id.long()[:, None])

    pose = frames.poses[fid]  # [O, R, 4, 4]
    o, d, d_norm = camera_rays(x, y, frames.intrinsics, pose, tow[:, None])
    tmin, tmax, hit = ray_aabb_intersect(o, d, aabb_min[:, None], aabb_max[:, None])
    tmin = torch.clamp(tmin, min=0.0)

    valid = hit & ~occluded
    is_obj = valid & (inst != 0)
    rgb_pix = frames.pixels.reshape(-1, 3)[lin].float() / 255.0
    rgb_target = torch.where(is_obj[..., None], rgb_pix, colors)
    if use_depth:
        depth_target = torch.where(is_obj, frames.depth.reshape(-1)[lin] * d_norm,
                                   torch.zeros_like(d_norm))
    else:
        depth_target = torch.zeros_like(d_norm)

    # Stable compaction (valid rays first, in ray order) from cumsum ranks,
    # then modular rollover over the valid count.
    cs_valid = torch.cumsum(valid.long(), dim=1)
    n_valid = cs_valid[:, -1]
    rank = torch.where(valid, cs_valid - 1,
                       n_valid[:, None] + torch.cumsum((~valid).long(), dim=1) - 1)
    order = torch.zeros_like(rank).scatter_(1, rank, i[None, :].expand(o_n, r))
    take = torch.gather(order, 1, i[None, :] % torch.clamp(n_valid, min=1)[:, None])

    parts = [o, d, d_norm[..., None], tmin[..., None], tmax[..., None], rgb_target,
             depth_target[..., None], is_obj[..., None].float(), colors]
    proposal = nerfacto(cfg.network)
    if proposal:
        parts.append(fid[..., None].float())  # frame ids are exact in fp32
    payload = torch.cat(parts, dim=-1)
    payload = torch.gather(payload, 1, take[..., None].expand_as(payload))
    return Rays(o=payload[..., 0:3], d=payload[..., 3:6], tmin=payload[..., 7],
                tmax=payload[..., 8], rgb_target=payload[..., 9:12],
                depth_target=payload[..., 12], is_object=payload[..., 13] > 0.5,
                bg_color=payload[..., 14:17], valid=n_valid > 0,
                frame=payload[..., 17].long() if proposal else None)


def generate_batch(frames: FrameArrays, aabb_min, aabb_max, tow, instance_id, bboxes,
                   n_bbox, cfg: NerfConfig, uniforms, *, use_depth: bool) -> RayBatch:
    """One batch of R rays x S samples for every object slot: `draw_rays`,
    then S stratified samples a ray inside its box.

    Args:
      frames: the frame store's device view.
      aabb_min, aabb_max [O, 3]; tow [O, 4, 4]; instance_id [O];
      bboxes [O, B, 5]; n_bbox [O]: the object table's columns.
      uniforms: (u_xy [O,R,2], u_color [O,R,3], u_jitter [O,R,S]) in [0,1).
    Returns:
      RayBatch with leading [O, R]; `valid` [O]; `dirs` the rays' unit
      directions in the object frame; `tmin`, `tmax` the sections sampled.
    """
    rays = draw_rays(frames, aabb_min, aabb_max, tow, instance_id, bboxes, n_bbox, cfg,
                     uniforms, use_depth=use_depth)
    t = stratified_distances(rays.tmin, rays.tmax, uniforms[2], cfg.train.samples_per_ray)
    pts = rays.o[..., None, :] + t[..., None] * rays.d[..., None, :]
    pts = warp_point(pts, aabb_min[:, None, None], aabb_max[:, None, None])
    return RayBatch(
        points=pts, t=t, rgb_target=rays.rgb_target, depth_target=rays.depth_target,
        is_object=rays.is_object, bg_color=rays.bg_color, valid=rays.valid, dirs=rays.d,
        tmin=rays.tmin, tmax=rays.tmax,
    )


# --------------------------------------------------------------------------
# nerfacto's proposal sampler (ops/sampler.py)
# --------------------------------------------------------------------------


def _proposal_log_density(prop: dict, points: torch.Tensor, spec, dtype,
                          cfg: NerfConfig) -> torch.Tensor:
    """A proposal field at warped points [O, ..., 3]: its hash grid (H1 on
    the card) and its density net, the input padded to a multiple of 8 (10
    -> 16 at nerfacto's widths), in `dtype`; the log-density [O, ...] in
    fp32. Its spans nest the step's: `proposal.fwd` holds its `encode.fwd`
    and `mlp.fwd`, and its backward opens `mlp.bwd` and `encode.bwd`."""
    o = points.shape[0]
    with tracing.span("proposal.fwd"):
        table = prop["table"].to(dtype)
        net = {k: v.to(dtype) for k, v in prop.items() if k != "table"}
        with tracing.span("encode.fwd"):
            feats = hashgrid_cuda.encode(table, points, spec)
        tracing.backward_span(feats, "encode.bwd")
        with tracing.span("mlp.fwd"):
            net, x = _aligned_input(net, [feats.reshape(o, -1, spec.n_output_dims)])
            raw = apply_proposal(net, x, cfg.network)[..., 0]
        tracing.backward_span(raw, "mlp.bwd")
    return raw.reshape(points.shape[:-1])


def _bin_points(o, d, tmin, tmax, s, box_min, box_max):
    """(warped midpoints [..., B, 3], their distances [..., B], the bins'
    lengths [..., B]) of the bins between edges s [..., B + 1] of rays o, d
    [..., 3] over their sections [tmin, tmax]; the box [..., 1, 3]."""
    t, lengths = sampler.midpoints_and_lengths(sampler.to_distance(s, tmin, tmax))
    pts = warp_point(o[..., None, :] + t[..., None] * d[..., None, :], box_min, box_max)
    return pts, t, lengths


def _proposal_stages(mlp: dict, o, d, tmin, tmax, box_min, box_max, jitter, a,
                     cfg: NerfConfig, dtype):
    """nerfacto's sampling of rays [O, R] (`ProposalNetworkSampler`): the
    first `proposal_samples` bins uniform, the first proposal field at
    their midpoints, the second count drawn from its weights raised to `a`
    ([O, 1, 1] or a number), the second field, then `samples_per_ray` bins
    drawn alike for the field. jitter [O, R, >= 3] in training (columns 0,
    1, 2: each stage's one jitter a ray), None at render time. Returns
    (points, t, lengths, edges of the field's bins, [(edges, weights) of
    each proposal level]); the weights keep their gradient, the edges have
    none. The bins, points and weights run under `batch` (the draws under
    its `sample.pdf`), the fields under `proposal.fwd`."""
    tr = cfg.train
    counts = (*tr.proposal_samples, tr.samples_per_ray)
    col = (lambda k: None) if jitter is None else (lambda k: jitter[..., k])
    with tracing.span("batch"):
        s = sampler.uniform_edges(col(0), counts[0], tmin)
        pts, t, lengths = _bin_points(o, d, tmin, tmax, s, box_min, box_max)
    levels = []
    for k, spec in enumerate(proposal_specs(cfg.network)):
        log_sigma = _proposal_log_density(mlp[f"prop{k}"], pts, spec, dtype, cfg)
        with tracing.span("batch"), tracing.span("sample.pdf"):
            w = sampler.bin_weights(log_sigma, lengths)
            levels.append((s, w))
            s = sampler.pdf_edges(s, torch.pow(w.detach(), a), col(k + 1), counts[k + 1])
            pts, t, lengths = _bin_points(o, d, tmin, tmax, s, box_min, box_max)
    return pts, t, lengths, s, levels


def _proposal_batch(params, rays: Rays, objects: ObjectsState, jitter, step,
                    cfg: NerfConfig, dtype) -> ProposalBatch:
    """The train step's batch of nerfacto's field: `_proposal_stages` over
    the step's rays, the anneal exponent of each slot's own step (on the
    card), the three jitters a ray columns 0-2 of the step's jitter. Counts
    `sampler.proposal_points` and `sampler.field_points`."""
    tr = cfg.train
    o_n, r = rays.tmin.shape
    tracing.count("sampler.proposal_points", o_n * r * sum(tr.proposal_samples))
    tracing.count("sampler.field_points", o_n * r * tr.samples_per_ray)
    a = sampler.anneal(step)[:, None, None]
    box_min, box_max = objects.aabb_min[:, None, None], objects.aabb_max[:, None, None]
    pts, t, lengths, edges, levels = _proposal_stages(
        params["mlp"], rays.o, rays.d, rays.tmin, rays.tmax, box_min, box_max, jitter, a, cfg,
        dtype)
    (e0, w0), (e1, w1) = levels
    return ProposalBatch(
        points=pts, t=t, rgb_target=rays.rgb_target, depth_target=rays.depth_target,
        is_object=rays.is_object, bg_color=rays.bg_color, valid=rays.valid, dirs=rays.d,
        tmin=rays.tmin, tmax=rays.tmax, frame=rays.frame, lengths=lengths, edges=edges,
        edges0=e0, weights0=w0, edges1=e1, weights1=w1)


# --------------------------------------------------------------------------
# Train step over the object axis
# --------------------------------------------------------------------------


# the spans of one train step, under `train.step`; `batch` opens twice, around
# the draws and around `generate_batch`
STEP_SPANS = ("batch", "encode.fwd", "mlp.fwd", "loss.fwd", "loss.bwd", "mlp.bwd",
              "encode.bwd", "optimizer.update")


def _object_train_step(state: TrainState, frames: FrameArrays, objects: ObjectsState,
                       cfg: NerfConfig, spec, uniforms, use_depth: bool,
                       out: TrainState | None = None) -> TrainState:
    """One step for every object slot. Inactive slots and empty batches keep
    their params, EMA and optimizer state bit for bit. Its spans are
    `STEP_SPANS` (nerfacto's proposal fields and draws nest them:
    `proposal.fwd`, `sample.pdf`); the backward's open in hooks
    (`tracing.backward_spans`).
    With `out` (a state like `state` that shares no memory with it) the new
    state is written into `out`'s tensors and `out` returned."""
    proposal = nerfacto(cfg.network)
    with tracing.span("batch"):
        draw = draw_rays if proposal else generate_batch
        batch = draw(frames, *objects[:6], cfg, uniforms, use_depth=use_depth)
    params = pytree.tree_map(lambda a: a.detach().requires_grad_(True), state.params)
    leaves, treedef = pytree.tree_flatten(params)
    extra = {}
    if signed_distance(cfg.network):  # NeuS's cosine anneals with the slot's own steps
        extra = dict(extent=objects.aabb_max - objects.aabb_min,
                     anneal=torch.clamp(state.step.float() / cfg.train.cos_anneal_end, max=1.0))
    with torch.enable_grad(), tracing.backward_spans():
        if proposal:  # nerfacto's anneal follows the slot's own steps too
            batch = _proposal_batch(params, batch, objects, uniforms[2], state.step, cfg,
                                    compute_dtype(cfg, batch.o.device))
            extra = dict(frame=batch.frame)
        raw = field_apply(params, batch.points, batch.dirs, cfg, spec, **extra)
        with tracing.span("loss.fwd"):
            loss, aux = composite_loss(raw, batch, cfg.train)
            # per-object losses touch disjoint parameter rows: the gradient
            # of their sum is every object's own gradient
            total = loss.sum()
        tracing.backward_span(total, "loss.bwd")
        grads = pytree.tree_unflatten(list(torch.autograd.grad(total, leaves)), treedef)

    with torch.no_grad(), tracing.span("optimizer.update"):
        ok = objects.active & batch.valid
        # A1 takes rows; an MX-grid's lines come back from the unfold's einsum transposed
        grads = pytree.tree_map(torch.Tensor.contiguous, grads)
        params, ema, opt = optimizer_cuda.update(grads, state, ok, cfg, out=out)
        into = lambda name: None if out is None else getattr(out, name)
        return TrainState(
            params=params, ema=ema, opt=opt,
            step=torch.where(ok, state.step + 1, state.step, out=into("step")),
            loss=torch.where(ok, aux["logged_loss"].detach(),
                             torch.zeros_like(state.loss), out=into("loss")),
        )


def _eager_step(state: TrainState, objects: ObjectsState, frames: FrameArrays,
                cfg: NerfConfig, spec, use_depth: bool, draw: Callable[[], tuple],
                i: int) -> TrainState:
    with tracing.span("train.step", step=i):
        with tracing.span("batch"):
            u = draw()
        state = _object_train_step(state, frames, objects, cfg, spec, u, use_depth)
    _graph_counts["train_eager_steps"] += 1
    return state


def train_objects(state: TrainState, objects: ObjectsState, frames: FrameArrays,
                  cfg: NerfConfig, spec, n_iters: int, use_depth: bool = False, *,
                  generator: torch.Generator | None = None,
                  uniforms: Callable[[], tuple] | None = None) -> TrainState:
    """Run n_iters synchronized steps over all object slots (one wave).

    Each step's uniforms come from `generator` or, when given, from the
    replay source `uniforms()` (the parity tests feed JAX's draws).

    Where the state is on a CUDA device, the draws come from `generator`
    and tracing is off, the steps replay a CUDA graph of the step
    (`_StepGraph`, one cached for the last key `_graph_key` gave); the first
    call with a new key runs its first step eagerly. Otherwise every step
    runs eagerly, its spans traced. Either path runs the same kernels in
    the same order and draws the same uniforms. The tensors given are never
    written, and a state returned is never written by a later call. A
    graph replays what it captured: code patched after a capture acts once
    the key changes.
    """
    if (generator is None) == (uniforms is None):
        raise ValueError("pass exactly one of generator= or uniforms=")
    draw = uniforms if uniforms is not None else (
        lambda: draw_uniforms(generator, objects.capacity, cfg))
    replays = captures = 0
    if (generator is not None and state.step.device.type == "cuda" and not tracing.enabled()
            and n_iters > 0):
        state, captures, replays = _graphed_steps(state, objects, frames, cfg, spec, n_iters,
                                                  use_depth, generator, draw)
    else:
        for i in range(n_iters):
            state = _eager_step(state, objects, frames, cfg, spec, use_depth, draw, i)
    tracing.count("train.graph_captures", captures)
    tracing.count("train.graph_replays", replays)
    return state


# --------------------------------------------------------------------------
# The train step as a CUDA graph
# --------------------------------------------------------------------------

# always on, read and zeroed like `cuda_lib.launch_counts()`
_graph_counts = {"train_graph_captures": 0, "train_graph_replays": 0, "train_eager_steps": 0}
_graph: _StepGraph | None = None  # the one cached graph
_graph_lock = threading.Lock()


def train_graph_counts() -> dict[str, int]:
    """{train_graph_captures: keys whose step was captured (into its two
    graphs), train_graph_replays: steps replayed, train_eager_steps: steps
    run eagerly} since the last reset."""
    return dict(_graph_counts)


def reset_train_graph_counts() -> None:
    for k in _graph_counts:
        _graph_counts[k] = 0


def _graph_key(leaves: list, tree, objects: ObjectsState, frames: FrameArrays,
               cfg: NerfConfig, spec, use_depth: bool, generator: torch.Generator) -> tuple:
    """What a graph of the step bakes in: the device, the config and spec,
    the state's tree, the shape and dtype of each of its leaves and of the
    object table's tensors (whose values are copied in at each call),
    `use_depth`, the generator, the frame arrays' addresses and layouts,
    and the MX-grid's kernel path (`mxgrid_cuda.kernel_path` reads MX_FUSED
    at each call). `leaves, tree` are the state's, flattened."""
    shapes = lambda ts: tuple((t.shape, t.dtype) for t in ts)
    return (leaves[0].device, cfg, spec, tree, shapes(leaves), shapes(objects), use_depth,
            id(generator), tuple((t.shape, t.dtype, t.stride(), t.data_ptr()) for t in frames),
            os.environ.get("MX_FUSED"))


_ALIGN = 256  # bytes: where each leaf of a flat state set starts


def _flat_layout(ts: list) -> tuple[list, dict]:
    """([(dtype, shape, strides, start)] of `ts` laid out contiguous in one
    buffer a dtype, each starting on an `_ALIGN`-byte boundary; {dtype:
    elements})."""
    ends, layout = {}, []
    for t in ts:
        step = _ALIGN // t.element_size()
        start = -(-ends.get(t.dtype, 0) // step) * step
        layout.append((t.dtype, t.shape, torch.empty(t.shape, device="meta").stride(), start))
        ends[t.dtype] = start + t.numel()
    return layout, ends


def _flat_views(bufs: dict, layout: list) -> list:
    return [bufs[dt].as_strided(shape, strides, start) for dt, shape, strides, start in layout]


class _StepGraph:
    """`_object_train_step`, draws included, captured into two CUDA graphs
    over two static state sets: graph i reads set i and writes set 1 - i,
    so that the steps of a call alternate between them and copy nothing.
    They share one memory pool (one replays at a time) and register the
    generator, so that replay k draws what eager step k would. A set is one
    buffer a dtype (`_flat_layout`), so that a call copies the state out in
    three copies; the state and the object table are copied in, grouped by
    dtype. The frame arrays and the generator are held, and read where they
    are."""

    def __init__(self, key: tuple, frames: FrameArrays, generator: torch.Generator):
        self.key, self.frames, self.generator = key, frames, generator
        self.graphs: list = []  # (graph, its `cuda_lib.LaunchRecord`)

    def capture(self, leaves: list, tree, objects: ObjectsState, cfg: NerfConfig, spec,
                use_depth: bool, draw: Callable[[], tuple]) -> None:
        self.tree = tree
        self.layout, sizes = _flat_layout(leaves)
        dev = leaves[0].device
        self.bufs = [{dt: torch.empty(n, dtype=dt, device=dev) for dt, n in sizes.items()}
                     for _ in range(2)]
        views = [_flat_views(b, self.layout) for b in self.bufs]
        sets = [pytree.tree_unflatten(v, tree) for v in views]
        self.objects = ObjectsState(*map(torch.empty_like, objects))
        dst = views[0] + list(self.objects)  # what a call copies in, by dtype
        self.copy_in = [([i for i, t in enumerate(dst) if t.dtype == dt],
                         [t for t in dst if t.dtype == dt]) for dt in {t.dtype for t in dst}]
        graphs, pool = [], None
        for i in range(2):
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            with (cuda_lib.recorded_launches() as rec,
                  torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local")):
                new = _object_train_step(sets[i], self.frames, self.objects, cfg, spec, draw(),
                                         use_depth, out=sets[1 - i])
                # a step that did not write `out` (a fault planted in a test)
                for a, b in zip(views[1 - i], pytree.tree_leaves(new)):
                    if a.data_ptr() != b.data_ptr():
                        a.copy_(b)
            pool = graph.pool()
            graphs.append((graph, rec))
        self.graphs = graphs

    def run(self, leaves: list, objects: ObjectsState, n_iters: int) -> TrainState:
        """n_iters steps from the state of `leaves` with `objects`: a copy
        in, the replays, a copy out into new tensors."""
        src = leaves + list(objects)
        for idx, dst in self.copy_in:
            torch._foreach_copy_(dst, [src[i] for i in idx])
        for i in range(n_iters):
            graph, rec = self.graphs[i % 2]
            graph.replay()
            rec.add()
        bufs = {dt: b.clone() for dt, b in self.bufs[n_iters % 2].items()}
        return pytree.tree_unflatten(_flat_views(bufs, self.layout), self.tree)


def _graphed_steps(state, objects, frames, cfg, spec, n_iters, use_depth, generator, draw):
    """(state after n_iters steps, captures, replays) through the cached
    graph, or a new one for a new key: its first call's first step runs
    eagerly (kernels loaded, workspaces made), then the step is captured
    (no kernel runs) and replayed."""
    global _graph
    leaves, tree = pytree.tree_flatten(state)
    key = _graph_key(leaves, tree, objects, frames, cfg, spec, use_depth, generator)
    captures = 0
    with _graph_lock:
        if _graph is None or _graph.key != key:
            _graph = None  # the old graphs, their pool and state sets go first
            state = _eager_step(state, objects, frames, cfg, spec, use_depth, draw, 0)
            leaves = pytree.tree_leaves(state)
            n_iters -= 1
            _graph = _StepGraph(key, frames, generator)
        if n_iters == 0:
            return state, 0, 0
        if not _graph.graphs:
            _graph.capture(leaves, tree, objects, cfg, spec, use_depth, draw)
            captures = 1
        state = _graph.run(leaves, objects, n_iters)
    _graph_counts["train_graph_captures"] += captures
    _graph_counts["train_graph_replays"] += n_iters
    return state, captures, n_iters


def count_wave(step_before: torch.Tensor, step_after, n_active: int, n_iters: int,
               **ids) -> None:
    """A wave's counters (tracing on), once the runner's barrier has waited
    for it: `slot_steps_issued` (slots x steps), `slot_steps_trained` (the
    rise of the state's `step` from `step_before`, the wave's first, to
    `step_after`, as the barrier read it, summed over slots) and
    `slots_active` (from the object table the host built), under `ids`. The
    card is idle here: reading `step_before` waits on nothing."""
    if not tracing.enabled():
        return
    after = torch.as_tensor(step_after).cpu().long()
    tracing.count("slot_steps_issued", after.numel() * n_iters, **ids)
    tracing.count("slot_steps_trained", int((after - step_before.cpu()).sum()), **ids)
    tracing.count("slots_active", n_active, **ids)


# --------------------------------------------------------------------------
# Inference: ray rendering (EMA params)
# --------------------------------------------------------------------------


@torch.no_grad()
def render_rays(params, o, d, d_norm, tmin, tmax, in_bbox, jitter, aabb_min,
                aabb_max, cfg: NerfConfig, spec, n_samples: int = 64,
                background: float = 1.0):
    """Render a bundle of rays for ONE object (params without the object
    axis), fp32, n_samples per ray: gray background, mask threshold 0.5,
    depth divided by d_norm. Returns (rgb [N, 3], depth [N], mask [N]). An
    SDF field renders by NeuS's rule with the cosine fully annealed.
    nerfacto's field samples through its proposal fields without jitter
    (the bins' midpoints, the weights fully annealed; `proposal_samples`,
    then `samples_per_ray` bins; `jitter` and `n_samples` unused) and
    renders with the mean of the slot's appearance codes."""
    if nerfacto(cfg.network):
        one = pytree.tree_map(lambda a: a[None], params)
        pts, t, lengths, _, _ = _proposal_stages(one["mlp"], o[None], d[None], tmin[None],
                                                 tmax[None], aabb_min, aabb_max, None, 1.0,
                                                 cfg, torch.float32)
        raw = field_apply(one, pts, d[None], cfg, spec, dtype=torch.float32)[0]
        bg = torch.full((3,), background, dtype=torch.float32, device=raw.device)
        out = volume_render(raw, t[0], bg, lengths=lengths[0])
        return render_composite(out, d_norm, in_bbox, background)
    t = stratified_distances(tmin, tmax, jitter, n_samples)
    pts = warp_point(o[:, None, :] + t[..., None] * d[:, None, :], aabb_min, aabb_max)
    one = pytree.tree_map(lambda a: a[None], params)
    sdf = signed_distance(cfg.network)
    extent = (aabb_max - aabb_min).reshape(1, 3) if sdf else None
    raw = field_apply(one, pts[None], d[None], cfg, spec, dtype=torch.float32,
                      extent=extent)[0]
    bg = torch.full((3,), background, dtype=torch.float32, device=raw.device)
    if sdf:
        out = sdf_render(raw, d, t, (tmax - tmin) / n_samples, bg)
    else:
        out = volume_render(raw, t, bg)
    return render_composite(out, d_norm, in_bbox, background)


@torch.no_grad()
def density_on_grid(params, cfg: NerfConfig, spec, res: int) -> torch.Tensor:
    """Densities [res^3] (fp32) of ONE object (params without the object
    axis) on a uniform res^3 grid over the unit cube, flat index
    x + y res + z res^2, through the clipped activation of the render path
    (romap_tpu/models/nerf.py:589-603). An SDF field gives -f, larger
    inside, whose zero level is the surface (`mc_threshold` 0)."""
    dev = params_device(params)
    lin = torch.arange(res, dtype=torch.float32, device=dev) / (res - 1)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    pts = torch.stack([x, y, z], dim=-1).reshape(1, -1, 3)
    one = pytree.tree_map(lambda a: a[None], params)
    out = _geometry_output(one, pts, cfg, spec)[0].float()
    if signed_distance(cfg.network):
        return -out
    return density_activation(out)


@torch.no_grad()
def colors_at_points(params, pts: torch.Tensor, cfg: NerfConfig, spec,
                     normals=None, extent=None) -> torch.Tensor:
    """Logistic RGB [N, 3] (fp32) of ONE object at warped points [N, 3]:
    the mesh vertex colours (romap_tpu/models/nerf.py:606-611). A
    view-dependent field is looked at head-on: each point's direction is
    its outward unit normal negated, `normals` [N, 3] (array or tensor) in
    the object frame (a zero normal leaves only the direction-free SH
    term); RO-MAP's head does not read them. An SDF field takes its own
    normal n = grad f (the box's `extent` [3] in the object frame) and the
    direction -n / |n|, and reads no `normals`."""
    one = pytree.tree_map(lambda a: a[None], params)
    if signed_distance(cfg.network):
        if extent is None:
            raise ValueError("an SDF field's colours need the box's extent")
        p = pts.float()[None]
        ext = torch.as_tensor(extent, dtype=torch.float32, device=pts.device).reshape(1, 3)
        feats, mlp, table = _features(one, p, spec, torch.float32)
        geo, normal = _sdf_geometry(mlp, table, feats, p, ext, cfg, spec)
        sh = sh_encode(-torch.nn.functional.normalize(normal, dim=-1))
        return torch.sigmoid(_sdf_colour(mlp, p, normal, sh, geo, cfg)[0])
    if not view_dependent(cfg.network):
        raw = field_apply(one, pts.float()[None], None, cfg, spec, dtype=torch.float32)[0]
    else:
        if normals is None:
            raise ValueError("a view-dependent field's colours need the points' normals")
        dirs = -torch.as_tensor(normals, dtype=torch.float32, device=pts.device)
        raw = field_apply(one, pts.float()[None, :, None], dirs[None], cfg, spec,
                          dtype=torch.float32)[0, :, 0]
    return torch.sigmoid(raw[..., :3])
