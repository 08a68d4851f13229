"""Hash-grid encode on the card: kernels H0-H3 (csrc/hashgrid.cu).

  H1 `forward`          points, table -> features [O, N, L F] in the table's
                        dtype (fp32 blend, one rounding at the store)
  H2 `table_gradient`   points, cotangent -> the table's gradient, summed in
                        fp32 with atomics, then cast once to the table's dtype
  H0 `points_gradient`  points, table, cotangent -> the points' gradient
                        [O, N, 3] fp32 (pose refinement; an SDF field's normal)
  H3 `normal_backward`  points, table, H0's cotangent g, the cotangent v of
                        H0's output -> (g's gradient, the table's): H0's
                        backward, for the loss terms of an SDF field's normal

`encode` is one autograd node over H1, H2 and H0 (`hashgrid.encode` calls
it): the forward keeps the points only (and the table where the points need
a gradient), and the backward recomputes the corners' rows and weights.
`encode_points_gradient` is one over H0 and H3: the normal of NeuS2's field,
differentiable in the table and in g (the network's gradient in the
features), not in the points. Both backwards are once differentiable: a
graph built through them (`create_graph`) raises where it is differentiated,
as no kernel computes their own derivatives.

Every kernel has a plain PyTorch twin of the same signature in this module
(`forward_plain`, ...), built on `hashgrid.corner_rows`. A wrapper picks by
device alone: a CPU tensor goes to the twin, a CUDA tensor launches the
kernel or raises (wrong device, dtype, shape or contiguity; a table or
cotangent not aligned to a row of F values, which the kernels move as one
access; a spec of more than `MAX_LEVELS` levels or of a feature count not in
`FEATURES`). No failure of the build or of a launch is caught. This module
declares hashgrid.cu's C entries (`ARGTYPES`); `cuda_lib` builds, loads,
launches and counts them (`launch_counts()`: H0-H3 after K0-K10).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from romap_tpu_torch.ops import cuda_lib, hashgrid
from romap_tpu_torch.ops.hashgrid import HashGridSpec

MAX_LEVELS = 32  # kMaxHashLevels of csrc/hashgrid.cu
FEATURES = (1, 2, 4, 8)  # features a level: tiny-cuda-nn's HashGrid takes these

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
_floats, _ints = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
# the C entries of csrc/hashgrid.cu: H1, H2, H0, H3 (dtype code first, stream last)
ARGTYPES = {
    "romap_hash_fwd": [_i32] + [_ptr] * 3 + [_floats, _ints] + [_i32] * 5 + [_ptr],
    "romap_hash_bwd": [_i32] + [_ptr] * 3 + [_floats, _ints] + [_i32] * 5 + [_ptr],
    "romap_hash_points_grad": [_i32] + [_ptr] * 4 + [_floats, _ints] + [_i32] * 5 + [_ptr],
    "romap_hash_normal_bwd": [_i32] + [_ptr] * 6 + [_floats, _ints] + [_i32] * 5 + [_ptr],
}
cuda_lib.declare(ARGTYPES)

LevelConstants = collections.namedtuple(
    "LevelConstants", ["scales", "resolutions", "sizes", "offsets", "dense"])


@functools.cache
def level_constants(spec: HashGridSpec) -> LevelConstants:
    """The per-level constants the kernels take: scales rounded to fp32 (as
    the twin multiplies by them), resolutions, sizes, row offsets and
    whether the level is dense (res^3 <= size: no hash)."""
    return LevelConstants(
        scales=tuple(float(np.float32(s)) for s in spec.scales),
        resolutions=tuple(spec.resolutions), sizes=tuple(spec.sizes),
        offsets=tuple(spec.offsets),
        dense=tuple(r**3 <= s for r, s in zip(spec.resolutions, spec.sizes)))


@functools.cache
def _level_args(spec: HashGridSpec) -> tuple:
    """(scales, ints, L, F) as the C entry points take them: host arrays
    of L floats and of 4 L ints (resolutions, sizes, offsets, dense)."""
    lc = level_constants(spec)
    n = spec.n_levels
    if n > MAX_LEVELS:
        raise NotImplementedError(f"the hash-grid kernels take at most {MAX_LEVELS} levels; "
                                  f"this spec has {n}")
    if spec.n_features not in FEATURES:
        raise NotImplementedError(f"the hash-grid kernels take {FEATURES} features a level; "
                                  f"this spec has {spec.n_features}")
    ints = (*lc.resolutions, *lc.sizes, *lc.offsets, *map(int, lc.dense))
    return (ctypes.c_float * n)(*lc.scales), (ctypes.c_int * (4 * n))(*ints), n, \
        spec.n_features


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The twins' sum dtype: fp32, or the table's where it is wider."""
    return torch.promote_types(dt, torch.float32)


def _object_rows(rows: torch.Tensor, o: int, spec: HashGridSpec) -> torch.Tensor:
    """Rows [O N, L, 8] of each object's table -> flat rows [O N L 8] of the
    [O T, F] view of all objects' tables."""
    return (rows.reshape(o, -1) + (torch.arange(o, device=rows.device)
                                   * spec.total_params)[:, None]).reshape(-1)


def _gather(table: torch.Tensor, rows: torch.Tensor, o: int, n: int,
            spec: HashGridSpec) -> torch.Tensor:
    """The corner rows [O, N, L, 8, F] of rows [O N, L, 8]."""
    flat = table.reshape(o * spec.total_params, spec.n_features)
    return flat.index_select(0, _object_rows(rows, o, spec)).reshape(
        o, n, spec.n_levels, 8, spec.n_features)


# --------------------------------------------------------------------------
# The plain twins
# --------------------------------------------------------------------------


def forward_plain(points, table, spec: HashGridSpec) -> torch.Tensor:
    """H1's twin: points [O, N, 3] f32, table [O, T, F] -> [O, N, L F]."""
    o, n = points.shape[:2]
    rows, cw = hashgrid.corner_rows(points.reshape(-1, 3), spec)
    acc = _acc_dtype(table.dtype)
    feats = _gather(table, rows, o, n, spec).to(acc)
    w = hashgrid.trilinear(cw).reshape(o, n, spec.n_levels, 8, 1).to(acc)
    return torch.sum(feats * w, dim=3).reshape(o, n, -1).to(table.dtype)


def table_gradient_plain(points, g, spec: HashGridSpec) -> torch.Tensor:
    """H2's twin: the table's gradient [O, T, F] in g's dtype from the
    cotangent g [O, N, L F], summed in fp32 (`index_add_`), cast once."""
    o, n = points.shape[:2]
    rows, cw = hashgrid.corner_rows(points.reshape(-1, 3), spec)
    acc = _acc_dtype(g.dtype)
    f = spec.n_features
    w = hashgrid.trilinear(cw).reshape(o, n, spec.n_levels, 8, 1).to(acc)
    terms = g.reshape(o, n, spec.n_levels, 1, f).to(acc) * w
    buf = torch.zeros((o * spec.total_params, f), dtype=acc, device=g.device)
    buf.index_add_(0, _object_rows(rows, o, spec), terms.reshape(-1, f))
    return buf.reshape(o, spec.total_params, f).to(g.dtype)


def _weight_slopes(cw: torch.Tensor, o: int, n: int, spec: HashGridSpec, acc):
    """dw_c / dfrac_d [O, N, L, 8, 3] of the per-axis weights cw [O N, L, 8,
    3]: the other two axes' weights, signed by corner c's bit along d."""
    sign = torch.tensor(hashgrid.CORNERS, device=cw.device) * 2.0 - 1.0  # [8, 3]
    others = torch.stack([cw[..., 1] * cw[..., 2], cw[..., 0] * cw[..., 2],
                          cw[..., 0] * cw[..., 1]], dim=-1)
    return (others * sign).reshape(o, n, spec.n_levels, 8, 3).to(acc)


def _scales(spec: HashGridSpec, device, acc) -> torch.Tensor:
    return torch.tensor(spec.scales, dtype=torch.float32, device=device).to(acc)


def points_gradient_plain(points, table, g, spec: HashGridSpec) -> torch.Tensor:
    """H0's twin: the points' gradient [O, N, 3] fp32,
    dx_d = sum_l scale_l sum_c <g_l, row_c> dw_c / dfrac_d (frac's
    derivative is 1: floor has none; the rows have none)."""
    o, n = points.shape[:2]
    lv, f = spec.n_levels, spec.n_features
    rows, cw = hashgrid.corner_rows(points.reshape(-1, 3), spec)
    acc = _acc_dtype(table.dtype)
    feats = _gather(table, rows, o, n, spec).to(acc)
    gv = torch.sum(feats * g.reshape(o, n, lv, 1, f).to(acc), dim=-1)  # [O, N, L, 8]
    dw = _weight_slopes(cw, o, n, spec, acc)
    per_level = torch.sum(gv[..., None] * dw, dim=3)  # [O, N, L, 3]
    scales = _scales(spec, points.device, acc)
    return torch.sum(per_level * scales[:, None], dim=2).to(points.dtype)


def normal_backward_plain(points, table, g, v, spec: HashGridSpec):
    """H3's twin: H0's backward from the cotangent v [O, N, 3] of its output,
    (dg [O, N, L F] in g's dtype, dtable [O, T, F] in the table's dtype),
    with u_c = scale_l sum_d v_d dw_c / dfrac_d per point, level and corner:
    dg_l = sum_c u_c row_c, and dtable[row_c] += u_c g_l (`index_add_`),
    summed in fp32 and cast once. The points get no gradient."""
    o, n = points.shape[:2]
    lv, f = spec.n_levels, spec.n_features
    rows, cw = hashgrid.corner_rows(points.reshape(-1, 3), spec)
    acc = _acc_dtype(table.dtype)
    dw = _weight_slopes(cw, o, n, spec, acc)
    u = torch.sum(dw * v.reshape(o, n, 1, 1, 3).to(acc), dim=-1)  # [O, N, L, 8]
    u = u * _scales(spec, points.device, acc)[:, None]
    feats = _gather(table, rows, o, n, spec).to(acc)
    dg = torch.sum(u[..., None] * feats, dim=3).reshape(o, n, -1).to(g.dtype)
    terms = u[..., None] * g.reshape(o, n, lv, 1, f).to(acc)
    buf = torch.zeros((o * spec.total_params, f), dtype=acc, device=g.device)
    buf.index_add_(0, _object_rows(rows, o, spec), terms.reshape(-1, f))
    return dg, buf.reshape(o, spec.total_params, f).to(table.dtype)


# --------------------------------------------------------------------------
# The kernels
# --------------------------------------------------------------------------


@cuda_lib.counted
def forward(points, table, spec: HashGridSpec) -> torch.Tensor:
    """H1 (its twin for CPU tensors)."""
    dt, dev = table.dtype, points.device
    if not cuda_lib.on_card(points, dt):
        return forward_plain(points, table, spec)
    levels = _level_args(spec)
    o, n = points.shape[:2]
    cuda_lib.check("points", points, (o, n, 3), torch.float32, dev)
    cuda_lib.check("table", table, (o, spec.total_params, spec.n_features), dt, dev,
                   align=spec.n_features * table.element_size())
    out = torch.empty((o, n, spec.n_output_dims), dtype=dt, device=dev)
    cuda_lib.launch(forward, "H1 hash forward", "romap_hash_fwd", dt, dev,
                    points.data_ptr(), table.data_ptr(), out.data_ptr(),
                    *levels, o, n, spec.total_params)
    return out


@cuda_lib.counted
def table_gradient(points, g, spec: HashGridSpec) -> torch.Tensor:
    """H2 (its twin for CPU tensors): [O, T, F] in g's dtype."""
    dt, dev = g.dtype, points.device
    if not cuda_lib.on_card(points, dt):
        return table_gradient_plain(points, g, spec)
    levels = _level_args(spec)
    o, n = points.shape[:2]
    cuda_lib.check("points", points, (o, n, 3), torch.float32, dev)
    cuda_lib.check("g", g, (o, n, spec.n_output_dims), dt, dev,
                   align=spec.n_features * g.element_size())
    buf = torch.zeros((o, spec.total_params, spec.n_features), dtype=torch.float32,
                      device=dev)
    cuda_lib.launch(table_gradient, "H2 hash table gradient", "romap_hash_bwd", dt, dev,
                    points.data_ptr(), g.data_ptr(), buf.data_ptr(), *levels, o, n,
                    spec.total_params)
    return buf.to(dt)


@cuda_lib.counted
def points_gradient(points, table, g, spec: HashGridSpec) -> torch.Tensor:
    """H0 (its twin for CPU tensors): [O, N, 3] fp32."""
    dt, dev = table.dtype, points.device
    if not cuda_lib.on_card(points, dt):
        return points_gradient_plain(points, table, g, spec)
    levels = _level_args(spec)
    o, n = points.shape[:2]
    cuda_lib.check("points", points, (o, n, 3), torch.float32, dev)
    cuda_lib.check("table", table, (o, spec.total_params, spec.n_features), dt, dev,
                   align=spec.n_features * table.element_size())
    cuda_lib.check("g", g, (o, n, spec.n_output_dims), dt, dev,
                   align=spec.n_features * g.element_size())
    dpts = torch.empty((o, n, 3), dtype=torch.float32, device=dev)
    cuda_lib.launch(points_gradient, "H0 hash points gradient", "romap_hash_points_grad",
                    dt, dev, points.data_ptr(), table.data_ptr(), g.data_ptr(),
                    dpts.data_ptr(), *levels, o, n, spec.total_params)
    return dpts


@cuda_lib.counted
def normal_backward(points, table, g, v, spec: HashGridSpec):
    """H3 (its twin for CPU tensors): (dg [O, N, L F] in g's dtype, dtable
    [O, T, F] in the table's dtype)."""
    dt, dev = table.dtype, points.device
    if not cuda_lib.on_card(points, dt):
        return normal_backward_plain(points, table, g, v, spec)
    levels = _level_args(spec)
    o, n = points.shape[:2]
    cuda_lib.check("points", points, (o, n, 3), torch.float32, dev)
    cuda_lib.check("table", table, (o, spec.total_params, spec.n_features), dt, dev,
                   align=spec.n_features * table.element_size())
    cuda_lib.check("g", g, (o, n, spec.n_output_dims), dt, dev,
                   align=spec.n_features * g.element_size())
    cuda_lib.check("v", v, (o, n, 3), torch.float32, dev)
    dg = torch.empty((o, n, spec.n_output_dims), dtype=dt, device=dev)
    buf = torch.zeros((o, spec.total_params, spec.n_features), dtype=torch.float32,
                      device=dev)
    cuda_lib.launch(normal_backward, "H3 hash normal backward", "romap_hash_normal_bwd", dt,
                    dev, points.data_ptr(), table.data_ptr(), g.data_ptr(), v.data_ptr(),
                    dg.data_ptr(), buf.data_ptr(), *levels, o, n, spec.total_params)
    return dg, buf.to(dt)


KERNELS = cuda_lib.register({"H0": points_gradient, "H1": forward, "H2": table_gradient,
                             "H3": normal_backward}, rank=1)


# --------------------------------------------------------------------------
# The differentiable encode
# --------------------------------------------------------------------------


class _Encode(torch.autograd.Function):
    """Forward: H1. Backward: H2 where the table needs a gradient, H0 where
    the points do (then the forward also keeps the table)."""

    @staticmethod
    def forward(ctx, points, table, spec):
        out = forward(points, table, spec)
        ctx.save_for_backward(points, table if ctx.needs_input_grad[0] else None)
        ctx.spec, ctx.dtype = spec, table.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        points, table = ctx.saved_tensors
        g = g.to(ctx.dtype).contiguous()
        dtable = table_gradient(points, g, ctx.spec) if ctx.needs_input_grad[1] else None
        dpts = points_gradient(points, table, g, ctx.spec) if ctx.needs_input_grad[0] else None
        return dpts, dtable, None


def encode(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """`hashgrid.encode`: table [O, T, F] (float32 or bfloat16 on the card),
    points x [O, ..., 3] -> [O, ..., L F] in the table's dtype."""
    o, batch_shape = x.shape[0], x.shape[1:-1]
    pts = x.reshape(o, -1, 3).float().contiguous()
    out = _Encode.apply(pts, table, spec)
    return out.reshape(o, *batch_shape, spec.n_output_dims)


class _PointsGradient(torch.autograd.Function):
    """Forward: H0, the gradient in the points of <encode(points, table), g>.
    Backward: H3, the gradients of g and of the table; none for the points
    (it would take the encode's second derivative in them, which no kernel
    computes: asking for it raises)."""

    @staticmethod
    def forward(ctx, points, table, g, spec):
        ctx.save_for_backward(points, table, g)
        ctx.spec = spec
        return points_gradient(points, table, g, spec)

    @staticmethod
    @once_differentiable
    def backward(ctx, v):
        if ctx.needs_input_grad[0]:
            raise NotImplementedError("the hash grid's points gradient takes no gradient in "
                                      "the points (H3 computes g's and the table's)")
        points, table, g = ctx.saved_tensors
        dg, dtable = normal_backward(points, table, g, v.contiguous(), ctx.spec)
        return None, dtable if ctx.needs_input_grad[1] else None, \
            dg if ctx.needs_input_grad[2] else None, None


def encode_points_gradient(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                           spec: HashGridSpec) -> torch.Tensor:
    """The gradient [O, ..., 3] fp32 in the points x [O, ..., 3] of
    <encode(table, x), g> for a cotangent g [O, ..., L F] in the table's
    dtype: H0 forward, differentiable in the table and in g through H3."""
    o, batch_shape = x.shape[0], x.shape[1:-1]
    pts = x.reshape(o, -1, 3).float().contiguous()
    gg = g.reshape(o, -1, spec.n_output_dims).to(table.dtype).contiguous()
    out = _PointsGradient.apply(pts, table, gg, spec)
    return out.reshape(o, *batch_shape, 3)
