"""Folded MX-grid encode on the card: kernels K1 (forward) and K2 (backward).

Counterpart of the folded fused path of romap_tpu/ops/mxgrid_pallas.py
(`_folded_fused_forward` / `_folded_fused_backward` and their kernels,
448-580). The CUDA sources are `romap_tpu_torch/csrc/*.cu`; they are built
with nvcc into a shared library with a plain C interface at the first CUDA
call (never at import) and loaded with ctypes. The build lands in
`build/romap_tpu_torch/` beside the package, keyed on a hash of the sources
and flags.

Every kernel has a plain PyTorch twin of the same signature in this module.
A wrapper picks by device alone: a CPU tensor goes to the twin (the CPU
tests), a CUDA tensor launches the kernel or raises. No config value (the
reference's `mx_impl`, `MX_FUSED`, `MX_SNAP`) routes a CUDA tensor to a
plain version, and no failure of the build or of a launch is caught.

Each wrapper counts its kernel launches in a plain int attribute
(`folded_fused_forward.launches`, `folded_fused_backward.launches`).

Points get no gradient, as in the Pallas VJP (mxgrid_pallas.py:892-895,
916-919): `encode_folded` raises when the points require one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from romap_tpu_torch.ops.mxgrid import MXGridSpec, fold_lines, hat1, unfold_dlines

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "romap_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cannot build the "
                       "romap_tpu_torch CUDA kernels")


def build_library() -> Path:
    """Compile csrc/*.cu into one shared library (once per source hash) and
    return its path. nvcc's output (ptxas register and shared-memory
    report) is kept beside it as `<lib>.log`."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    lib = BUILD_DIR / f"libromap_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".so.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)  # atomic: another process never sees a partial file
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("romap_mx_folded_fwd", "romap_mx_folded_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [i32] + [ptr] * 8 + [i32] * 10 + [ptr]
        fn.restype = i32
    return lib


def _dims(spec: MXGridSpec) -> tuple[int, ...]:
    """(K, rf, rfp, ru, rv, kp, rw, axes) of a folded one-plane-level spec."""
    if not spec.snap_levels or len(spec.plane_specs) != 1:
        raise NotImplementedError(
            "the CUDA encode covers the folded (snap_levels) spec with one "
            "plane level; unsnapped and CP-only specs (kernels K3-K8 of "
            "ROADMAP.md) are not ported yet")
    (ru, rv, kp), = spec.plane_specs
    axes = sum(a << (2 * (3 * i + j))
               for i, pair in enumerate(spec.plane_axes) for j, a in enumerate(pair))
    rf, rfp = spec.fold_res
    return spec.features, rf, rfp, ru, rv, kp, max(ru, rv), axes


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(code: int, what: str) -> None:
    """A launch the C side refused or that failed to start (cudaError_t;
    e.g. 1, invalid value, when a table does not fit shared memory)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


# --------------------------------------------------------------------------
# K1: folded fused forward
# --------------------------------------------------------------------------


def folded_fused_forward_plain(points, w_eff, planes, plines, spec: MXGridSpec):
    """Plain twin of K1, dense tent bases in fp32 as the Pallas kernel
    builds them; tables are read in their dtype and upcast, sums are fp32,
    results are stored in the table dtype.

    Args:
      points [O, P, 3] f32; w_eff [O, 3, rfp, K]; planes [O, 3, ru, rv, kp];
      plines [O, 3, rw, kp] (one plane level).
    Returns:
      out [O, P, K + 3kp], afac [O, 3, K, P], fpl and fli [O, 3kp, P].
    """
    k, rf, _, ru, rv, kp, rw, _ = _dims(spec)
    dt = w_eff.dtype
    o, p = points.shape[:2]
    a = torch.stack([
        torch.matmul(hat1(points[..., d], rf), w_eff[:, d, :rf].float())
        for d in range(3)
    ], dim=1).to(dt)  # [O, 3, P, K]
    af = a.float()
    blocks, fpl, fli = [(af[:, 0] * af[:, 1] * af[:, 2]).to(dt)], [], []
    for i, (u, v, w) in enumerate(spec.plane_axes):
        hu = hat1(points[..., u], ru)
        hv = hat1(points[..., v], rv)
        t = torch.matmul(hu, planes[:, i].float().reshape(o, ru, rv * kp))
        f_pl = torch.sum(t.reshape(o, p, rv, kp) * hv[..., None], dim=2)
        f_li = torch.matmul(hat1(points[..., w], rw), plines[:, i].float())
        blocks.append((f_pl * f_li).to(dt))
        fpl.append(f_pl.to(dt))
        fli.append(f_li.to(dt))
    out = torch.cat(blocks, dim=-1)
    afac = a.transpose(2, 3).contiguous()
    return (out, afac, torch.cat(fpl, -1).transpose(1, 2).contiguous(),
            torch.cat(fli, -1).transpose(1, 2).contiguous())


def folded_fused_forward(points, w_eff, planes, plines, spec: MXGridSpec):
    """K1 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `folded_fused_forward_plain`)."""
    if points.device.type == "cpu":
        return folded_fused_forward_plain(points, w_eff, planes, plines, spec)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    k, rf, rfp, ru, rv, kp, rw, axes = _dims(spec)
    dev, dt = points.device, w_eff.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"table dtype {dt} not supported (float32, bfloat16)")
    o, p = points.shape[:2]
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check("w_eff", w_eff, (o, 3, rfp, k), dt, dev)
    _check("planes", planes, (o, 3, ru, rv, kp), dt, dev)
    _check("plines", plines, (o, 3, rw, kp), dt, dev)
    out = torch.empty((o, p, k + 3 * kp), dtype=dt, device=dev)
    afac = torch.empty((o, 3, k, p), dtype=dt, device=dev)
    fpl = torch.empty((o, 3 * kp, p), dtype=dt, device=dev)
    fli = torch.empty_like(fpl)
    lib = _library()
    with torch.cuda.device(dev):
        code = lib.romap_mx_folded_fwd(
            _DTYPE_CODE[dt], points.data_ptr(), w_eff.data_ptr(),
            planes.data_ptr(), plines.data_ptr(), out.data_ptr(),
            afac.data_ptr(), fpl.data_ptr(), fli.data_ptr(),
            o, p, k, rf, rfp, ru, rv, kp, rw, axes,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "K1 folded_fused_forward")
    folded_fused_forward.launches += 1
    return out, afac, fpl, fli


folded_fused_forward.launches = 0


# --------------------------------------------------------------------------
# K2: folded fused backward
# --------------------------------------------------------------------------


def folded_fused_backward_plain(points, afac, fpl, fli, g, spec: MXGridSpec):
    """Plain twin of K2: fp32 parameter gradients from K1's residuals and
    the cotangent g [O, P, K + 3kp].

    Returns dW_eff [O, 3, rfp, K], dplanes [O, 3, ru, rv, kp] and dplines
    [O, 3, rw, kp], all f32 (pad rows of dW_eff stay zero).
    """
    k, rf, rfp, ru, rv, kp, rw, _ = _dims(spec)
    o, p = points.shape[:2]
    g = g.float()
    a = afac.float().transpose(2, 3)  # [O, 3, P, K]
    gc = g[..., :k]
    others = ((1, 2), (0, 2), (0, 1))
    dw = torch.zeros((o, 3, rfp, k), dtype=torch.float32, device=points.device)
    for d, (e, f) in enumerate(others):
        u = gc * a[:, e] * a[:, f]
        dw[:, d, :rf] = torch.matmul(hat1(points[..., d], rf).transpose(1, 2), u)
    dplanes, dplines = [], []
    for i, (u, v, w) in enumerate(spec.plane_axes):
        gi = g[..., k + i * kp : k + (i + 1) * kp]
        f_pl = fpl[:, i * kp : (i + 1) * kp].float().transpose(1, 2)
        f_li = fli[:, i * kp : (i + 1) * kp].float().transpose(1, 2)
        hw = hat1(points[..., w], rw)
        dplines.append(torch.matmul(hw.transpose(1, 2), gi * f_pl))
        hu = hat1(points[..., u], ru)
        hv = hat1(points[..., v], rv)
        q = (hv[..., None] * (gi * f_li)[:, :, None, :]).reshape(o, p, rv * kp)
        dplanes.append(torch.matmul(hu.transpose(1, 2), q).reshape(o, ru, rv, kp))
    return dw, torch.stack(dplanes, dim=1), torch.stack(dplines, dim=1)


def folded_fused_backward(points, afac, fpl, fli, g, spec: MXGridSpec):
    """K2 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `folded_fused_backward_plain`)."""
    if points.device.type == "cpu":
        return folded_fused_backward_plain(points, afac, fpl, fli, g, spec)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    k, rf, rfp, ru, rv, kp, rw, axes = _dims(spec)
    dev, dt = points.device, afac.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"residual dtype {dt} not supported (float32, bfloat16)")
    o, p = points.shape[:2]
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check("afac", afac, (o, 3, k, p), dt, dev)
    _check("fpl", fpl, (o, 3 * kp, p), dt, dev)
    _check("fli", fli, (o, 3 * kp, p), dt, dev)
    _check("g", g, (o, p, k + 3 * kp), dt, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dw = torch.zeros((o, 3, rfp, k), **f32)
    dplanes = torch.zeros((o, 3, ru, rv, kp), **f32)
    dplines = torch.zeros((o, 3, rw, kp), **f32)
    lib = _library()
    with torch.cuda.device(dev):
        code = lib.romap_mx_folded_bwd(
            _DTYPE_CODE[dt], points.data_ptr(), afac.data_ptr(),
            fpl.data_ptr(), fli.data_ptr(), g.data_ptr(), dw.data_ptr(),
            dplanes.data_ptr(), dplines.data_ptr(),
            o, p, k, rf, rfp, ru, rv, kp, rw, axes,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "K2 folded_fused_backward")
    folded_fused_backward.launches += 1
    return dw, dplanes, dplines


folded_fused_backward.launches = 0


# --------------------------------------------------------------------------
# The differentiable encode
# --------------------------------------------------------------------------


class _EncodeFolded(torch.autograd.Function):
    """Forward: fold the lines (one einsum), then K1. Backward: K2, then the
    transposed fold (one einsum), as JAX does around its kernels
    (mxgrid_pallas.py:490-493, 538-544)."""

    @staticmethod
    def forward(ctx, points, lines, planes, plines, spec):
        w_eff = fold_lines(lines, spec).contiguous()
        out, afac, fpl, fli = folded_fused_forward(
            points, w_eff, planes.contiguous(), plines.contiguous(), spec)
        ctx.save_for_backward(points, afac, fpl, fli)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, g):
        points, afac, fpl, fli = ctx.saved_tensors
        dt = afac.dtype
        dw, dplanes, dplines = folded_fused_backward(
            points, afac, fpl, fli, g.to(dt).contiguous(), ctx.spec)
        return (None, unfold_dlines(dw, ctx.spec, dt), dplanes.to(dt),
                dplines.to(dt), None)


def encode_folded(factors: dict, p: torch.Tensor, spec: MXGridSpec) -> torch.Tensor:
    """Differentiable folded encode through K1/K2 (their twins on the CPU).

    Args:
      factors: {"lines": [O, 3, total_res, K], "planes": ([O, 3, ru, rv, kp],),
        "plane_lines": ([O, 3, rw, kp],)}, one dtype (float32 or bfloat16).
      p: [O, ..., 3] points in the unit cube.
    Returns:
      [O, ..., K + 3kp] features in the parameter dtype. Gradients reach the
      three tables; asking for a gradient of the points raises.
    """
    _dims(spec)
    if p.requires_grad:
        raise NotImplementedError(
            "encode_folded has no gradient for the points (as the Pallas "
            "VJP); differentiate the points through ops.mxgrid.encode")
    o, batch_shape = p.shape[0], p.shape[1:-1]
    pts = p.reshape(o, -1, 3).float().contiguous()
    out = _EncodeFolded.apply(pts, factors["lines"], factors["planes"][0],
                              factors["plane_lines"][0], spec)
    return out.reshape(o, *batch_shape, spec.n_output_dims)
