"""MX-grid encode on the card: kernels K1-K6.

Counterpart of the fused and folded paths of romap_tpu/ops/mxgrid_pallas.py.
The spec picks the kernels as `_fwd_impl_t` / `_bwd_impl_t` do (727-742,
754-829):

  folded (snap_levels), one plane level   K1 forward, K2 backward
  unsnapped, one plane level              K3 forward, K4 backward
  folded, CP only (the `fast` preset)     K5 forward, K6 backward

Any other spec (unsnapped CP-only, which needs K7/K8, or several plane
levels) raises NotImplementedError on a CUDA tensor; it never falls back to
the plain encode.

The CUDA sources are `romap_tpu_torch/csrc/*.cu`; they are built with nvcc
into one shared library with a plain C interface at the first CUDA call
(never at import) and loaded with ctypes. The build lands in
`build/romap_tpu_torch/` beside the package, keyed on a hash of the sources
and flags.

Every kernel has a plain PyTorch twin of the same signature in this module.
A wrapper picks by device alone: a CPU tensor goes to the twin (the CPU
tests), a CUDA tensor launches the kernel or raises. No config value (the
reference's `mx_impl`, `MX_FUSED`) routes a CUDA tensor to a plain version,
and no failure of the build or of a launch is caught.

Each wrapper counts its kernel launches in a plain int attribute
(`folded_fused_forward.launches`, ...) and, per table dtype, in
`launches_by_dtype` (e.g. {"bfloat16": 3, "float32": 1}).

Points get no gradient, as in the Pallas VJP (mxgrid_pallas.py:892-895,
916-919): `encode` raises when the points require one.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from romap_tpu_torch.ops.mxgrid import (
    MXGridSpec,
    fold_lines,
    hat1,
    hat_basis,
    unfold_dlines,
)

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "romap_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 8  # kMaxLevels of mxgrid_unsnapped.cu


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


def _compile(src: Path, obj: Path) -> subprocess.Popen:
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    return subprocess.Popen([_find_nvcc(), *flags, "-c", "-o", str(obj), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_library() -> Path:
    """Compile csrc/*.cu into one shared library (once per source hash) and
    return its path. Each source compiles in its own nvcc process, all
    started together; nvcc's output (the ptxas register and shared-memory
    report) is kept beside the library as `<lib>.so.log`."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    lib = BUILD_DIR / f"libromap_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    procs = [_compile(src, obj) for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([_find_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        failed = link.returncode
    else:
        failed = next(p.returncode for p in procs if p.returncode != 0)
    lib.with_suffix(".so.log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n" + "".join(logs))
    os.replace(tmp, lib)  # atomic: another process never sees a partial file
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, ints = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    argtypes = {
        "romap_mx_folded_fwd": [i32] + [ptr] * 8 + [i32] * 10 + [ptr],
        "romap_mx_folded_bwd": [i32] + [ptr] * 8 + [i32] * 10 + [ptr],
        "romap_mx_folded_cp_fwd": [i32] + [ptr] * 4 + [i32] * 5 + [ptr],
        "romap_mx_folded_cp_bwd": [i32] + [ptr] * 4 + [i32] * 5 + [ptr],
        "romap_mx_unsnapped_fwd": [i32] + [ptr] * 8 + [ints] * 2 + [i32] * 10 + [ptr],
        "romap_mx_unsnapped_bwd": [i32] + [ptr] * 8 + [ints] * 2 + [i32] * 10 + [ptr],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = i32
    return lib


def kernel_path(spec: MXGridSpec) -> str:
    """"folded" (K1/K2), "unsnapped" (K3/K4) or "folded_cp" (K5/K6); raises
    NotImplementedError for a spec no ported kernel covers."""
    n_planes = len(spec.plane_specs)
    if n_planes > 1:
        raise NotImplementedError(
            f"the CUDA encode takes one plane level; this spec has {n_planes} "
            "(several plane levels are not ported yet, ROADMAP.md)")
    if n_planes == 1:
        return "folded" if spec.snap_levels else "unsnapped"
    if spec.snap_levels:
        return "folded_cp"
    raise NotImplementedError(
        "the unsnapped CP-only encode needs kernels K7/K8 "
        "(mxgrid_pallas._fwd_cp_kernel/_bwd_cp_kernel), which are not ported "
        "yet (ROADMAP.md)")


def _plane_dims(spec: MXGridSpec) -> tuple[int, int, int, int, int]:
    """(ru, rv, kp, rw, axes) of a one-plane-level spec; `axes` packs the
    (u, v, w) axis of the three plane pairs, 2 bits each."""
    (ru, rv, kp), = spec.plane_specs
    axes = sum(a << (2 * (3 * i + j))
               for i, pair in enumerate(spec.plane_axes) for j, a in enumerate(pair))
    return ru, rv, kp, max(ru, rv), axes


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_card(points: torch.Tensor, dt: torch.dtype) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain twin)."""
    if points.device.type == "cpu":
        return False
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if dt not in _DTYPE_CODE:
        raise ValueError(f"table dtype {dt} not supported (float32, bfloat16)")
    return True


def _launch(wrapper, what: str, fn_name: str, dt: torch.dtype, dev, *args) -> None:
    """Call the C entry point on the current stream of `dev`; raise on a
    refused launch (cudaError_t, e.g. 1 when a table does not fit shared
    memory), else count it."""
    lib = _library()
    with torch.cuda.device(dev):
        code = getattr(lib, fn_name)(_DTYPE_CODE[dt], *args,
                                     torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
    wrapper.launches += 1
    wrapper.launches_by_dtype[str(dt).split(".")[1]] += 1


def _counted(fn):
    fn.launches = 0
    fn.launches_by_dtype = collections.Counter()
    return fn


def _ladder(spec: MXGridSpec):
    n = len(spec.resolutions)
    if n > MAX_LEVELS:
        raise NotImplementedError(
            f"K3/K4 take at most {MAX_LEVELS} ladder levels; this spec has {n}")
    arr = ctypes.c_int * n
    return arr(*spec.resolutions), arr(*spec.offsets), n


# --------------------------------------------------------------------------
# Plain twins, shared parts (dense tent bases in fp32, as the Pallas kernels
# build them; tables are read in their dtype and upcast, sums are fp32,
# results are stored in the table dtype)
# --------------------------------------------------------------------------


def _cp_factors_plain(points, w, basis) -> torch.Tensor:
    """A_d = basis(x_d) @ W_d per axis -> [O, 3, P, K] fp32 (unrounded)."""
    return torch.stack([torch.matmul(basis(points[..., d]), w[:, d].float())
                        for d in range(3)], dim=1)


def _planes_plain(points, planes, plines, spec, dt):
    """Plane level: (out blocks [O, P, kp] x 3, fpl, fli [O, 3kp, P])."""
    ru, rv, kp, rw, _ = _plane_dims(spec)
    o, p = points.shape[:2]
    blocks, fpl, fli = [], [], []
    for i, (u, v, w) in enumerate(spec.plane_axes):
        hu = hat1(points[..., u], ru)
        hv = hat1(points[..., v], rv)
        t = torch.matmul(hu, planes[:, i].float().reshape(o, ru, rv * kp))
        f_pl = torch.sum(t.reshape(o, p, rv, kp) * hv[..., None], dim=2)
        f_li = torch.matmul(hat1(points[..., w], rw), plines[:, i].float())
        blocks.append((f_pl * f_li).to(dt))
        fpl.append(f_pl.to(dt))
        fli.append(f_li.to(dt))
    return (blocks, torch.cat(fpl, -1).transpose(1, 2).contiguous(),
            torch.cat(fli, -1).transpose(1, 2).contiguous())


def _fused_forward_plain(points, w, planes, plines, spec, basis):
    """CP factors through `basis` + one plane level: out [O, P, K + 3kp],
    afac [O, 3, K, P], fpl and fli [O, 3kp, P]."""
    dt = w.dtype
    a = _cp_factors_plain(points, w, basis).to(dt)  # [O, 3, P, K]
    af = a.float()
    blocks, fpl, fli = _planes_plain(points, planes, plines, spec, dt)
    out = torch.cat([(af[:, 0] * af[:, 1] * af[:, 2]).to(dt)] + blocks, dim=-1)
    return out, a.transpose(2, 3).contiguous(), fpl, fli


def _cp_grad_plain(points, afac, g, basis) -> torch.Tensor:
    """dW_d = basis(x_d)^T (g * A_e * A_f) per axis -> [O, 3, rows, K] fp32."""
    a = afac.float().transpose(2, 3)  # [O, 3, P, K]
    gc = g.float()[..., : a.shape[-1]]
    others = ((1, 2), (0, 2), (0, 1))
    return torch.stack([
        torch.matmul(basis(points[..., d]).transpose(1, 2), gc * a[:, e] * a[:, f])
        for d, (e, f) in enumerate(others)], dim=1)


def _plane_grad_plain(points, fpl, fli, g, spec):
    """dplanes [O, 3, ru, rv, kp] and dplines [O, 3, rw, kp], fp32."""
    ru, rv, kp, rw, _ = _plane_dims(spec)
    o, p = points.shape[:2]
    k = spec.features
    g = g.float()
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
    return torch.stack(dplanes, dim=1), torch.stack(dplines, dim=1)


def _folded_basis(spec):
    rf, rfp = spec.fold_res
    return lambda x: torch.nn.functional.pad(hat1(x, rf), (0, rfp - rf))


def _ladder_basis(spec):
    return lambda x: hat_basis(x, spec)


# --------------------------------------------------------------------------
# K1 / K2: folded, one plane level
# --------------------------------------------------------------------------


def folded_fused_forward_plain(points, w_eff, planes, plines, spec: MXGridSpec):
    """Plain twin of K1.

    Args:
      points [O, P, 3] f32; w_eff [O, 3, rfp, K]; planes [O, 3, ru, rv, kp];
      plines [O, 3, rw, kp] (one plane level).
    Returns:
      out [O, P, K + 3kp], afac [O, 3, K, P], fpl and fli [O, 3kp, P].
    """
    return _fused_forward_plain(points, w_eff, planes, plines, spec, _folded_basis(spec))


@_counted
def folded_fused_forward(points, w_eff, planes, plines, spec: MXGridSpec):
    """K1 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `folded_fused_forward_plain`)."""
    dt = w_eff.dtype
    if not _on_card(points, dt):
        return folded_fused_forward_plain(points, w_eff, planes, plines, spec)
    k, (rf, rfp) = spec.features, spec.fold_res
    ru, rv, kp, rw, axes = _plane_dims(spec)
    dev = points.device
    o, p = points.shape[:2]
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check("w_eff", w_eff, (o, 3, rfp, k), dt, dev)
    _check("planes", planes, (o, 3, ru, rv, kp), dt, dev)
    _check("plines", plines, (o, 3, rw, kp), dt, dev)
    out = torch.empty((o, p, k + 3 * kp), dtype=dt, device=dev)
    afac = torch.empty((o, 3, k, p), dtype=dt, device=dev)
    fpl = torch.empty((o, 3 * kp, p), dtype=dt, device=dev)
    fli = torch.empty_like(fpl)
    _launch(folded_fused_forward, "K1 folded_fused_forward", "romap_mx_folded_fwd", dt, dev,
            points.data_ptr(), w_eff.data_ptr(), planes.data_ptr(), plines.data_ptr(),
            out.data_ptr(), afac.data_ptr(), fpl.data_ptr(), fli.data_ptr(),
            o, p, k, rf, rfp, ru, rv, kp, rw, axes)
    return out, afac, fpl, fli


def folded_fused_backward_plain(points, afac, fpl, fli, g, spec: MXGridSpec):
    """Plain twin of K2: fp32 parameter gradients from K1's residuals and
    the cotangent g [O, P, K + 3kp].

    Returns dW_eff [O, 3, rfp, K], dplanes [O, 3, ru, rv, kp] and dplines
    [O, 3, rw, kp], all f32 (pad rows of dW_eff stay zero).
    """
    dw = _cp_grad_plain(points, afac, g, _folded_basis(spec))
    return (dw, *_plane_grad_plain(points, fpl, fli, g, spec))


@_counted
def folded_fused_backward(points, afac, fpl, fli, g, spec: MXGridSpec):
    """K2 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `folded_fused_backward_plain`)."""
    dt = afac.dtype
    if not _on_card(points, dt):
        return folded_fused_backward_plain(points, afac, fpl, fli, g, spec)
    k, (rf, rfp) = spec.features, spec.fold_res
    ru, rv, kp, rw, axes = _plane_dims(spec)
    dev = points.device
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
    _launch(folded_fused_backward, "K2 folded_fused_backward", "romap_mx_folded_bwd", dt, dev,
            points.data_ptr(), afac.data_ptr(), fpl.data_ptr(), fli.data_ptr(),
            g.data_ptr(), dw.data_ptr(), dplanes.data_ptr(), dplines.data_ptr(),
            o, p, k, rf, rfp, ru, rv, kp, rw, axes)
    return dw, dplanes, dplines


# --------------------------------------------------------------------------
# K3 / K4: unsnapped ladder, one plane level
# --------------------------------------------------------------------------


def unsnapped_fused_forward_plain(points, lines, planes, plines, spec: MXGridSpec):
    """Plain twin of K3 (`_fused_forward`): the CP factors read every level
    of the ladder (lines [O, 3, total_res, K]); otherwise K1's contract."""
    return _fused_forward_plain(points, lines, planes, plines, spec, _ladder_basis(spec))


@_counted
def unsnapped_fused_forward(points, lines, planes, plines, spec: MXGridSpec):
    """K3 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `unsnapped_fused_forward_plain`)."""
    dt = lines.dtype
    if not _on_card(points, dt):
        return unsnapped_fused_forward_plain(points, lines, planes, plines, spec)
    k, total = spec.features, spec.total_res
    ru, rv, kp, rw, axes = _plane_dims(spec)
    res, off, n_lvl = _ladder(spec)
    dev = points.device
    o, p = points.shape[:2]
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check("lines", lines, (o, 3, total, k), dt, dev)
    _check("planes", planes, (o, 3, ru, rv, kp), dt, dev)
    _check("plines", plines, (o, 3, rw, kp), dt, dev)
    out = torch.empty((o, p, k + 3 * kp), dtype=dt, device=dev)
    afac = torch.empty((o, 3, k, p), dtype=dt, device=dev)
    fpl = torch.empty((o, 3 * kp, p), dtype=dt, device=dev)
    fli = torch.empty_like(fpl)
    _launch(unsnapped_fused_forward, "K3 unsnapped_fused_forward", "romap_mx_unsnapped_fwd",
            dt, dev, points.data_ptr(), lines.data_ptr(), planes.data_ptr(),
            plines.data_ptr(), out.data_ptr(), afac.data_ptr(), fpl.data_ptr(),
            fli.data_ptr(), res, off, n_lvl, o, p, k, total, ru, rv, kp, rw, axes)
    return out, afac, fpl, fli


def unsnapped_fused_backward_plain(points, afac, fpl, fli, g, spec: MXGridSpec):
    """Plain twin of K4 (`_fused_backward`): dlines [O, 3, total_res, K],
    dplanes and dplines, all f32."""
    dlines = _cp_grad_plain(points, afac, g, _ladder_basis(spec))
    return (dlines, *_plane_grad_plain(points, fpl, fli, g, spec))


@_counted
def unsnapped_fused_backward(points, afac, fpl, fli, g, spec: MXGridSpec):
    """K4 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `unsnapped_fused_backward_plain`)."""
    dt = afac.dtype
    if not _on_card(points, dt):
        return unsnapped_fused_backward_plain(points, afac, fpl, fli, g, spec)
    k, total = spec.features, spec.total_res
    ru, rv, kp, rw, axes = _plane_dims(spec)
    res, off, n_lvl = _ladder(spec)
    dev = points.device
    o, p = points.shape[:2]
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check("afac", afac, (o, 3, k, p), dt, dev)
    _check("fpl", fpl, (o, 3 * kp, p), dt, dev)
    _check("fli", fli, (o, 3 * kp, p), dt, dev)
    _check("g", g, (o, p, k + 3 * kp), dt, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dlines = torch.zeros((o, 3, total, k), **f32)
    dplanes = torch.zeros((o, 3, ru, rv, kp), **f32)
    dplines = torch.zeros((o, 3, rw, kp), **f32)
    _launch(unsnapped_fused_backward, "K4 unsnapped_fused_backward",
            "romap_mx_unsnapped_bwd", dt, dev, points.data_ptr(), afac.data_ptr(),
            fpl.data_ptr(), fli.data_ptr(), g.data_ptr(), dlines.data_ptr(),
            dplanes.data_ptr(), dplines.data_ptr(), res, off, n_lvl,
            o, p, k, total, ru, rv, kp, rw, axes)
    return dlines, dplanes, dplines


# --------------------------------------------------------------------------
# K5 / K6: folded, CP only
# --------------------------------------------------------------------------


def folded_cp_forward_plain(points, w_eff, spec: MXGridSpec):
    """Plain twin of K5 (`_folded_cp_forward` and the product formed after
    it, mxgrid_pallas.py:734-736).

    Returns out [O, P, K] and afac [O, 3, K, P] in the table dtype. The
    product is taken in the table dtype, (A_0 A_1) A_2, rounding after each
    factor as the reference does.
    """
    dt = w_eff.dtype
    a = _cp_factors_plain(points, w_eff, _folded_basis(spec)).to(dt)
    return a[:, 0] * a[:, 1] * a[:, 2], a.transpose(2, 3).contiguous()


@_counted
def folded_cp_forward(points, w_eff, spec: MXGridSpec):
    """K5 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `folded_cp_forward_plain`)."""
    dt = w_eff.dtype
    if not _on_card(points, dt):
        return folded_cp_forward_plain(points, w_eff, spec)
    k, (rf, rfp) = spec.features, spec.fold_res
    dev = points.device
    o, p = points.shape[:2]
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check("w_eff", w_eff, (o, 3, rfp, k), dt, dev)
    out = torch.empty((o, p, k), dtype=dt, device=dev)
    afac = torch.empty((o, 3, k, p), dtype=dt, device=dev)
    _launch(folded_cp_forward, "K5 folded_cp_forward", "romap_mx_folded_cp_fwd", dt, dev,
            points.data_ptr(), w_eff.data_ptr(), out.data_ptr(), afac.data_ptr(),
            o, p, k, rf, rfp)
    return out, afac


def folded_cp_backward_plain(points, afac, g, spec: MXGridSpec):
    """Plain twin of K6 (`_folded_bwd_cp_kernel`): dW_eff [O, 3, rfp, K] f32
    from the factors and the cotangent g [O, P, K]."""
    return _cp_grad_plain(points, afac, g, _folded_basis(spec))


@_counted
def folded_cp_backward(points, afac, g, spec: MXGridSpec):
    """K6 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `folded_cp_backward_plain`)."""
    dt = afac.dtype
    if not _on_card(points, dt):
        return folded_cp_backward_plain(points, afac, g, spec)
    k, (rf, rfp) = spec.features, spec.fold_res
    dev = points.device
    o, p = points.shape[:2]
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check("afac", afac, (o, 3, k, p), dt, dev)
    _check("g", g, (o, p, k), dt, dev)
    dw = torch.zeros((o, 3, rfp, k), dtype=torch.float32, device=dev)
    _launch(folded_cp_backward, "K6 folded_cp_backward", "romap_mx_folded_cp_bwd", dt, dev,
            points.data_ptr(), afac.data_ptr(), g.data_ptr(), dw.data_ptr(),
            o, p, k, rf, rfp)
    return dw


KERNELS = {
    "K1": folded_fused_forward, "K2": folded_fused_backward,
    "K3": unsnapped_fused_forward, "K4": unsnapped_fused_backward,
    "K5": folded_cp_forward, "K6": folded_cp_backward,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.launches_by_dtype.clear()


# --------------------------------------------------------------------------
# The differentiable encode
# --------------------------------------------------------------------------


class _Encode(torch.autograd.Function):
    """Forward: fold the lines (one einsum) where the spec snaps, then the
    forward kernel. Backward: the backward kernel, then the transposed fold,
    as JAX does around its kernels (mxgrid_pallas.py:490-493, 538-544,
    769-774, 790-807). `planes` and `plines` are None for a CP-only spec."""

    @staticmethod
    def forward(ctx, points, lines, planes, plines, spec, path):
        if path == "unsnapped":
            out, *res = unsnapped_fused_forward(
                points, lines.contiguous(), planes.contiguous(), plines.contiguous(), spec)
        else:
            w_eff = fold_lines(lines, spec).contiguous()
            if path == "folded":
                out, *res = folded_fused_forward(
                    points, w_eff, planes.contiguous(), plines.contiguous(), spec)
            else:
                out, *res = folded_cp_forward(points, w_eff, spec)
        ctx.save_for_backward(points, *res)
        ctx.spec, ctx.path = spec, path
        return out

    @staticmethod
    def backward(ctx, g):
        points, *res = ctx.saved_tensors
        spec, dt = ctx.spec, res[0].dtype
        g = g.to(dt).contiguous()
        if ctx.path == "folded_cp":
            dw = folded_cp_backward(points, res[0], g, spec)
            return None, unfold_dlines(dw, spec, dt), None, None, None, None
        if ctx.path == "folded":
            dw, dplanes, dplines = folded_fused_backward(points, *res, g, spec)
            dlines = unfold_dlines(dw, spec, dt)
        else:
            dlines, dplanes, dplines = unsnapped_fused_backward(points, *res, g, spec)
            dlines = dlines.to(dt)
        return None, dlines, dplanes.to(dt), dplines.to(dt), None, None


def encode(factors, p: torch.Tensor, spec: MXGridSpec) -> torch.Tensor:
    """Differentiable encode through the kernel pair the spec selects (their
    twins on the CPU); see the module docstring.

    Args:
      factors: lines [O, 3, total_res, K] (CP only) or {"lines", "planes":
        ([O, 3, ru, rv, kp],), "plane_lines": ([O, 3, rw, kp],)}, one dtype
        (float32 or bfloat16).
      p: [O, ..., 3] points in the unit cube.
    Returns:
      [O, ..., n_output_dims] features in the parameter dtype. Gradients
      reach the tables; asking for a gradient of the points raises.
    """
    path = kernel_path(spec)
    if p.requires_grad:
        raise NotImplementedError(
            "the kernel encode has no gradient for the points (as the Pallas "
            "VJP); differentiate the points through ops.mxgrid.encode")
    o, batch_shape = p.shape[0], p.shape[1:-1]
    pts = p.reshape(o, -1, 3).float().contiguous()
    if isinstance(factors, dict):
        args = (factors["lines"], factors["planes"][0], factors["plane_lines"][0])
    else:
        args = (factors, None, None)
    out = _Encode.apply(pts, *args, spec, path)
    return out.reshape(o, *batch_shape, spec.n_output_dims)

