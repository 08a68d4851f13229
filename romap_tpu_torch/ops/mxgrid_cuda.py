"""MX-grid encode on the card: kernels K0-K10.

Counterpart of romap_tpu/ops/mxgrid_pallas.py. The spec and MX_FUSED pick
the kernels as `_fwd_impl_t` / `_bwd_impl_t` do (724-875):

  spec                              MX_FUSED   forward      backward
  folded (snap_levels), one plane   default    K1           K2
  unsnapped, one plane level        default    K3           K4
  folded, CP only (`fast`)          any        K5           K6
  unsnapped, CP only                any        K7           K8
  folded, with planes               0          K5 then K9   K6 then K10
  unsnapped, with planes            0          K7 then K9   K8 then K10

MX_FUSED is read from the environment each time `kernel_path` routes (the
reference reads its module global FUSED_FWD at call time), so a process
that sets it before its first encode gets the reference's pairs. Where
the reference forms a product outside its kernels in the table dtype
(mxgrid_pallas.py:736, 741), the port keeps those roundings: K5 and K7 (in
its three-axis variants) form the CP product in the kernel, rounding after
each factor; K7's per-axis variant leaves it to `cp_product`; K9 writes the
split path's plane features, the product of its two rounded samples
rounded once more (`plane_product`'s value). K9/K10 take
several plane levels; the fused K1-K4 take one, and a spec with more raises
NotImplementedError there, as does any spec no kernel covers: a CUDA
tensor never falls back to the plain encode.

Some kernels have variants, named from the spec and the table dtype alone:
the backwards K2/K6 (`folded_variant`), K4/K8 (`unsnapped_variant`) and K10
(`planes_variant`) run on the tensor cores in bf16 at the shapes their
sources instantiate (K4/K8 in fp32 too, on operands split into bf16 hi and
lo parts) and as the scalar kernel otherwise; the forward K1/K5
stages its feature rows in shared memory wherever they fit
(`forward_variant`); the forward K3/K7
holds all three axes' ladders in a block wherever they fit, else a slice of
their channels a block (`channel_split`, fp32), else one axis a block with
the product as a second pass (`unsnapped_forward_variant`; `cp_product_pass`
after K3, `cp_product` after K7). The C entry refuses a
combination it does not have, and the wrapper raises.

The CUDA sources are `romap_tpu_torch/csrc/*.cu`; they are built with nvcc
into one shared library with a plain C interface at the first CUDA call
(never at import) and loaded with ctypes. The build lands in
`build/romap_tpu_torch/` beside the package, keyed on a hash of the sources
and flags.

Every kernel has a plain PyTorch twin of the same signature in this module.
A wrapper picks by device alone: a CPU tensor goes to the twin (the CPU
tests), a CUDA tensor launches the kernel or raises. No config value (the
reference's `mx_impl`) routes a CUDA tensor to a plain version, and no
failure of the build or of a launch is caught.

Each wrapper counts its kernel launches in a plain int attribute
(`folded_fused_forward.launches`, ...) and, per table dtype, in
`launches_by_dtype` (e.g. {"bfloat16": 3, "float32": 1}); the backwards
with variants also per dtype and variant, in `launches_by_variant` (e.g.
{"float32 tensor_core_split": 21}).

The points get their gradient from K0 (`points_gradient`, csrc/
mxgrid_points.cu; variant `points_variant`), on every path, where they
require one (pose refinement): the Pallas VJP gives them none (mxgrid_pallas.py:892-895,
916-919), and the reference differentiates them through its XLA encode.
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
MAX_LEVELS = 8  # kMaxLevels of mxgrid_common.cuh
MAX_PLANE_LEVELS = 4  # kMaxPlaneLevels of mxgrid_common.cuh


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
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    argtypes = {
        "romap_mx_folded_fwd": [i32] * 2 + [ptr] * 8 + [i32] * 10 + [ptr],
        "romap_mx_folded_bwd": [i32] * 2 + [ptr] * 8 + [i32] * 10 + [ptr],
        "romap_mx_folded_cp_fwd": [i32] * 2 + [ptr] * 4 + [i32] * 5 + [ptr],
        "romap_mx_folded_cp_bwd": [i32] * 2 + [ptr] * 4 + [i32] * 5 + [ptr],
        "romap_mx_unsnapped_fwd": [i32] * 2 + [ptr] * 8 + [ints] * 2 + [i32] * 11 + [ptr],
        "romap_mx_cp_product": [i32] + [ptr] * 2 + [i32] * 4 + [ptr],
        "romap_mx_unsnapped_bwd": [i32] * 2 + [ptr] * 8 + [ints] * 2 + [i32] * 10 + [ptr],
        "romap_mx_unsnapped_cp_fwd": [i32] * 2 + [ptr] * 4 + [ints] * 2 + [i32] * 6 + [ptr],
        "romap_mx_unsnapped_cp_bwd": [i32] * 2 + [ptr] * 4 + [ints] * 2 + [i32] * 5 + [ptr],
        "romap_mx_planes_fwd": ([i32, ptr, i32, ptrs, ptrs] + [ints] * 3 + [ptr] * 3
                                + [i32] * 3 + [ptr]),
        "romap_mx_planes_bwd": ([i32] * 2 + [ptr] * 4 + [i32] * 2 + [ptrs] * 2 + [ints] * 3
                                + [i32] * 3 + [ptr]),
        "romap_mx_points_grad": ([i32] * 2 + [ptr] * 2 + [ints] * 2 + [i32] * 2 + [ptr, i32]
                                 + [ptrs] * 2 + [ints] * 3 + [ptr] * 4 + [i32] * 4 + [ptr]),
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = i32
    return lib


def kernel_path(spec: MXGridSpec) -> str:
    """The path of the spec under the current MX_FUSED (read at each call):
    "folded" (K1/K2), "unsnapped" (K3/K4), "folded_cp" (K5/K6),
    "unsnapped_cp" (K7/K8), "folded_split" (K5, K9 / K6, K10) or
    "unsnapped_split" (K7, K9 / K8, K10). Raises NotImplementedError for a
    spec no ported kernel covers."""
    n_planes = len(spec.plane_specs)
    snap = spec.snap_levels
    if n_planes == 0:
        return "folded_cp" if snap else "unsnapped_cp"
    if os.environ.get("MX_FUSED", "1") == "0":
        if n_planes > MAX_PLANE_LEVELS:
            raise NotImplementedError(
                f"K9/K10 take at most {MAX_PLANE_LEVELS} plane levels; this spec has "
                f"{n_planes}")
        return "folded_split" if snap else "unsnapped_split"
    if n_planes > 1:
        raise NotImplementedError(
            f"the fused CUDA encode (K1-K4) takes one plane level; this spec has "
            f"{n_planes} (MX_FUSED=0 selects the split kernels K9/K10, which take "
            "several; fused multi-level support is in ROADMAP.md)")
    return "folded" if snap else "unsnapped"


# The tensor-core backward's instantiations in mxgrid_folded.cu: (rfp, K,
# (line rows, channels) of the one plane level) with the plane level (K2:
# the flagship, `quality`), (rfp, K) CP-only (K6: the flagship's ladder,
# `fast`)
TC_SHAPES = {True: ((192, 48, (128, 4)), (256, 64, (128, 8))), False: ((192, 48), (256, 64))}
# (line rows, channels) of the one plane level the tensor-core K10
# instantiates in mxgrid_planes.cu: the flagship's and `quality`'s
PLANES_TC_SHAPES = ((128, 4), (128, 8))
SMEM_PER_BLOCK = 232448  # bytes of dynamic shared memory a block may take on sm_90
# the C side's variant codes; "tensor_core_split" (K4/K8 alone) takes fp32
# inputs, each operand split into a bf16 hi and lo part
BACKWARD_VARIANTS = ("scalar", "tensor_core", "tensor_core_split")
FORWARD_VARIANTS = ("direct", "staged")


def _plane_levels(spec: MXGridSpec, planes: bool) -> tuple:
    """(line rows, channels) of each plane level the kernel takes."""
    return tuple((max(ru, rv), kp) for ru, rv, kp in spec.plane_specs) if planes else ()


def folded_variant(spec: MXGridSpec, dtype: torch.dtype, planes: bool | None = None) -> str:
    """The variant of the folded backward for this spec and table dtype:
    "tensor_core" for bf16 at the shapes mxgrid_folded.cu instantiates
    (TC_SHAPES: the flagship's 192 x 48 with its (128, 64, 4) plane level,
    `quality`'s 256 x 64 with its (128, 128, 8) level, and CP-only 192 x 48
    and `fast`'s 256 x 64), "scalar" for fp32 and every other spec.
    `planes` says whether the kernel takes the plane level (K2) or not
    (K6); by default, whether the spec has one. Chosen from the spec and
    dtype alone; a failed build or launch never changes it."""
    if planes is None:
        planes = bool(spec.plane_specs)
    shape = (spec.fold_res[1], spec.features, *_plane_levels(spec, planes))
    return "tensor_core" if dtype == torch.bfloat16 and shape in TC_SHAPES[planes] else "scalar"


# (padded 16-row tiles the instantiation has room for, K, (line rows,
# channels) of the one plane level) of the unsnapped tensor-core backward in
# mxgrid_unsnapped.cu, per table dtype: with the plane level (K4: the
# flagship, `quality`) and CP-only (K8; no level). The flagship ladder pads
# to 31 tiles, `fast`'s and `quality`'s to 39. bf16 runs "tensor_core",
# fp32 "tensor_core_split" (UNSNAPPED_TC_VARIANT).
UNSNAPPED_TC_SHAPES = {
    torch.bfloat16: {True: ((32, 48, (128, 4)), (40, 64, (128, 8))), False: ((32, 48), (40, 64))},
    torch.float32: {True: ((32, 48, (128, 4)), (40, 64, (128, 8))), False: ((32, 48), (40, 64))},
}
UNSNAPPED_TC_VARIANT = {torch.bfloat16: "tensor_core", torch.float32: "tensor_core_split"}


def padded_row_map(spec: MXGridSpec) -> list[int]:
    """Rows of the unsnapped tensor-core backward's accumulator: every ladder
    level padded to a multiple of 16 rows, so that a 16-row tile lies in one
    level (`tile_rows` of mxgrid_unsnapped.cu). Entry i is the ladder row
    that accumulator row i is flushed to, or -1 for a pad row."""
    rows = []
    for res, off in zip(spec.resolutions, spec.offsets):
        rows += list(range(off, off + res)) + [-1] * (-res % 16)
    return rows


def padded_tiles(spec: MXGridSpec) -> int:
    """16-row tiles of that accumulator (`padded_tiles` of the same source)."""
    return sum(-(-res // 16) for res in spec.resolutions)


def unsnapped_variant(spec: MXGridSpec, dtype: torch.dtype, planes: bool | None = None) -> str:
    """The variant of the unsnapped backward for this spec and table dtype:
    on the tensor cores where mxgrid_unsnapped.cu has an instantiation for
    this dtype with this K and plane level and room for the ladder's padded
    tiles (UNSNAPPED_TC_SHAPES: the flagship ladder at K = 48 with its
    (128, 64, 4) plane level or CP-only; `quality`'s at K = 64 with its
    (128, 128, 8) level; `fast`'s at K = 64, CP-only) -- "tensor_core" in
    bf16, "tensor_core_split" in fp32 (each fp32 operand split into two bf16
    parts, three products) -- and "scalar" for every other spec. `planes`
    says whether the kernel takes the plane level (K4) or not (K8); by
    default, whether the spec has one. Chosen from the spec and dtype alone;
    a failed build or launch never changes it."""
    if planes is None:
        planes = bool(spec.plane_specs)
    shape = (spec.features, *_plane_levels(spec, planes))
    table = UNSNAPPED_TC_SHAPES.get(dtype, {}).get(planes, ())
    fits = any(padded_tiles(spec) <= room and shape == tuple(rest) for room, *rest in table)
    return UNSNAPPED_TC_VARIANT[dtype] if fits else "scalar"


def planes_variant(spec: MXGridSpec, dtype: torch.dtype) -> str:
    """The variant of the split path's plane backward K10 for this spec and
    table dtype: "tensor_core" for bf16 with one plane level whose (line
    rows, channels) mxgrid_planes.cu instantiates (PLANES_TC_SHAPES: the
    flagship's (128, 64, 4) level and `quality`'s (128, 128, 8)), "scalar"
    for fp32, for several levels and for every other level. Chosen from the
    spec and dtype alone; a failed build or launch never changes it."""
    levels = [(max(ru, rv), kp) for ru, rv, kp in spec.plane_specs]
    if dtype == torch.bfloat16 and len(levels) == 1 and levels[0] in PLANES_TC_SHAPES:
        return "tensor_core"
    return "scalar"


def _forward_smem(rows: int, spec: MXGridSpec, dtype: torch.dtype, planes: bool,
                  staged: bool, warps: int = 8) -> int:
    """Dynamic shared memory of a forward that stages `rows` table rows at
    an odd word stride, then (staged) 32 output rows for each of a block's
    `warps` warps: `launch_fwd` of mxgrid_folded.cu (rows 3 rfp, 8 warps)
    and `launch_fwd3` of mxgrid_unsnapped.cu (rows 3 total_res, 16 warps)."""
    elem = torch.empty((), dtype=dtype).element_size()
    words = -(-spec.features * elem // 4)
    row = (words + 1 - words % 2) * 4  # bytes of a table row
    table = rows * row
    kout = spec.features + (spec.plane_out_dims if planes else 0)
    return table + (-table % 16 + warps * 32 * kout * elem if staged else 0)


def forward_variant(spec: MXGridSpec, dtype: torch.dtype, planes: bool | None = None) -> str:
    """The variant of the folded forward (K1 with `planes`, K5 without):
    "staged" (a warp's feature rows collected in shared memory and stored
    as one contiguous run) wherever the rows fit a block's shared memory
    beside the table, else "direct" (each thread stores four channels a
    vector into its own row): the fp32 table of `fast` (199,680 B) leaves no
    room. Chosen from the spec and dtype alone."""
    if planes is None:
        planes = bool(spec.plane_specs)
    rows = 3 * spec.fold_res[1]
    fits = _forward_smem(rows, spec, dtype, planes, staged=True) <= SMEM_PER_BLOCK
    return "staged" if fits else "direct"


UNSNAPPED_FORWARD_VARIANTS = ("per_axis", "three_axis_direct", "three_axis_staged",
                              "channel_split")
FWD3_WARPS = 16  # kFwd3Threads / 32 of mxgrid_unsnapped.cu


def channel_split_smem(spec: MXGridSpec, dtype: torch.dtype, kc: int) -> int:
    """Dynamic shared memory of the channel-split forward (`launch_fwd3`
    with kSplit): kc channels of the three axes' ladders at an odd word
    stride, then 32 staged rows of kc channels for each of 16 warps."""
    elem = torch.empty((), dtype=dtype).element_size()
    words = -(-kc * elem // 4)
    table = 3 * spec.total_res * (words + 1 - words % 2) * 4
    return table + -table % 16 + FWD3_WARPS * 32 * kc * elem


def channel_split_width(spec: MXGridSpec, dtype: torch.dtype) -> int | None:
    """Channels a block of the channel-split forward holds: the widest slice
    kc (K a multiple of it, and of 4 channels, for the 16-byte stores) whose
    tables and staged rows fit a block's shared memory (fp32 flagship: 24,
    188,656 B; fp32 `fast`: 16, 151,088 B), or None where none does."""
    k = spec.features
    for kc in range(k, 0, -1):
        if k % kc == 0 and kc % 4 == 0 and channel_split_smem(spec, dtype, kc) <= SMEM_PER_BLOCK:
            return kc
    return None


def unsnapped_forward_variant(spec: MXGridSpec, dtype: torch.dtype,
                              planes: bool | None = None) -> str:
    """The variant of the unsnapped forward (K3 with `planes`, K7 without):
    "three_axis_staged" (a block holds the three axes' ladders, forms the
    factors and their product in registers and stages a warp's output rows)
    where the tables and the staged rows fit a block's shared memory;
    "three_axis_direct" (each thread stores its own row) where only the
    tables fit (K7 at `fast`'s ladder in bf16: 229,680 B); else
    "channel_split" (the same in slices of `channel_split_width` channels,
    a block a slice: the fp32 flagship ladder's three axes take 273,420 B)
    where a slice fits; else "per_axis" (a block an axis, then the product
    as a second pass). Chosen from the spec and dtype alone."""
    if planes is None:
        planes = bool(spec.plane_specs)
    rows = 3 * spec.total_res
    if min(spec.resolutions) < 2:  # a level's two rows j, j + 1 (`tap_pair`)
        return "per_axis"
    smem = lambda staged: _forward_smem(rows, spec, dtype, planes, staged, FWD3_WARPS)
    if smem(True) <= SMEM_PER_BLOCK:
        return "three_axis_staged"
    if smem(False) <= SMEM_PER_BLOCK:
        return "three_axis_direct"
    if channel_split_width(spec, dtype) is not None:
        return "channel_split"
    return "per_axis"


def _split_width(spec: MXGridSpec, dtype: torch.dtype, variant: str) -> int:
    """The `kc` argument of the unsnapped forward's C entries: the slice of
    "channel_split", else K (unread)."""
    if variant != "channel_split":
        return spec.features
    kc = channel_split_width(spec, dtype)
    if kc is None:
        raise RuntimeError(f"channel_split: no slice of {spec.features} channels fits a block")
    return kc


def _axes_code(spec: MXGridSpec) -> int:
    """The (u, v, w) axis of the three plane pairs, 2 bits each."""
    return sum(a << (2 * (3 * i + j))
               for i, pair in enumerate(spec.plane_axes) for j, a in enumerate(pair))


def _plane_dims(spec: MXGridSpec) -> tuple[int, int, int, int, int]:
    """(ru, rv, kp, rw, axes) of a one-plane-level spec."""
    (ru, rv, kp), = spec.plane_specs
    return ru, rv, kp, max(ru, rv), _axes_code(spec)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device,
           rows: bool = False) -> None:
    """Device, dtype and shape of `t`, and contiguity; with `rows`, a
    [O, P, n] tensor may also be a view of wider rows (unit stride in the
    last axis, the points one row stride apart), as the plane block of a
    cotangent is."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if rows:
        p, n = t.shape[1:]
        if t.stride(2) != 1 or t.stride(1) < n or t.stride(0) != p * t.stride(1):
            raise ValueError(f"{name}: strides {t.stride()} are not rows of one stride")
    elif not t.is_contiguous():
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


def _launch(wrapper, what: str, fn_name: str, dt: torch.dtype, dev, *args,
            variant: str | None = None) -> None:
    """Call the C entry point on the current stream of `dev`; raise on a
    refused launch (cudaError_t, e.g. 1 when a table does not fit shared
    memory), else count it (by dtype, and by dtype and `variant` where the
    wrapper names one)."""
    lib = _library()
    with torch.cuda.device(dev):
        code = getattr(lib, fn_name)(_DTYPE_CODE[dt], *args,
                                     torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
    dname = str(dt).split(".")[1]
    wrapper.launches += 1
    wrapper.launches_by_dtype[dname] += 1
    if variant is not None:
        wrapper.launches_by_variant[f"{dname} {variant}"] += 1


def _counted(fn):
    fn.launches = 0
    fn.launches_by_dtype = collections.Counter()
    fn.launches_by_variant = collections.Counter()
    return fn


def _ladder(spec: MXGridSpec):
    """(resolutions, offsets, count) of the CP ladder as ctypes arguments."""
    n = len(spec.resolutions)
    if n > MAX_LEVELS:
        raise NotImplementedError(
            f"K0, K3/K4 and K7/K8 take at most {MAX_LEVELS} ladder levels; this spec has {n}")
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
    """Every plane level (sequences `planes`, `plines`, one entry a level):
    (out blocks [O, P, kp] per level and pair, fpl, fli [O, 3 sum(kp), P])."""
    o, p = points.shape[:2]
    blocks, fpl, fli = [], [], []
    for (ru, rv, kp), pl, li in zip(spec.plane_specs, planes, plines):
        for i, (u, v, w) in enumerate(spec.plane_axes):
            hu = hat1(points[..., u], ru)
            hv = hat1(points[..., v], rv)
            t = torch.matmul(hu, pl[:, i].float().reshape(o, ru, rv * kp))
            f_pl = torch.sum(t.reshape(o, p, rv, kp) * hv[..., None], dim=2)
            f_li = torch.matmul(hat1(points[..., w], max(ru, rv)), li[:, i].float())
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
    blocks, fpl, fli = _planes_plain(points, (planes,), (plines,), spec, dt)
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


def _plane_grad_plain(points, fpl, fli, g, spec, g_off):
    """Per plane level, dplanes [O, 3, ru, rv, kp] and dplines [O, 3, rw, kp]
    (two lists), fp32; the plane block of `g` starts at column `g_off`."""
    o, p = points.shape[:2]
    g = g.float()
    dplanes, dplines = [], []
    row = 0
    for ru, rv, kp in spec.plane_specs:
        dpl, dli = [], []
        for u, v, w in spec.plane_axes:
            gi = g[..., g_off + row : g_off + row + kp]
            f_pl = fpl[:, row : row + kp].float().transpose(1, 2)
            f_li = fli[:, row : row + kp].float().transpose(1, 2)
            hw = hat1(points[..., w], max(ru, rv))
            dli.append(torch.matmul(hw.transpose(1, 2), gi * f_pl))
            hu = hat1(points[..., u], ru)
            hv = hat1(points[..., v], rv)
            q = (hv[..., None] * (gi * f_li)[:, :, None, :]).reshape(o, p, rv * kp)
            dpl.append(torch.matmul(hu.transpose(1, 2), q).reshape(o, ru, rv, kp))
            row += kp
        dplanes.append(torch.stack(dpl, dim=1))
        dplines.append(torch.stack(dli, dim=1))
    return dplanes, dplines


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
    variant = FORWARD_VARIANTS.index(forward_variant(spec, dt, planes=True))
    _launch(folded_fused_forward, "K1 folded_fused_forward", "romap_mx_folded_fwd", dt, dev,
            variant, points.data_ptr(), w_eff.data_ptr(), planes.data_ptr(), plines.data_ptr(),
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
    dplanes, dplines = _plane_grad_plain(points, fpl, fli, g, spec, spec.features)
    return dw, dplanes[0], dplines[0]


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
    variant = folded_variant(spec, dt, planes=True)
    _launch(folded_fused_backward, "K2 folded_fused_backward", "romap_mx_folded_bwd", dt, dev,
            BACKWARD_VARIANTS.index(variant), points.data_ptr(), afac.data_ptr(),
            fpl.data_ptr(), fli.data_ptr(), g.data_ptr(), dw.data_ptr(), dplanes.data_ptr(),
            dplines.data_ptr(), o, p, k, rf, rfp, ru, rv, kp, rw, axes, variant=variant)
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
    variant = unsnapped_forward_variant(spec, dt, planes=True)
    _launch(unsnapped_fused_forward, "K3 unsnapped_fused_forward", "romap_mx_unsnapped_fwd",
            dt, dev, UNSNAPPED_FORWARD_VARIANTS.index(variant), points.data_ptr(),
            lines.data_ptr(), planes.data_ptr(), plines.data_ptr(), out.data_ptr(),
            afac.data_ptr(), fpl.data_ptr(), fli.data_ptr(), res, off, n_lvl, o, p, k, total,
            ru, rv, kp, rw, axes, _split_width(spec, dt, variant))
    if variant == "per_axis":
        cp_product_pass(afac, out)
    return out, afac, fpl, fli


@_counted
def cp_product_pass(afac: torch.Tensor, out: torch.Tensor) -> None:
    """K3's second pass after its per-axis variant (the `cp_product` kernel
    of mxgrid_unsnapped.cu): out[..., :K] = A_0 A_1 A_2 from the factors
    afac [O, 3, K, P], in fp32, rounded once. CUDA tensors only: the plain
    twin forms the product inside `unsnapped_fused_forward_plain`."""
    dt, dev = afac.dtype, afac.device
    if not _on_card(afac, dt):
        raise ValueError("cp_product_pass launches a kernel: CUDA tensors only")
    o, _, k, p = afac.shape
    _check("afac", afac, (o, 3, k, p), dt, dev)
    _check("out", out, (o, p, out.shape[-1]), dt, dev)
    _launch(cp_product_pass, "cp_product_pass", "romap_mx_cp_product", dt, dev,
            afac.data_ptr(), out.data_ptr(), o, p, k, out.shape[-1])


def unsnapped_fused_backward_plain(points, afac, fpl, fli, g, spec: MXGridSpec):
    """Plain twin of K4 (`_fused_backward`): dlines [O, 3, total_res, K],
    dplanes and dplines, all f32."""
    dlines = _cp_grad_plain(points, afac, g, _ladder_basis(spec))
    dplanes, dplines = _plane_grad_plain(points, fpl, fli, g, spec, spec.features)
    return dlines, dplanes[0], dplines[0]


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
    variant = unsnapped_variant(spec, dt, planes=True)
    _launch(unsnapped_fused_backward, "K4 unsnapped_fused_backward",
            "romap_mx_unsnapped_bwd", dt, dev, BACKWARD_VARIANTS.index(variant), points.data_ptr(),
            afac.data_ptr(), fpl.data_ptr(), fli.data_ptr(), g.data_ptr(), dlines.data_ptr(),
            dplanes.data_ptr(), dplines.data_ptr(), res, off, n_lvl,
            o, p, k, total, ru, rv, kp, rw, axes, variant=variant)
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
    variant = FORWARD_VARIANTS.index(forward_variant(spec, dt, planes=False))
    _launch(folded_cp_forward, "K5 folded_cp_forward", "romap_mx_folded_cp_fwd", dt, dev,
            variant, points.data_ptr(), w_eff.data_ptr(), out.data_ptr(), afac.data_ptr(),
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
    variant = folded_variant(spec, dt, planes=False)
    _launch(folded_cp_backward, "K6 folded_cp_backward", "romap_mx_folded_cp_bwd", dt, dev,
            BACKWARD_VARIANTS.index(variant), points.data_ptr(), afac.data_ptr(),
            g.data_ptr(), dw.data_ptr(), o, p, k, rf, rfp, variant=variant)
    return dw


# --------------------------------------------------------------------------
# K7 / K8: unsnapped ladder, CP only
# --------------------------------------------------------------------------


def unsnapped_cp_forward_plain(points, lines, spec: MXGridSpec):
    """Plain twin of K7 (`_cp_forward` and the product formed after it,
    mxgrid_pallas.py:734-736): out [O, P, K] and the axis factors afac
    [O, 3, K, P] in the table dtype from the raw ladder lines
    [O, 3, total_res, K]; the product is (A_0 A_1) A_2 in the table dtype,
    rounded after each factor, as the reference forms it (`cp_product`)."""
    a = _cp_factors_plain(points, lines, _ladder_basis(spec)).to(lines.dtype)
    return a[:, 0] * a[:, 1] * a[:, 2], a.transpose(2, 3).contiguous()


@_counted
def unsnapped_cp_forward(points, lines, spec: MXGridSpec):
    """K7 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `unsnapped_cp_forward_plain`)."""
    dt = lines.dtype
    if not _on_card(points, dt):
        return unsnapped_cp_forward_plain(points, lines, spec)
    k, total = spec.features, spec.total_res
    res, off, n_lvl = _ladder(spec)
    dev = points.device
    o, p = points.shape[:2]
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check("lines", lines, (o, 3, total, k), dt, dev)
    out = torch.empty((o, p, k), dtype=dt, device=dev)
    afac = torch.empty((o, 3, k, p), dtype=dt, device=dev)
    variant = unsnapped_forward_variant(spec, dt, planes=False)
    _launch(unsnapped_cp_forward, "K7 unsnapped_cp_forward", "romap_mx_unsnapped_cp_fwd",
            dt, dev, UNSNAPPED_FORWARD_VARIANTS.index(variant), points.data_ptr(),
            lines.data_ptr(), out.data_ptr(), afac.data_ptr(), res, off, n_lvl, o, p, k,
            total, _split_width(spec, dt, variant))
    if variant == "per_axis":
        out = cp_product(afac)
    return out, afac


def unsnapped_cp_backward_plain(points, afac, g, spec: MXGridSpec):
    """Plain twin of K8 (`_bwd_cp_kernel`): dlines [O, 3, total_res, K] f32
    from the factors and the CP cotangent g [O, P, K]."""
    return _cp_grad_plain(points, afac, g, _ladder_basis(spec))


@_counted
def unsnapped_cp_backward(points, afac, g, spec: MXGridSpec):
    """K8 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `unsnapped_cp_backward_plain`)."""
    dt = afac.dtype
    if not _on_card(points, dt):
        return unsnapped_cp_backward_plain(points, afac, g, spec)
    k, total = spec.features, spec.total_res
    res, off, n_lvl = _ladder(spec)
    dev = points.device
    o, p = points.shape[:2]
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check("afac", afac, (o, 3, k, p), dt, dev)
    _check("g", g, (o, p, k), dt, dev)
    dlines = torch.zeros((o, 3, total, k), dtype=torch.float32, device=dev)
    variant = unsnapped_variant(spec, dt, planes=False)
    _launch(unsnapped_cp_backward, "K8 unsnapped_cp_backward", "romap_mx_unsnapped_cp_bwd",
            dt, dev, BACKWARD_VARIANTS.index(variant), points.data_ptr(), afac.data_ptr(),
            g.data_ptr(), dlines.data_ptr(), res, off, n_lvl, o, p, k, total, variant=variant)
    return dlines


# --------------------------------------------------------------------------
# K9 / K10: the split path's plane levels (MX_FUSED=0)
# --------------------------------------------------------------------------


def _level_args(spec: MXGridSpec, planes, plines):
    """(count, plane pointers, line pointers, ru, rv, kp) as ctypes
    arguments of the plane levels."""
    n = len(spec.plane_specs)
    if not 1 <= n <= MAX_PLANE_LEVELS:
        raise NotImplementedError(
            f"K9/K10 take 1 to {MAX_PLANE_LEVELS} plane levels; this spec has {n}")
    vp, ints = ctypes.c_void_p * n, ctypes.c_int * n
    return (n, vp(*(t.data_ptr() for t in planes)), vp(*(t.data_ptr() for t in plines)),
            *(ints(*col) for col in zip(*spec.plane_specs)))


def _check_levels(planes, plines, spec, o, dt, dev) -> None:
    if len(planes) != len(spec.plane_specs) or len(plines) != len(spec.plane_specs):
        raise ValueError(f"{len(planes)} planes / {len(plines)} plane lines for "
                         f"{len(spec.plane_specs)} plane levels")
    for lvl, ((ru, rv, kp), pl, li) in enumerate(zip(spec.plane_specs, planes, plines)):
        _check(f"planes[{lvl}]", pl, (o, 3, ru, rv, kp), dt, dev)
        _check(f"plines[{lvl}]", li, (o, 3, max(ru, rv), kp), dt, dev)


def planes_forward_plain(points, planes, plines, spec: MXGridSpec):
    """Plain twin of K9 (`_planes_forward`, then the product the reference
    forms after it, mxgrid_pallas.py:741).

    Args:
      points [O, P, 3] f32; planes, plines: one tensor a plane level,
      [O, 3, ru, rv, kp] and [O, 3, max(ru, rv), kp], one dtype.
    Returns:
      out [O, P, 3 sum(kp)]: the plane features, each the product of the two
      rounded samples in fp32, rounded to the table dtype (K9's arithmetic;
      equal to `plane_product(fpl, fli)`); fpl and fli [O, 3 sum(kp), P] in
      the table dtype, rows level-major, then pair, then channel
      (mxgrid_pallas.py:181-202).
    """
    dt = planes[0].dtype
    _, fpl, fli = _planes_plain(points, planes, plines, spec, dt)
    out = (fpl.float() * fli.float()).to(dt).transpose(1, 2).contiguous()
    return out, fpl, fli


@_counted
def planes_forward(points, planes, plines, spec: MXGridSpec):
    """K9 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `planes_forward_plain`)."""
    dt = planes[0].dtype
    if not _on_card(points, dt):
        return planes_forward_plain(points, planes, plines, spec)
    dev = points.device
    o, p = points.shape[:2]
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check_levels(planes, plines, spec, o, dt, dev)
    args = _level_args(spec, planes, plines)
    kpl = spec.plane_out_dims
    out = torch.empty((o, p, kpl), dtype=dt, device=dev)
    fpl = torch.empty((o, kpl, p), dtype=dt, device=dev)
    fli = torch.empty_like(fpl)
    _launch(planes_forward, "K9 planes_forward", "romap_mx_planes_fwd", dt, dev,
            points.data_ptr(), *args, out.data_ptr(), fpl.data_ptr(), fli.data_ptr(), o, p,
            _axes_code(spec))
    return out, fpl, fli


def planes_backward_plain(points, fpl, fli, g, spec: MXGridSpec):
    """Plain twin of K10 (`_make_bwd_planes_kernel`): from K9's residuals and
    the plane block of the cotangent g [O, P, 3 sum(kp)] (contiguous, or a
    view of the encode's full cotangent), per level dplanes
    [O, 3, ru, rv, kp] and dplines [O, 3, max(ru, rv), kp] (two tuples),
    f32."""
    dplanes, dplines = _plane_grad_plain(points, fpl, fli, g, spec, 0)
    return tuple(dplanes), tuple(dplines)


@_counted
def planes_backward(points, fpl, fli, g, spec: MXGridSpec):
    """K10 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `planes_backward_plain`). The card reads g in place: its rows may be
    wider than 3 sum(kp) (the split step passes `g[..., K:]` of the full
    cotangent). Variant: `planes_variant`."""
    dt = fpl.dtype
    if not _on_card(points, dt):
        return planes_backward_plain(points, fpl, fli, g, spec)
    dev = points.device
    o, p = points.shape[:2]
    kpl = spec.plane_out_dims
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check("fpl", fpl, (o, kpl, p), dt, dev)
    _check("fli", fli, (o, kpl, p), dt, dev)
    _check("g", g, (o, p, kpl), dt, dev, rows=True)
    f32 = dict(dtype=torch.float32, device=dev)
    dplanes = tuple(torch.zeros((o, 3, ru, rv, kp), **f32) for ru, rv, kp in spec.plane_specs)
    dplines = tuple(torch.zeros((o, 3, max(ru, rv), kp), **f32)
                    for ru, rv, kp in spec.plane_specs)
    n, pl_ptrs, li_ptrs, ru, rv, kp = _level_args(spec, dplanes, dplines)
    variant = planes_variant(spec, dt)
    _launch(planes_backward, "K10 planes_backward", "romap_mx_planes_bwd", dt, dev,
            BACKWARD_VARIANTS.index(variant), points.data_ptr(), fpl.data_ptr(),
            fli.data_ptr(), g.data_ptr(), g.stride(1), n, pl_ptrs, li_ptrs, ru, rv, kp, o, p,
            _axes_code(spec), variant=variant)
    return dplanes, dplines


@_counted
def cp_product(afac: torch.Tensor) -> torch.Tensor:
    """CP features [O, P, K] from the factors [O, 3, K, P]: (A_0 A_1) A_2 in
    the table dtype, rounded after each factor, as the reference forms them
    after its split CP kernel (mxgrid_pallas.py:736). K7's per-axis variant
    needs it; its calls are counted as a kernel's launches are."""
    cp_product.launches += 1
    cp_product.launches_by_dtype[str(afac.dtype).split(".")[1]] += 1
    return (afac[:, 0] * afac[:, 1] * afac[:, 2]).transpose(1, 2).contiguous()


def plane_product(fpl: torch.Tensor, fli: torch.Tensor) -> torch.Tensor:
    """Plane features [O, P, 3 sum(kp)]: f_pl f_li in the table dtype, as the
    reference forms them after K9's counterpart (mxgrid_pallas.py:741). K9
    writes the same values itself; the tests hold it to this."""
    return (fpl * fli).transpose(1, 2).contiguous()


# --------------------------------------------------------------------------
# K0: the points gradient (pose refinement)
# --------------------------------------------------------------------------


def _slope1(x: torch.Tensor, r: int) -> torch.Tensor:
    """[...] coords -> [..., r] d hat1/dx at the two knots `tent_taps`
    keeps: -(r-1) at floor(t), r-1 at floor(t) + 1 (t = x (r-1)), 0 where
    a knot is out of [0, r-1] or t out of reach (`tent_slopes`). Away from
    the knots this equals autograd of `hat1`."""
    t = x * (r - 1)
    f = torch.floor(t)[..., None]
    i = torch.arange(r, dtype=x.dtype, device=x.device)
    reach = ((t > -1) & (t < r))[..., None]
    return (r - 1) * reach * ((i == f + 1).to(x.dtype) - (i == f).to(x.dtype))


def on_a_knot(points: torch.Tensor, spec: MXGridSpec) -> torch.Tensor:
    """[O, P] bool: a coordinate of the point lies on a knot of a tent the
    encode reads (x (r-1) an integer, in fp32). The encode has no derivative
    there; K0 takes the slope to the right, autograd of the plain encode
    the sum of both sides, JAX's autodiff of its tent 0, so comparisons of
    the points' gradient leave these points out (a few in 10^5 uniform fp32
    points)."""
    rs = {spec.fold_res[0]} if spec.snap_levels else set(spec.resolutions)
    rs |= {r for ru, rv, _ in spec.plane_specs for r in (ru, rv, max(ru, rv))}
    hit = torch.zeros(points.shape[:-1], dtype=torch.bool, device=points.device)
    for r in rs:
        t = points * (r - 1)
        hit |= (t == torch.floor(t)).any(dim=-1)
    return hit


def _cp_slope_basis(spec: MXGridSpec):
    """x -> [..., rows] slopes of the CP basis: the folded one (rf knots,
    padded to rfp) or the concatenated ladder."""
    if spec.snap_levels:
        rf, rfp = spec.fold_res
        return lambda x: torch.nn.functional.pad(_slope1(x, rf), (0, rfp - rf))
    return lambda x: torch.cat([_slope1(x, r) for r in spec.resolutions], dim=-1)


POINTS_VARIANTS = ("per_point", "lanes_over_channels")  # the C side's variant codes


PTS_TILE = 64  # kPtsTile of mxgrid_points.cu


def points_smem(spec: MXGridSpec, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the lanes-over-channels K0 (`LanesSmem` of
    mxgrid_points.cu): two stages of a 64-point tile's cotangent rows, 3K
    factor rows, 2 sum(kp) plane residual rows (16-byte aligned each) and
    points, then u_d [3, 64, K rounded to an odd number of 16-byte words],
    the plane values [2, 64, sum 3 kp | 1] and the taps [3, 3 L, 64]."""
    elem = torch.empty((), dtype=dtype).element_size()
    k, kpl, t = spec.features, spec.plane_out_dims, PTS_TILE
    n_lv = 1 if spec.snap_levels else len(spec.resolutions)
    a16 = lambda n: -(-n // 16) * 16
    stage = a16(t * (k + kpl) * elem) + a16(3 * k * t * elem) + a16(2 * kpl * t * elem) + t * 12
    quads = -(-k // 4)
    us = 4 * (quads + 1 - quads % 2)
    words = 3 * t * us + 2 * t * (kpl | 1) + 3 * 3 * n_lv * t + 3 * t
    return 2 * stage + 4 * words


def points_variant(spec: MXGridSpec, dtype: torch.dtype) -> str:
    """The variant of K0 for this spec and table dtype: "lanes_over_channels"
    (64-point tiles staged by double-buffered cp.async, u_d = g A_e A_f
    formed once a point, then 8 lanes a point over channel quads, each table
    row and plane corner read as vectors) wherever K is a multiple of 4 and
    its shared memory (`points_smem`) fits a block (every shipped preset),
    else "per_point" (one point a thread, the first design). Chosen from the
    spec and dtype alone."""
    if spec.features % 4 == 0 and points_smem(spec, dtype) <= SMEM_PER_BLOCK:
        return "lanes_over_channels"
    return "per_point"


def points_gradient_plain(points, table, afac, planes, plines, fpl, fli, g,
                          spec: MXGridSpec) -> torch.Tensor:
    """Plain twin of K0: d loss / d points [O, P, 3] f32 of the encode.

    Args:
      points [O, P, 3] f32; table: W_eff [O, 3, rfp, K] (folded spec) or
      the ladder lines [O, 3, total_res, K]; afac [O, 3, K, P]; planes,
      plines: one tensor a plane level (empty for CP only); fpl, fli
      [O, 3 sum(kp), P] or None; g [O, P, K + 3 sum(kp)]: the forward's
      residuals and the encode's cotangent, one dtype.
    The residuals are taken as stored (their roundings as the identity);
    sums are fp32.
    """
    o, p = points.shape[:2]
    k = spec.features
    g = g.float()
    a = afac.float().transpose(2, 3)  # [O, 3, P, K]
    slope = _cp_slope_basis(spec)
    others = ((1, 2), (0, 2), (0, 1))
    cols = [torch.sum(g[..., :k] * a[:, e] * a[:, f]
                      * torch.matmul(slope(points[..., d]), table[:, d].float()), dim=-1)
            for d, (e, f) in enumerate(others)]
    dx = torch.stack(cols, dim=-1)
    row = 0
    for (ru, rv, kp), pl, li in zip(spec.plane_specs, planes, plines):
        for i, (u, v, w) in enumerate(spec.plane_axes):
            gi = g[..., k + row : k + row + kp]
            f_pl = fpl[:, row : row + kp].float().transpose(1, 2)
            f_li = fli[:, row : row + kp].float().transpose(1, 2)
            pmat = pl[:, i].float().reshape(o, ru, rv * kp)
            hu, hv = hat1(points[..., u], ru), hat1(points[..., v], rv)
            su, sv = _slope1(points[..., u], ru), _slope1(points[..., v], rv)
            t_s = torch.matmul(su, pmat).reshape(o, p, rv, kp)
            t_h = torch.matmul(hu, pmat).reshape(o, p, rv, kp)
            dpl_u = torch.sum(t_s * hv[..., None], dim=2)
            dpl_v = torch.sum(t_h * sv[..., None], dim=2)
            dli_w = torch.matmul(_slope1(points[..., w], max(ru, rv)), li[:, i].float())
            dx[..., u] += torch.sum(gi * f_li * dpl_u, dim=-1)
            dx[..., v] += torch.sum(gi * f_li * dpl_v, dim=-1)
            dx[..., w] += torch.sum(gi * f_pl * dli_w, dim=-1)
            row += kp
    return dx


@_counted
def points_gradient(points, table, afac, planes, plines, fpl, fli, g,
                    spec: MXGridSpec) -> torch.Tensor:
    """K0 on a CUDA tensor, its plain twin on a CPU tensor (same contract as
    `points_gradient_plain`)."""
    dt = afac.dtype
    if not _on_card(points, dt):
        return points_gradient_plain(points, table, afac, planes, plines, fpl, fli, g, spec)
    k, n_pl = spec.features, len(spec.plane_specs)
    if spec.snap_levels:
        (rf, rows), n_lvl = spec.fold_res, 1
        res, off = (ctypes.c_int * 1)(rf), (ctypes.c_int * 1)(0)
    else:
        res, off, n_lvl = _ladder(spec)
        rows = spec.total_res
    dev = points.device
    o, p = points.shape[:2]
    kpl = spec.plane_out_dims
    _check("points", points, (o, p, 3), torch.float32, dev)
    _check("table", table, (o, 3, rows, k), dt, dev)
    _check("afac", afac, (o, 3, k, p), dt, dev)
    _check("g", g, (o, p, k + kpl), dt, dev)
    if n_pl:
        _check_levels(planes, plines, spec, o, dt, dev)
        _check("fpl", fpl, (o, kpl, p), dt, dev)
        _check("fli", fli, (o, kpl, p), dt, dev)
        n, pl_ptrs, li_ptrs, ru, rv, kp = _level_args(spec, planes, plines)
        fpl_ptr, fli_ptr = fpl.data_ptr(), fli.data_ptr()
    else:
        n, pl_ptrs, li_ptrs, ru, rv, kp = 0, None, None, None, None, None
        fpl_ptr = fli_ptr = None
    dpts = torch.empty((o, p, 3), dtype=torch.float32, device=dev)
    variant = POINTS_VARIANTS.index(points_variant(spec, dt))
    _launch(points_gradient, "K0 points_gradient", "romap_mx_points_grad", dt, dev,
            variant, points.data_ptr(), table.data_ptr(), res, off, n_lvl, rows, afac.data_ptr(),
            n, pl_ptrs, li_ptrs, ru, rv, kp, fpl_ptr, fli_ptr, g.data_ptr(),
            dpts.data_ptr(), o, p, k, _axes_code(spec))
    return dpts


KERNELS = {
    "K0": points_gradient,
    "K1": folded_fused_forward, "K2": folded_fused_backward,
    "K3": unsnapped_fused_forward, "K4": unsnapped_fused_backward,
    "K5": folded_cp_forward, "K6": folded_cp_backward,
    "K7": unsnapped_cp_forward, "K8": unsnapped_cp_backward,
    "K9": planes_forward, "K10": planes_backward,
}


# the product passes the per-axis unsnapped forwards need after K3 / K7
PRODUCT_PASSES = {"cp_product_pass": cp_product_pass, "cp_product": cp_product}


def reset_launch_counts() -> None:
    for fn in (*KERNELS.values(), *PRODUCT_PASSES.values()):
        fn.launches = 0
        fn.launches_by_dtype.clear()
        fn.launches_by_variant.clear()


# --------------------------------------------------------------------------
# The differentiable encode
# --------------------------------------------------------------------------


class _Encode(torch.autograd.Function):
    """Forward: fold the lines (one einsum) where the spec snaps, then the
    forward kernels of `path`; on a split path, the CP product (K5, K7 or
    `cp_product`) joined to K9's plane features. Backward: the backward
    kernels (K10 reads the cotangent's plane block in place), then the
    transposed fold, as JAX does around its kernels (mxgrid_pallas.py:
    490-493, 538-544, 724-875),
    where the tables need a gradient; K0 where the points need one (then
    the forward also keeps its table, planes and plane lines).
    `tables` are the planes, then the plane lines, one tensor a level."""

    @staticmethod
    def forward(ctx, points, spec, path, lines, *tables):
        n_lvl = len(spec.plane_specs)
        planes = [t.contiguous() for t in tables[:n_lvl]]
        plines = [t.contiguous() for t in tables[n_lvl:]]
        table = (fold_lines(lines, spec) if spec.snap_levels else lines).contiguous()
        if path == "unsnapped":
            out, *res = unsnapped_fused_forward(points, table, planes[0], plines[0], spec)
        elif path == "folded":
            out, *res = folded_fused_forward(points, table, planes[0], plines[0], spec)
        else:  # CP kernel, then (split path) the plane levels
            if spec.snap_levels:
                out, afac = folded_cp_forward(points, table, spec)
            else:
                out, afac = unsnapped_cp_forward(points, table, spec)
            res = [afac]
            if n_lvl:
                out_pl, fpl, fli = planes_forward(points, planes, plines, spec)
                out = torch.cat([out, out_pl], dim=-1)
                res += [fpl, fli]
        kept = [table, *planes, *plines] if ctx.needs_input_grad[0] else []
        ctx.save_for_backward(points, *res, *kept)
        ctx.spec, ctx.path, ctx.n_res = spec, path, len(res)
        return out

    @staticmethod
    def backward(ctx, g):
        points, *saved = ctx.saved_tensors
        res, kept = saved[: ctx.n_res], saved[ctx.n_res :]
        spec, dt = ctx.spec, res[0].dtype
        g = g.to(dt).contiguous()
        dpts = None
        if ctx.needs_input_grad[0]:
            n_lvl = len(spec.plane_specs)
            table, planes, plines = kept[0], kept[1 : 1 + n_lvl], kept[1 + n_lvl :]
            fpl, fli = (res[1], res[2]) if n_lvl else (None, None)
            dpts = points_gradient(points, table, res[0], planes, plines, fpl, fli, g, spec)
        if not any(ctx.needs_input_grad[3:]):
            return (dpts, None, None, None, *(None,) * 2 * len(spec.plane_specs))
        if ctx.path == "folded":
            dw, dplanes, dplines = folded_fused_backward(points, *res, g, spec)
            dlines, dplanes, dplines = unfold_dlines(dw, spec, dt), [dplanes], [dplines]
        elif ctx.path == "unsnapped":
            dlines, dplanes, dplines = unsnapped_fused_backward(points, *res, g, spec)
            dplanes, dplines = [dplanes], [dplines]
        else:
            k = spec.features
            g_cp = g[..., :k].contiguous() if spec.plane_specs else g
            if spec.snap_levels:
                dlines = unfold_dlines(folded_cp_backward(points, res[0], g_cp, spec), spec, dt)
            else:
                dlines = unsnapped_cp_backward(points, res[0], g_cp, spec)
            dplanes, dplines = (planes_backward(points, res[1], res[2], g[..., k:], spec)
                                if spec.plane_specs else ((), ()))
        return (dpts, None, None, dlines.to(dt), *(t.to(dt) for t in dplanes),
                *(t.to(dt) for t in dplines))


def encode(factors, p: torch.Tensor, spec: MXGridSpec) -> torch.Tensor:
    """Differentiable encode through the kernels `kernel_path` selects (their
    twins on the CPU); see the module docstring.

    Args:
      factors: lines [O, 3, total_res, K] (CP only) or {"lines", "planes":
        tuple of [O, 3, ru, rv, kp], "plane_lines": tuple of
        [O, 3, max(ru, rv), kp]}, one dtype (float32 or bfloat16).
      p: [O, ..., 3] points in the unit cube.
    Returns:
      [O, ..., n_output_dims] features in the parameter dtype. Gradients
      reach the tables (the backward kernels) and the points (K0).
    """
    path = kernel_path(spec)
    o, batch_shape = p.shape[0], p.shape[1:-1]
    pts = p.reshape(o, -1, 3).float().contiguous()
    if isinstance(factors, dict):
        lines, tables = factors["lines"], (*factors["planes"], *factors["plane_lines"])
    else:
        lines, tables = factors, ()
    out = _Encode.apply(pts, spec, path, lines, *tables)
    return out.reshape(o, *batch_shape, spec.n_output_dims)
