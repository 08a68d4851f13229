"""The port's CUDA runtime: build, load, check, launch and launch counts.

It knows no kernel family: each family's module (`mxgrid_cuda` K0-K10,
`hashgrid_cuda` H0-H2, `optimizer_cuda` A1) declares its own C entries,
counts its wrappers and registers its kernels here, so a new family takes
its `.cu` under `csrc/` and its own module. csrc/*.cu build with nvcc into
one library with a plain C interface at the first launch (never at import),
under `build/romap_tpu_torch/`, keyed on a hash of the sources and flags.
No failure of the build or of a launch is caught. The launch counts say
what ran: a CUDA graph's capture takes its launches off
(`recorded_launches`) and each replay counts them again.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "romap_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # each C entry's first argument


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
    nvcc, flags = _find_nvcc(), [f for f in NVCC_FLAGS if f != "-shared"]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
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


_ARGTYPES: dict[str, list] = {}  # C entry -> its argtypes, as the families declare them
_lib: ctypes.CDLL | None = None


def _bind(lib: ctypes.CDLL, argtypes: dict[str, list]) -> None:
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int  # a cudaError_t code


def declare(argtypes: dict[str, list]) -> None:
    """A family's C entries: {entry: argtypes, the dtype code first and the
    stream last}; bound at once where the library is already loaded."""
    _ARGTYPES.update(argtypes)
    if _lib is not None:
        _bind(_lib, argtypes)


def library() -> ctypes.CDLL:
    """The built library, loaded once, every declared entry bound."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        _bind(lib, _ARGTYPES)
        _lib = lib
    return _lib


def on_card(t: torch.Tensor, dt: torch.dtype) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain twin)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if dt not in DTYPE_CODE:
        raise ValueError(f"table dtype {dt} not supported (float32, bfloat16)")
    return True


def check(name: str, t: torch.Tensor, shape: tuple, dtype, device,
          rows: bool = False, align: int | None = None) -> None:
    """Device, dtype and shape of `t`, and contiguity; with `rows`, a
    [O, P, n] tensor may also be a view of wider rows (unit stride in the
    last axis, the points one row stride apart), as the plane block of a
    cotangent is; with `align`, a data pointer on a multiple of that many
    bytes (what the kernel moves in one access)."""
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
    if align and t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer {t.data_ptr():#x} is not {align}-byte aligned")


def launch(wrapper, what: str, fn_name: str, dt: torch.dtype, dev, *args,
           variant: str | None = None) -> None:
    """Call the C entry point on the current stream of `dev`; raise on a
    refused launch (cudaError_t, e.g. 1 when a table does not fit shared
    memory), else count it on `wrapper` (by dtype, and by dtype and
    `variant` where the wrapper names one)."""
    lib = library()
    with torch.cuda.device(dev):
        code = getattr(lib, fn_name)(DTYPE_CODE[dt], *args,
                                     torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
    dname = str(dt).split(".")[1]
    wrapper.launches += 1
    wrapper.launches_by_dtype[dname] += 1
    if variant is not None:
        wrapper.launches_by_variant[f"{dname} {variant}"] += 1


_COUNTED: list = []  # every counted wrapper, zeroed together
_FAMILIES: dict[int, dict] = {}  # rank -> {kernel name: wrapper}


def counted(fn):
    """Give a wrapper its counters: `launches`, `launches_by_dtype` (e.g.
    {"bfloat16": 3}) and `launches_by_variant` ({"float32 scalar": 2})."""
    fn.launches = 0
    fn.launches_by_dtype = collections.Counter()
    fn.launches_by_variant = collections.Counter()
    _COUNTED.append(fn)
    return fn


def register(kernels: dict, rank: int) -> dict:
    """List a family's kernels {name: counted wrapper} in `launch_counts` at
    `rank` (the MX-grid 0, the hash grid 1, the optimizer 2), whichever
    family was imported first. Returns `kernels`."""
    _FAMILIES[rank] = kernels
    return kernels


class LaunchRecord:
    """The launches one stretch of code counted (`recorded_launches`),
    taken off the counters; `add(times)` counts them again that many times.
    A CUDA graph's capture enqueues no kernel and each replay runs every
    kernel it captured, so the counters keep saying what ran."""

    def __init__(self):
        self._before = {fn: (fn.launches, collections.Counter(fn.launches_by_dtype),
                             collections.Counter(fn.launches_by_variant)) for fn in _COUNTED}
        self._delta: list = []  # (wrapper, launches, by dtype, by variant)

    def _close(self) -> None:
        none = (0, collections.Counter(), collections.Counter())
        for fn in _COUNTED:
            n, by_dtype, by_variant = self._before.get(fn, none)
            delta = (fn.launches - n, fn.launches_by_dtype - by_dtype,
                     fn.launches_by_variant - by_variant)
            if delta[0]:
                self._delta.append((fn, *delta))
        self.add(-1)

    def add(self, times: int = 1) -> None:
        for fn, n, by_dtype, by_variant in self._delta:
            fn.launches += n * times
            for counter, delta in ((fn.launches_by_dtype, by_dtype),
                                   (fn.launches_by_variant, by_variant)):
                for k, v in delta.items():
                    counter[k] += v * times
                    if not counter[k]:
                        del counter[k]


@contextlib.contextmanager
def recorded_launches():
    """A `LaunchRecord` of the launches counted inside the block."""
    rec = LaunchRecord()
    try:
        yield rec
    finally:
        rec._close()


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
        fn.launches_by_dtype.clear()
        fn.launches_by_variant.clear()


def launch_counts() -> dict[str, int]:
    """{kernel: launches since the last reset}, the families in rank order."""
    return {k: fn.launches for rank in sorted(_FAMILIES) for k, fn in _FAMILIES[rank].items()}
