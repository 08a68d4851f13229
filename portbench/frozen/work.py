"""Frozen work counts: the bytes and operations an encode call needs, and
the card's peaks they are held to.

`work` and `points_work` are copies of `chip_smoke.work` and
`chip_smoke.points_work` (`PRODUCTS`, the peaks and `bound` with them),
unchanged but for taking the sizes from `Sizes`, which the benchmark builds
from its configuration file, in place of the program's spec. `hash_work`
is new: the same rule for the tiny-cuda-nn hash grid. The rule: each input
byte read once, each output byte written once; a multiply and an add count
as two operations.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
3.35 TB/s of HBM, 67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s
bf16 on them.
"""

from __future__ import annotations

import dataclasses

PEAK_BYTES_PER_S, PEAK_FP32_PER_S = 3.35e12, 67e12
PEAK_BF16_PER_S = 989e12
PRODUCTS = ("K1", "K3", "K9")  # forward kernels that write the plane features


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The MX-grid sizes `work` reads, under the program spec's names."""

    resolutions: tuple[int, ...]
    features: int
    plane_specs: tuple[tuple[int, int, int], ...]
    snap_levels: bool

    @property
    def total_res(self) -> int:
        return sum(self.resolutions)

    @property
    def plane_out_dims(self) -> int:
        return 3 * sum(k for _, _, k in self.plane_specs)

    @property
    def fold_res(self) -> tuple[int, int]:
        rf = max(self.resolutions)
        return rf, ((rf + 15) // 16) * 16


def _itemsize(dtype) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[str(dtype).replace("torch.", "")]


def work(kernel, spec, dtype, o, p):
    """(bytes, fp32 operations) of one call of `kernel`'s function on O x P
    points: each input read once and each output written once; a multiply
    and an add count as two operations (two per tap of a lerp, twelve per
    plane pair and channel forward, a thirteenth where the kernel writes
    their product, eighteen backward)."""
    t = _itemsize(dtype)
    k, kpl, n = spec.features, spec.plane_out_dims, o * p
    folded = kernel in ("K1", "K2", "K5", "K6")
    taps = 2 if folded else 2 * len(spec.resolutions)
    cp = kernel not in ("K9", "K10")
    pl = kernel in ("K1", "K2", "K3", "K4", "K9", "K10")
    cp_tab = 3 * (spec.fold_res[1] if folded else spec.total_res) * k if cp else 0
    pl_tab = sum(3 * (ru * rv + max(ru, rv)) * kp for ru, rv, kp in spec.plane_specs) if pl else 0
    pts = 12 * n
    if kernel in ("K1", "K3", "K5", "K7", "K9"):
        out_cols = (k if kernel in ("K1", "K3", "K5") else 0) + (kpl if kernel in PRODUCTS else 0)
        res_cols = (3 * k if cp else 0) + (2 * kpl if pl else 0)
        nbytes = pts + o * t * (cp_tab + pl_tab) + n * t * (out_cols + res_cols)
        ops = ((6 * k * taps if cp else 0) + (2 * k if kernel in ("K1", "K3", "K5") else 0)
               + (kpl * (12 + (kernel in PRODUCTS)) if pl else 0))
    else:
        in_cols = (4 * k if cp else 0) + (3 * kpl if pl else 0)  # residuals + cotangent
        nbytes = pts + n * t * in_cols + o * 4 * (cp_tab + pl_tab)
        ops = (k * (6 + 6 * taps) if cp else 0) + (18 * kpl if pl else 0)
    return nbytes, ops * n


def points_work(spec, dtype, o, p):
    """(bytes, fp32 operations) of K0 on O x P points (the points'
    gradient in pose refinement)."""
    t = _itemsize(dtype)
    k, kpl, n = spec.features, spec.plane_out_dims, o * p
    folded = spec.snap_levels
    taps = 2 if folded else 2 * len(spec.resolutions)
    cp_tab = 3 * (spec.fold_res[1] if folded else spec.total_res) * k
    pl_tab = sum(3 * (ru * rv + max(ru, rv)) * kp for ru, rv, kp in spec.plane_specs)
    nbytes = 24 * n + n * t * (3 * k + k + kpl + 2 * kpl) + o * t * (cp_tab + pl_tab)
    return nbytes, n * (3 * (2 * taps * k + 4 * k) + 30 * kpl)


def hash_work(direction, n_levels, n_features, table_rows, dtype, o, p):
    """(bytes, fp32 operations) of the hash-grid encode on O x P points.
    Forward: the points (12 B) and each object's table read once, the
    features written once; per level and point, 8 corners of F blended
    (2 operations each), 8 trilinear weights of 2 products, and the cell's
    position (2 operations an axis). Backward: the points and the features'
    cotangent read once, the fp32 table gradient written once; the same
    weights and 2 operations per corner and feature."""
    t = _itemsize(dtype)
    n = o * p
    per_level = 8 * n_features * 2 + 8 * 2 + 3 * 2
    if direction == "forward":
        nbytes = 12 * n + o * table_rows * n_features * t + n * n_levels * n_features * t
    else:
        nbytes = 12 * n + n * n_levels * n_features * t + o * table_rows * n_features * 4
    return nbytes, n * n_levels * per_level


def least_seconds(nbytes, ops) -> float:
    """The least time the card could take: bytes over its memory rate or
    fp32 operations over its peak, the larger."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S)
