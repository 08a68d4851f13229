"""Multiresolution hash-grid encoding (instant-ngp / tiny-cuda-nn HashGrid
semantics): the spec, the table's init, the corner arithmetic and `encode`
(counterpart of romap_tpu/ops/hashgrid.py:39-174, its gather path).

Per level l: scale_l = 2^(l log2 b) Nmin - 1, resolution ceil(scale_l) + 1,
pos = x scale_l + 0.5, cell = floor(pos), frac = pos - cell; the level
holds next_multiple(min(T, res^3), 8) rows; a corner's row is
cx + cy res + cz res^2 where res^3 fits, else the hash
cx ^ (cy 2654435761) ^ (cz 805459861), both in uint32 arithmetic, then
modulo the level size; the 8 corners are blended trilinearly. All levels
live in one [total_params, F] table per object.

Here the reference's uint32 arithmetic is done in int64 and masked to 32
bits; a product by a 32-bit prime is split into its high and low 16 bits so
that no int64 product overflows (`corner_rows`). `encode` is one autograd
node whose forward, table gradient and points gradient are picked by the
points' device (`ops/hashgrid_cuda.py`): a CUDA tensor launches the
kernels H1, H2 and H0 (csrc/hashgrid.cu) or raises, a CPU tensor takes
their plain PyTorch twins, built on `corner_rows`. The reference's
`impl="sorted"` (a workaround for the TPU's serialised scatter-adds) is not
ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from romap_tpu_torch.config import EncodingConfig

_PRIME_Y = 2654435761
_PRIME_Z = 805459861
_MASK32 = 0xFFFFFFFF


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static layout of the concatenated level tables; fields equal
    romap_tpu.ops.hashgrid.HashGridSpec (the parity tests compare them)."""

    n_levels: int
    n_features: int
    scales: tuple[float, ...]  # scale_l (grid units)
    resolutions: tuple[int, ...]
    sizes: tuple[int, ...]  # entries per level
    offsets: tuple[int, ...]  # row offset of each level in the big table
    total_params: int  # total rows

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features


def make_spec(cfg: EncodingConfig) -> HashGridSpec:
    max_size = 1 << cfg.log2_hashmap_size
    log2_b = math.log2(cfg.per_level_scale)
    scales, resolutions, sizes, offsets = [], [], [], []
    offset = 0
    for lvl in range(cfg.n_levels):
        scale = math.pow(2.0, lvl * log2_b) * cfg.base_resolution - 1.0
        res = int(math.ceil(scale)) + 1
        dense = res**3 if res < 2048 else max_size + 1  # avoid overflow blowups
        size = _next_multiple(min(max_size, dense), 8)
        scales.append(scale)
        resolutions.append(res)
        sizes.append(size)
        offsets.append(offset)
        offset += size
    return HashGridSpec(
        n_levels=cfg.n_levels, n_features=cfg.n_features_per_level, scales=tuple(scales),
        resolutions=tuple(resolutions), sizes=tuple(sizes), offsets=tuple(offsets),
        total_params=offset,
    )


def init_table(generator: torch.Generator, spec: HashGridSpec, n_objects: int,
               device="cpu") -> torch.Tensor:
    """[O, total_params, F] fp32 drawn U[-1e-4, 1e-4] from `generator` (on
    its device), as tcnn's hash-table init (different numbers from JAX's)."""
    u = torch.rand((n_objects, spec.total_params, spec.n_features), generator=generator,
                   device=generator.device, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * 1e-4).to(device)


# the 8 corner offsets of a cell: corner c has bit d set along axis d
CORNERS = [[(c >> d) & 1 for d in range(3)] for c in range(8)]


def _times_prime(c: torch.Tensor, prime: int) -> torch.Tensor:
    """(c * prime) mod 2^32 for int64 c in [0, 2^32), without overflow."""
    hi, lo = prime >> 16, prime & 0xFFFF
    return ((((c * hi) & 0xFFFF) << 16) + c * lo) & _MASK32


def corner_rows(p: torch.Tensor, spec: HashGridSpec):
    """Points [N, 3] -> (rows [N, L, 8] int64 into the level-concatenated
    table, per-axis weights [N, L, 8, 3] fp32: frac_d where corner c has bit
    d set, else 1 - frac_d; the trilinear weight is their product in the
    order (x y) z, `trilinear`)."""
    corners = torch.tensor(CORNERS, dtype=torch.int64, device=p.device)  # [8, 3]
    bits = corners.bool()
    rows, weights = [], []
    for scale, res, size, offset in zip(spec.scales, spec.resolutions, spec.sizes,
                                        spec.offsets):
        pos = p.float() * torch.tensor(scale, dtype=torch.float32) + 0.5
        cell = torch.floor(pos)
        frac = pos - cell  # [N, 3]
        cu = (cell.long()[:, None, :] + corners) & _MASK32  # [N, 8, 3], as uint32
        cx, cy, cz = cu.unbind(-1)
        if res**3 <= size:
            idx = (cx + cy * res + cz * (res * res)) & _MASK32
        else:
            idx = cx ^ _times_prime(cy, _PRIME_Y) ^ _times_prime(cz, _PRIME_Z)
        rows.append(idx % size + offset)
        weights.append(torch.where(bits, frac[:, None, :], 1.0 - frac[:, None, :]))
    return torch.stack(rows, dim=1), torch.stack(weights, dim=1)


def trilinear(cw: torch.Tensor) -> torch.Tensor:
    """Per-axis weights [..., 3] -> the corners' trilinear weights [...]."""
    return cw[..., 0] * cw[..., 1] * cw[..., 2]


def encode(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Encode points with the multiresolution hash grid: H1 forward, H2 / H0
    backward on the card, their twins on the CPU (`hashgrid_cuda.encode`).

    Args:
      table: [O, total_params, F] (all levels concatenated), per object.
      x: [O, ..., 3] points in the unit cube (warped object coords).
    Returns:
      [O, ..., L*F] features (level-major) in the table's dtype.
    """
    from romap_tpu_torch.ops import hashgrid_cuda  # it imports this module

    return hashgrid_cuda.encode(table, x, spec)
