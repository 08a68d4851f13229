"""Real spherical harmonics of a unit direction, the direction encoding of
instant-ngp's NeRF: tiny-cuda-nn's SphericalHarmonics encoding at degree 4,
the 16 functions of degrees 0-3 with its signs and order, orthonormal on
the unit sphere."""

from __future__ import annotations

import torch

SH_DEGREE = 4  # the one degree the port runs
SH_DIMS = SH_DEGREE**2


def sh_encode(d: torch.Tensor) -> torch.Tensor:
    """d [..., 3] unit directions -> [..., 16] in d's dtype."""
    x, y, z = d.unbind(-1)
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y,
        -1.0925484305920792 * y * z,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        0.59004358992664352 * y * (y2 - 3.0 * x2),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (3.0 * y2 - x2),
    ], dim=-1)
