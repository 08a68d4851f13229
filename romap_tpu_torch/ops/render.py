"""Emission-absorption volume rendering in closed form (counterpart of
romap_tpu/ops/render.py).

Transmittance is exp of an exclusive cumulative sum, so a ray renders
without a loop or an early exit. Two reference quirks are kept: the first
sample's dt is measured from distance 0, not from tmin, and the log-density
is clamped to +-15 before the exponential.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def density_activation(raw_sigma: torch.Tensor) -> torch.Tensor:
    """exp(clamp(raw, -15, 15)); e^15 already makes alpha 1 at any dt."""
    return torch.exp(torch.clamp(raw_sigma, -15.0, 15.0))


class RenderOut(NamedTuple):
    rgb: torch.Tensor  # [..., 3] composited colour (incl. background)
    depth: torch.Tensor  # [...] expected ray distance
    mask: torch.Tensor  # [...] opacity = 1 - T_final
    trans: torch.Tensor  # [..., S] transmittance before each sample
    weights: torch.Tensor  # [..., S] alpha_i * T_i
    sigma: torch.Tensor  # [..., S] activated densities


def volume_render(raw: torch.Tensor, t: torch.Tensor, bg: torch.Tensor) -> RenderOut:
    """raw [..., S, 4] (rgb logits, log-density), t [..., S], bg [..., 3]
    -> RenderOut, all fp32."""
    raw = raw.float()
    t = t.float()
    rgb = torch.sigmoid(raw[..., :3])
    sigma = density_activation(raw[..., 3])
    prev = torch.cat([torch.zeros_like(t[..., :1]), t[..., :-1]], dim=-1)
    sd = sigma * (t - prev)
    accum = torch.cumsum(sd, dim=-1)
    trans = torch.exp(-(accum - sd))
    weights = (1.0 - torch.exp(-sd)) * trans
    t_final = torch.exp(-accum[..., -1])
    rgb_ray = torch.sum(weights[..., None] * rgb, dim=-2) + t_final[..., None] * bg
    depth_ray = torch.sum(weights * t, dim=-1)
    return RenderOut(rgb_ray, depth_ray, 1.0 - t_final, trans, weights, sigma)


def render_composite(out: RenderOut, d_norm, in_bbox, background: float = 1.0):
    """Inference compositing: rays that miss the box or have opacity <= 0.5
    show the flat background; depth is divided by d_norm (z-depth).

    Returns (rgb [..., 3], depth [...], mask [...])."""
    visible = in_bbox & (out.mask > 0.5)
    bg = torch.full_like(out.rgb, background)
    rgb = torch.where(visible[..., None], out.rgb, bg)
    depth = torch.where(visible, out.depth / d_norm, torch.zeros_like(out.depth))
    return rgb, depth, visible.float()
