"""Emission-absorption volume rendering in closed form (counterpart of
romap_tpu/ops/render.py), and NeuS's render of a signed-distance field.

Transmittance is exp of an exclusive cumulative sum, so a ray renders
without a loop or an early exit. Two reference quirks are kept: the first
sample's dt is measured from distance 0, not from tmin, and the log-density
is clamped to +-15 before the exponential.

`sdf_render` is NeuS's SDF-to-alpha rule (Wang et al., NeurIPS 2021,
`models/renderer.py::render_core`) on the system's stratified samples.

Over bins (nerfacto's proposal sampler) `volume_render` takes each
sample's bin length in place of the distance from the sample before.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable


def density_activation(raw_sigma: torch.Tensor) -> torch.Tensor:
    """exp(clamp(raw, -15, 15)); e^15 already makes alpha 1 at any dt."""
    return torch.exp(torch.clamp(raw_sigma, -15.0, 15.0))


class RenderOut(NamedTuple):
    rgb: torch.Tensor  # [..., 3] composited colour (incl. background)
    depth: torch.Tensor  # [...] expected ray distance
    mask: torch.Tensor  # [...] opacity = 1 - T_final
    trans: torch.Tensor  # [..., S] transmittance before each sample
    weights: torch.Tensor  # [..., S] alpha_i * T_i
    sigma: torch.Tensor | None  # [..., S] activated densities (an SDF's render: None)


def volume_render(raw: torch.Tensor, t: torch.Tensor, bg: torch.Tensor,
                  lengths: torch.Tensor | None = None) -> RenderOut:
    """raw [..., S, 4] (rgb logits, log-density), t [..., S], bg [..., 3]
    -> RenderOut, all fp32. `lengths` [..., S]: the samples' bin lengths
    (t then the bins' midpoints); without them each sample's section is
    its distance from the one before (from 0 for the first)."""
    raw = raw.float()
    t = t.float()
    rgb = torch.sigmoid(raw[..., :3])
    sigma = density_activation(raw[..., 3])
    if lengths is None:
        prev = torch.cat([torch.zeros_like(t[..., :1]), t[..., :-1]], dim=-1)
        lengths = t - prev
    sd = sigma * lengths
    accum = torch.cumsum(sd, dim=-1)
    trans = torch.exp(-(accum - sd))
    weights = (1.0 - torch.exp(-sd)) * trans
    t_final = torch.exp(-accum[..., -1])
    rgb_ray = torch.sum(weights[..., None] * rgb, dim=-2) + t_final[..., None] * bg
    depth_ray = torch.sum(weights * t, dim=-1)
    return RenderOut(rgb_ray, depth_ray, 1.0 - t_final, trans, weights, sigma)


# an SDF field's raw channels: rgb logits (3), the distance f, the normal n
# (3, the frame of the rays' directions), inv_s and the cosine's anneal
# ratio (both the same for every sample of a slot)
SDF_CHANNELS = 9


class _Cumprod(torch.autograd.Function):
    """`torch.cumprod` over the last axis with the backward PyTorch's takes
    for an input without zeros, (out g) summed from the right over the
    input, bit for bit, and without PyTorch's look for a zero (`.item()`,
    which a CUDA graph's capture cannot take). NeuS's factors 1 - alpha +
    1e-7 are never zero."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


def sdf_render(raw, dirs, t, stratum, bg) -> RenderOut:
    """NeuS's render of an SDF field's raw [..., S, SDF_CHANNELS] at the
    samples t [..., S] of rays of unit directions dirs [..., 3], fp32;
    `stratum` [...] the last sample's section ((tmax - tmin) / S, NeuS's
    sample_dist); bg [..., 3]. Per sample, with d_i = t_{i+1} - t_i:
      c = -(relu(-cos / 2 + 1/2) (1 - anneal) + relu(-cos) anneal), cos = d . n
      P = sigmoid((f - c d_i / 2) inv_s), N = sigmoid((f + c d_i / 2) inv_s)
      alpha = clip((P - N + 1e-5) / (P + 1e-5), 0, 1)
      w_i = alpha_i prod_{j<i} (1 - alpha_j + 1e-7)
    The ray's opacity is sum w, its colour sum w rgb + bg (1 - opacity),
    its depth sum w t; `trans` holds the products."""
    raw, t = raw.float(), t.float()
    rgb = torch.sigmoid(raw[..., :3])
    f, normal, inv_s, anneal = raw[..., 3], raw[..., 4:7], raw[..., 7], raw[..., 8]
    delta = torch.cat([t[..., 1:] - t[..., :-1], stratum[..., None]], dim=-1)
    cos = torch.sum(dirs[..., None, :] * normal, dim=-1)
    c = -(torch.relu(-cos * 0.5 + 0.5) * (1.0 - anneal) + torch.relu(-cos) * anneal)
    half = c * delta * 0.5
    prev = torch.sigmoid((f - half) * inv_s)
    nxt = torch.sigmoid((f + half) * inv_s)
    alpha = torch.clamp((prev - nxt + 1e-5) / (prev + 1e-5), 0.0, 1.0)
    trans = _Cumprod.apply(torch.cat([torch.ones_like(alpha[..., :1]),
                                      1.0 - alpha[..., :-1] + 1e-7], dim=-1))
    weights = alpha * trans
    opacity = torch.sum(weights, dim=-1)
    rgb_ray = torch.sum(weights[..., None] * rgb, dim=-2) + (1.0 - opacity)[..., None] * bg
    depth = torch.sum(weights * t, dim=-1)
    return RenderOut(rgb_ray, depth, opacity, trans, weights, None)


def render_composite(out: RenderOut, d_norm, in_bbox, background: float = 1.0):
    """Inference compositing: rays that miss the box or have opacity <= 0.5
    show the flat background; depth is divided by d_norm (z-depth).

    Returns (rgb [..., 3], depth [...], mask [...])."""
    visible = in_bbox & (out.mask > 0.5)
    bg = torch.full_like(out.rgb, background)
    rgb = torch.where(visible[..., None], out.rgb, bg)
    depth = torch.where(visible, out.depth / d_norm, torch.zeros_like(out.depth))
    return rgb, depth, visible.float()
