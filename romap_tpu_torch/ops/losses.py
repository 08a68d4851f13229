"""Composite NeRF training loss (counterpart of romap_tpu/ops/losses.py,
where each term's reference line is cited).

Per ray, summed then divided by the ray count:
  RGB    sum_c (pred_c - target_c)^2 over a random background colour; for
         background rays the density path of this term is cut (`detach`)
  depth  0.5 |depth_pred - depth_target| where the target is > 0
  mask   0.5 |opacity - is_object|
  reg    background rays add 0.01 * sum_i sigma_i
The logged loss is the reference's console loss.

An SDF field's raw outputs (`render.SDF_CHANNELS`) render by NeuS's rule
(`render.sdf_render`, span `render.sdf`) under the same RGB, depth and
mask terms, the ray's 1 - opacity in place of its final transmittance; it
has no sigma, so no background term, and adds NeuS's eikonal term,
`eikonal_lambda` times the mean over the slot's samples of (|n| - 1)^2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from romap_tpu_torch.config import TrainConfig
from romap_tpu_torch.ops.render import SDF_CHANNELS, sdf_render, volume_render
from romap_tpu_torch.utils import tracing


class RayBatch(NamedTuple):
    """Training rays; leading axes are free (the train step uses [O, R])."""

    points: torch.Tensor  # [..., R, S, 3] warped sample positions
    t: torch.Tensor  # [..., R, S] sample distances
    rgb_target: torch.Tensor  # [..., R, 3]
    depth_target: torch.Tensor  # [..., R] (0 where unsupervised)
    is_object: torch.Tensor  # [..., R] bool
    bg_color: torch.Tensor  # [..., R, 3]
    valid: torch.Tensor  # [...] bool: any ray survived the gates
    dirs: torch.Tensor | None = None  # [..., R, 3] unit, object frame, before the warp
    tmin: torch.Tensor | None = None  # [..., R] the section the samples stratify
    tmax: torch.Tensor | None = None  # [..., R]


def composite_loss(raw: torch.Tensor, batch: RayBatch, cfg: TrainConfig):
    """raw [..., R, S, 4] (or an SDF field's [..., R, S, SDF_CHANNELS]) ->
    (loss [...], aux) with aux["logged_loss"] [...] and the forward render
    ("rgb", "depth", "mask")."""
    sdf = raw.shape[-1] == SDF_CHANNELS
    if sdf:
        with tracing.span("render.sdf"):
            stratum = (batch.tmax - batch.tmin) / raw.shape[-2]
            out = sdf_render(raw, batch.dirs, batch.t, stratum, batch.bg_color)
    else:
        out = volume_render(raw, batch.t, batch.bg_color)
    is_obj = batch.is_object
    obj = is_obj[..., None]

    rgb_samples = torch.sigmoid(raw[..., :3].float())
    w_cut = torch.where(obj, out.weights, out.weights.detach())
    t_final = 1.0 - out.mask
    t_cut = torch.where(is_obj, t_final, t_final.detach())
    rgb_pred = (torch.sum(w_cut[..., None] * rgb_samples, dim=-2)
                + t_cut[..., None] * batch.bg_color)
    diff = rgb_pred - batch.rgb_target
    rgb_loss = torch.sum(diff * diff, dim=-1)

    has_depth = batch.depth_target > 0.0
    depth_err = torch.abs(out.depth - batch.depth_target)
    zero = torch.zeros_like(depth_err)
    depth_term = torch.where(has_depth, depth_err, zero)
    depth_loss = cfg.depth_lambda * depth_term
    mask_loss = cfg.mask_lambda * torch.abs(out.mask - is_obj.float())

    per_ray = rgb_loss + depth_loss + mask_loss
    if not sdf:
        per_ray = per_ray + cfg.bg_sigma_reg * torch.where(is_obj, zero,
                                                           torch.sum(out.sigma, dim=-1))
    n_rays = per_ray.shape[-1]
    loss = torch.sum(per_ray, dim=-1) / n_rays
    if sdf:
        norm = torch.linalg.vector_norm(raw[..., 4:7], dim=-1)
        loss = loss + cfg.eikonal_lambda * torch.mean((norm - 1.0) ** 2, dim=(-2, -1))
    loss = torch.where(batch.valid, loss, torch.zeros_like(loss))

    rgb_mean = torch.mean((out.rgb - batch.rgb_target) ** 2, dim=-1)
    logged = torch.where(
        is_obj,
        rgb_mean + cfg.depth_lambda * depth_term + (1.0 - out.mask),
        rgb_mean + out.mask,
    )
    aux = {"logged_loss": torch.sum(logged, dim=-1) / n_rays,
           "rgb": out.rgb, "depth": out.depth, "mask": out.mask}
    return loss, aux
