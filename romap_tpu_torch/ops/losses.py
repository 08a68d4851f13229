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

A batch of nerfacto's proposal sampler (`ProposalBatch`) renders over its
bins (each sample's bin length, `render.volume_render`) under the same
terms, and adds nerfstudio's (`model_components/losses.py`), in fp32, in
the normalised distance s of the bins' edges:
  interlevel  `interlevel_lambda` times, summed over the proposal levels,
              the mean over the slot's bins of clip(w - outer, 0)^2 /
              (w + 1e-7), w the field's weights and outer the proposal
              level's weights summed over the bins that overlap each of
              the field's (`outer`); w and the field's edges detached, so
              that the term trains the proposal fields alone (span
              `loss.interlevel`)
  distortion  `distortion_lambda` times the mean over the slot's rays of
              sum_ij w_i w_j |u_i - u_j| + sum_i w_i^2 (s_i+1 - s_i) / 3,
              u the bins' midpoints (mip-NeRF 360's; span `loss.distortion`)
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


class ProposalBatch(NamedTuple):
    """Training rays of nerfacto's proposal sampler: RayBatch's fields (at
    the field's bins' midpoints) and the bins of every level."""

    points: torch.Tensor  # [..., R, S, 3] warped midpoints of the field's bins
    t: torch.Tensor  # [..., R, S] their distances
    rgb_target: torch.Tensor
    depth_target: torch.Tensor
    is_object: torch.Tensor
    bg_color: torch.Tensor
    valid: torch.Tensor
    dirs: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    frame: torch.Tensor  # [..., R] int64: the frame each ray was drawn from
    lengths: torch.Tensor  # [..., R, S] the field's bins' lengths in distance
    edges: torch.Tensor  # [..., R, S + 1] the field's bins' edges in s
    edges0: torch.Tensor  # [..., R, S0 + 1] the first proposal level's edges in s
    weights0: torch.Tensor  # [..., R, S0] its weights (with their gradient)
    edges1: torch.Tensor  # [..., R, S1 + 1] the second's
    weights1: torch.Tensor  # [..., R, S1]


def outer(t0: torch.Tensor, t1: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    """nerfstudio's `outer`: for each bin of edges t0 [..., B0 + 1], the sum
    of the weights y1 [..., B1] of the bins of edges t1 [..., B1 + 1] that
    overlap it, [..., B0]."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    last = y1.shape[-1] - 1
    lo = torch.searchsorted(t1[..., :-1].contiguous(), t0[..., :-1].contiguous(), side="right")
    lo = torch.clamp(lo - 1, min=0, max=last)
    hi = torch.searchsorted(t1[..., 1:].contiguous(), t0[..., 1:].contiguous(), side="right")
    hi = torch.clamp(hi, min=0, max=last)
    return torch.gather(cy1[..., 1:], -1, hi) - torch.gather(cy1[..., :-1], -1, lo)


def interlevel_loss(edges: torch.Tensor, weights: torch.Tensor, levels) -> torch.Tensor:
    """[...]: summed over the proposal levels (edges, weights), the mean over
    the last two axes of clip(w - outer, 0)^2 / (w + 1e-7), the field's
    edges [..., R, S + 1] and weights [..., R, S] detached."""
    c, w = edges.detach(), weights.detach()
    total = 0.0
    for cp, wp in levels:
        w_outer = outer(c, cp, wp)
        total = total + torch.mean(torch.clip(w - w_outer, min=0.0) ** 2 / (w + 1e-7),
                                   dim=(-2, -1))
    return total


def distortion_loss(edges: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[...]: the mean over rays of mip-NeRF 360's distortion of the weights
    [..., R, S] over the edges [..., R, S + 1]. Its pairwise term sum_ij
    w_i w_j |u_i - u_j| is summed through the running sums of w and w u
    over the bins before each (the midpoints u ascend): 2 sum_i w_i (u_i
    W_<i - (wu)_<i)."""
    u = (edges[..., 1:] + edges[..., :-1]) / 2.0
    w = weights.float()
    wu = w * u
    w_before = torch.cumsum(w, dim=-1) - w
    wu_before = torch.cumsum(wu, dim=-1) - wu
    inter = 2.0 * torch.sum(w * (u * w_before - wu_before), dim=-1)
    intra = torch.sum(w * w * (edges[..., 1:] - edges[..., :-1]), dim=-1) / 3.0
    return torch.mean(inter + intra, dim=-1)


def composite_loss(raw: torch.Tensor, batch: RayBatch, cfg: TrainConfig):
    """raw [..., R, S, 4] (or an SDF field's [..., R, S, SDF_CHANNELS]) ->
    (loss [...], aux) with aux["logged_loss"] [...] and the forward render
    ("rgb", "depth", "mask"). A `ProposalBatch` renders over its bins and
    adds the interlevel and distortion terms."""
    sdf = raw.shape[-1] == SDF_CHANNELS
    bins = isinstance(batch, ProposalBatch)
    if sdf:
        with tracing.span("render.sdf"):
            stratum = (batch.tmax - batch.tmin) / raw.shape[-2]
            out = sdf_render(raw, batch.dirs, batch.t, stratum, batch.bg_color)
    else:
        out = volume_render(raw, batch.t, batch.bg_color,
                            lengths=batch.lengths if bins else None)
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
    if bins:
        with tracing.span("loss.interlevel"):
            levels = ((batch.edges0, batch.weights0), (batch.edges1, batch.weights1))
            loss = loss + cfg.interlevel_lambda * interlevel_loss(batch.edges, out.weights,
                                                                  levels)
        with tracing.span("loss.distortion"):
            loss = loss + cfg.distortion_lambda * distortion_loss(batch.edges, out.weights)
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
