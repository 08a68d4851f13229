"""nerfacto's proposal sampler (nerfstudio, `model_components/
ray_samplers.py`: `UniformSampler`, `PDFSampler`, `ProposalNetworkSampler`;
Tancik et al., SIGGRAPH 2023), in the normalised distance s in [0, 1] along
each ray's section of its box, t = tmin + s (tmax - tmin).

  uniform_edges  n bins of equal width; in training one jitter a ray moves
                 every edge within its half bin (`single_jitter`)
  bin_weights    a stage's weights (1 - exp(-sigma d)) exp(-sum_{j<i}
                 sigma_j d_j), d = end - start, sigma = exp(clamp(., +-15))
  pdf_edges      n bins drawn from a stage's weights (`PDFSampler`,
                 `include_original=False`): the weights padded by 0.01 and
                 topped up to a sum of 1e-5, their CDF from 0, capped at 1,
                 inverted at n + 1 stratified levels (one jitter a ray in
                 training, the levels' midpoints without), with clipped
                 interpolation between the given edges
  anneal         the exponent the weights are raised to before a draw:
                 slope x / ((slope - 1) x + 1), x = min(step / steps, 1),
                 at NerfactoModelConfig's slope 10 over 1000 steps

Everything runs in fp32 without a sync of the host, so that a CUDA graph
captures it; `pdf_edges` takes and gives no gradient (nerfstudio detaches
its bins).
"""

from __future__ import annotations

import torch

from romap_tpu_torch.ops.render import density_activation

HISTOGRAM_PADDING = 0.01  # PDFSampler's histogram_padding
PDF_EPS = 1e-5  # PDFSampler's eps
ANNEAL_SLOPE = 10.0  # proposal_weights_anneal_slope
ANNEAL_STEPS = 1000  # proposal_weights_anneal_max_num_iters


def uniform_edges(jitter: torch.Tensor | None, n: int, like: torch.Tensor) -> torch.Tensor:
    """[..., n + 1] edges in s of n bins a ray: linspace(0, 1, n + 1), each
    edge moved by the ray's jitter [...] in [0, 1) between the midpoints
    around it (the first from 0, the last up to 1); without jitter the
    linspace itself. `like` [...] gives the rays' shape and device."""
    bins = torch.linspace(0.0, 1.0, n + 1, device=like.device)
    if jitter is None:
        return bins.expand(*like.shape, n + 1)
    centers = (bins[1:] + bins[:-1]) / 2.0
    upper = torch.cat([centers, bins[-1:]])
    lower = torch.cat([bins[:1], centers])
    return lower + (upper - lower) * jitter[..., None]


def to_distance(s: torch.Tensor, tmin: torch.Tensor, tmax: torch.Tensor) -> torch.Tensor:
    """Distances t = tmin + s (tmax - tmin) of edges s [..., B]."""
    return tmin[..., None] + s * (tmax - tmin)[..., None]


def midpoints_and_lengths(t_edges: torch.Tensor):
    """(midpoints [..., B], lengths [..., B]) of the bins between edges
    t_edges [..., B + 1]."""
    start, end = t_edges[..., :-1], t_edges[..., 1:]
    return (start + end) / 2.0, end - start


def bin_weights(log_sigma: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Render weights [..., B] of bins of `lengths` [..., B] at log-densities
    [..., B]: (1 - exp(-sd)) exp(-(cumsum(sd) - sd)), sd = sigma d."""
    sd = density_activation(log_sigma.float()) * lengths
    accum = torch.cumsum(sd, dim=-1)
    return (1.0 - torch.exp(-sd)) * torch.exp(-(accum - sd))


def anneal(step: torch.Tensor) -> torch.Tensor:
    """nerfacto's anneal exponent [O] of each slot's step [O] (its bias
    function of the training fraction, mip-NeRF 360's eq. 18)."""
    x = torch.clamp(step.float() / ANNEAL_STEPS, max=1.0)
    return ANNEAL_SLOPE * x / ((ANNEAL_SLOPE - 1.0) * x + 1.0)


@torch.no_grad()
def pdf_edges(s: torch.Tensor, weights: torch.Tensor, jitter: torch.Tensor | None,
              n: int) -> torch.Tensor:
    """[..., n + 1] edges in s of n bins drawn from the histogram of
    `weights` [..., B] over edges s [..., B + 1] (`PDFSampler`); `jitter`
    [...] in [0, 1) is the ray's one jitter, None at render time."""
    w = weights.float() + HISTOGRAM_PADDING
    w_sum = torch.sum(w, dim=-1, keepdim=True)
    padding = torch.relu(PDF_EPS - w_sum)
    w = w + padding / w.shape[-1]
    w_sum = w_sum + padding
    pdf = w / w_sum
    cdf = torch.clamp(torch.cumsum(pdf, dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    n_edges = n + 1
    u = torch.linspace(0.0, 1.0 - 1.0 / n_edges, n_edges, device=s.device)
    if jitter is None:
        u = (u + 1.0 / (2 * n_edges)).expand(*cdf.shape[:-1], n_edges)
    else:
        u = u + jitter[..., None] / n_edges
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, side="right")
    below = torch.clamp(inds - 1, 0, s.shape[-1] - 1)
    above = torch.clamp(inds, 0, s.shape[-1] - 1)
    cdf_g0, cdf_g1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_g0, bins_g1 = torch.gather(s, -1, below), torch.gather(s, -1, above)
    frac = torch.clip(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), 0.0), 0.0, 1.0)
    return bins_g0 + frac * (bins_g1 - bins_g0)
