"""Bias-free MLP head (counterpart of romap_tpu/ops/mlp.py, points-major
`apply_mlp` only). Weights carry a leading object axis; the hidden products
are plain batched matmuls, as JAX leaves them to XLA; each network's last
product, summed in fp32, is `mlp_cuda.last_product` (kernels M1/M2 on the
card, the plain `torch.bmm(h.float(), w.float())` on the CPU).

RO-MAP's field has one head, {"w0", ..., "wL"}. instant-ngp's NeRF
(`view_dependent`) has two networks, {"density": {...}, "rgb": {...}},
each a chain of the same kind.
"""

from __future__ import annotations

import torch

from romap_tpu_torch.config import NetworkConfig
from romap_tpu_torch.ops.mlp_cuda import last_product
from romap_tpu_torch.ops.sh import SH_DIMS


def view_dependent(cfg: NetworkConfig) -> bool:
    """instant-ngp's two networks over the rays' directions, or RO-MAP's
    head."""
    return cfg.sh_degree > 0


def _he_uniform(generator: torch.Generator, dims: list[int], n_objects: int,
                device) -> dict:
    """{"w0": [O, dims[0], dims[1]], ...}: He-uniform fp32 over each matrix's
    input width, drawn from `generator` on its device."""
    params = {}
    for i in range(len(dims) - 1):
        bound = (6.0 / dims[i]) ** 0.5
        u = torch.rand((n_objects, dims[i], dims[i + 1]), generator=generator,
                       device=generator.device, dtype=torch.float32)
        params[f"w{i}"] = (u * (2 * bound) - bound).to(device)
    return params


def init_mlp(generator: torch.Generator, in_dim: int, cfg: NetworkConfig,
             n_objects: int, device="cpu") -> dict:
    """He-uniform fp32 init: {"w0": [O, in, H], ..., f"w{L}": [O, H, out]},
    or for a view-dependent config {"density": {"w0": [O, in, H], ...,
    [O, H, output_dims]}, "rgb": {"w0": [O, output_dims + 16, H'], ...,
    [O, H', 3]}}; drawn from `generator` on its device."""
    first = [in_dim] + [cfg.n_neurons] * cfg.n_hidden_layers + [cfg.output_dims]
    if not view_dependent(cfg):
        return _he_uniform(generator, first, n_objects, device)
    rgb_hidden = [cfg.rgb_n_neurons] * cfg.rgb_n_hidden_layers
    return {"density": _he_uniform(generator, first, n_objects, device),
            "rgb": _he_uniform(generator, [cfg.output_dims + SH_DIMS] + rgb_hidden + [3],
                               n_objects, device)}


def _chain(params: dict, x: torch.Tensor, n_mats: int) -> torch.Tensor:
    h = x
    for i in range(n_mats - 1):
        h = torch.relu(torch.bmm(h, params[f"w{i}"]))
    return last_product(h, params[f"w{n_mats - 1}"])


def apply_mlp(params: dict, x: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    """x [O, N, in] -> outputs [O, N, out] in fp32 through the head (or the
    density network): hidden layers run in x's dtype; the last product
    accumulates to fp32, as the JAX head's preferred_element_type does."""
    return _chain(params, x, cfg.n_hidden_layers + 1)


def apply_rgb(params: dict, x: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    """The colour network: x [O, N, output_dims + 16] -> rgb logits
    [O, N, 3] in fp32, by `apply_mlp`'s rule."""
    return _chain(params, x, cfg.rgb_n_hidden_layers + 1)
