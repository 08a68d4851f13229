"""Bias-free MLP head (counterpart of romap_tpu/ops/mlp.py, points-major
`apply_mlp` only). Weights carry a leading object axis; the products are
plain batched matmuls, as JAX leaves them to XLA."""

from __future__ import annotations

import torch

from romap_tpu_torch.config import NetworkConfig


def init_mlp(generator: torch.Generator, in_dim: int, cfg: NetworkConfig,
             n_objects: int, device="cpu") -> dict:
    """He-uniform fp32 init: {"w0": [O, in, H], ..., f"w{L}": [O, H, out]},
    drawn from `generator` on its device."""
    dims = [in_dim] + [cfg.n_neurons] * cfg.n_hidden_layers + [cfg.output_dims]
    params = {}
    for i in range(cfg.n_hidden_layers + 1):
        bound = (6.0 / dims[i]) ** 0.5
        u = torch.rand((n_objects, dims[i], dims[i + 1]), generator=generator,
                       device=generator.device, dtype=torch.float32)
        params[f"w{i}"] = (u * (2 * bound) - bound).to(device)
    return params


def apply_mlp(params: dict, x: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    """x [O, N, in] -> raw outputs [O, N, 4] in fp32. Hidden layers run in
    x's dtype; the last product accumulates to fp32, as the JAX head's
    preferred_element_type does."""
    n_mats = cfg.n_hidden_layers + 1
    h = x
    for i in range(n_mats - 1):
        h = torch.relu(torch.bmm(h, params[f"w{i}"]))
    return torch.bmm(h.float(), params[f"w{n_mats - 1}"].float())
