"""Bias-free MLP head (counterpart of romap_tpu/ops/mlp.py, points-major
`apply_mlp` only). Weights carry a leading object axis; the hidden products
are plain batched matmuls, as JAX leaves them to XLA; each network's last
product, summed in fp32, is `mlp_cuda.last_product` (kernels M1/M2 on the
card, the plain `torch.bmm(h.float(), w.float())` on the CPU).

RO-MAP's field has one head, {"w0", ..., "wL"}. instant-ngp's NeRF
(`view_dependent`) has two networks, {"density": {...}, "rgb": {...}},
each a chain of the same kind. NeuS2's SDF field (`signed_distance`) has
{"sdf": {...}, "rgb": {...}, "variance": [O, 1]}: its first network also
gives the distance's gradient in its input (`apply_sdf`). nerfacto's field
(`nerfacto`) has instant-ngp's two networks, a proposal field each of two
levels, {"prop0": {"table", "w0", ...}, "prop1": {...}} (a hash table and a
density net to one output, `apply_proposal`), and the appearance codes
{"appearance": [O, frames, dims]}.
"""

from __future__ import annotations

import torch

from romap_tpu_torch.config import NetworkConfig
from romap_tpu_torch.ops import hashgrid
from romap_tpu_torch.ops.mlp_cuda import last_product
from romap_tpu_torch.ops.sh import SH_DIMS


def view_dependent(cfg: NetworkConfig) -> bool:
    """instant-ngp's two networks over the rays' directions (or NeuS2's), or
    RO-MAP's head."""
    return cfg.sh_degree > 0


def signed_distance(cfg: NetworkConfig) -> bool:
    """NeuS2's SDF field: a distance network, a colour network over NeuS's
    `idr` inputs and a variance."""
    return cfg.field == "sdf"


def nerfacto(cfg: NetworkConfig) -> bool:
    """nerfacto's field: instant-ngp's networks with appearance codes, behind
    two proposal fields."""
    return cfg.field == "nerfacto"


def rgb_inputs(cfg: NetworkConfig) -> int:
    """The colour network's input width: the first network's outputs beside
    the 16 SH (instant-ngp's); for an SDF field the warped point (3), the
    normal (3), the SH and the geometry features, the distance left out
    (NeuS's `idr`); for nerfacto's the geometry features (the log-density
    left out), the SH and the appearance code."""
    if signed_distance(cfg):
        return 3 + 3 + SH_DIMS + cfg.output_dims - 1
    if nerfacto(cfg):
        return cfg.output_dims - 1 + SH_DIMS + cfg.appearance_dims
    return cfg.output_dims + SH_DIMS


def proposal_specs(cfg: NetworkConfig) -> tuple[hashgrid.HashGridSpec, ...]:
    """The hash-grid spec of each proposal field of nerfacto's."""
    return tuple(hashgrid.make_spec(cfg.proposal_encoding(k))
                 for k in range(len(cfg.proposal_max_resolutions)))


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
    [O, H', 3]}}, or for an SDF field {"sdf": (as "density"), "rgb": {"w0":
    [O, `rgb_inputs`, H'], ...}, "variance": [O, 1] at `init_variance`},
    or for nerfacto's {"density", "rgb", "prop0": {"table": the proposal
    grid's `hashgrid.init_table`, "w0": [O, L F, H''], ..., [O, H'', 1]},
    "prop1": ..., "appearance": [O, appearance_frames, appearance_dims]
    N(0, 1) (torch.nn.Embedding's)}; drawn from `generator` on its device
    in that order."""
    first = [in_dim] + [cfg.n_neurons] * cfg.n_hidden_layers + [cfg.output_dims]
    if not view_dependent(cfg):
        return _he_uniform(generator, first, n_objects, device)
    rgb_hidden = [cfg.rgb_n_neurons] * cfg.rgb_n_hidden_layers
    geometry = _he_uniform(generator, first, n_objects, device)
    rgb = _he_uniform(generator, [rgb_inputs(cfg)] + rgb_hidden + [3], n_objects, device)
    if nerfacto(cfg):
        out = {"density": geometry, "rgb": rgb}
        hidden = [cfg.proposal_n_neurons] * cfg.proposal_n_hidden_layers
        for k, spec in enumerate(proposal_specs(cfg)):
            table = hashgrid.init_table(generator, spec, n_objects, device=device)
            out[f"prop{k}"] = {"table": table, **_he_uniform(
                generator, [spec.n_output_dims] + hidden + [1], n_objects, device)}
        codes = torch.randn((n_objects, cfg.appearance_frames, cfg.appearance_dims),
                            generator=generator, device=generator.device, dtype=torch.float32)
        return dict(out, appearance=codes.to(device))
    if not signed_distance(cfg):
        return {"density": geometry, "rgb": rgb}
    variance = torch.full((n_objects, 1), cfg.init_variance, dtype=torch.float32,
                          device=device)
    return {"sdf": geometry, "rgb": rgb, "variance": variance}


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


def apply_sdf(params: dict, x: torch.Tensor, cfg: NetworkConfig):
    """The SDF network: x [O, N, in] -> (outputs [O, N, out] fp32 by
    `apply_mlp`'s rule, output 0 the distance f; df/dx [O, N, in] in x's
    dtype). df/dx = ((W_L[:, 0] * 1[a_L-1 > 0]) W_L-1^T ... * 1[a_0 > 0])
    W_0^T, a_i hidden layer i's pre-activation: built from differentiable
    products, so a loss on it reaches every matrix (ReLU's derivative is a
    step, with none of its own: NeuS2's second-order simplification)."""
    n_mats = cfg.n_hidden_layers + 1
    h, hidden = x, []
    for i in range(n_mats - 1):
        h = torch.relu(torch.bmm(h, params[f"w{i}"]))
        hidden.append(h)
    out = last_product(h, params[f"w{n_mats - 1}"])
    e = params[f"w{n_mats - 1}"][:, None, :, 0]  # [O, 1, H]: f's row of the last matrix
    for i in reversed(range(n_mats - 1)):
        e = torch.bmm(e * (hidden[i] > 0), params[f"w{i}"].transpose(1, 2))
    return out, e.expand(-1, x.shape[1], -1)


def apply_proposal(params: dict, x: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    """A proposal field's density net: x [O, N, in] -> log-density [O, N, 1]
    in fp32, by `apply_mlp`'s rule."""
    return _chain(params, x, cfg.proposal_n_hidden_layers + 1)


def apply_rgb(params: dict, x: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    """The colour network: x [O, N, `rgb_inputs`] -> rgb logits [O, N, 3]
    in fp32, by `apply_mlp`'s rule."""
    return _chain(params, x, cfg.rgb_n_hidden_layers + 1)
