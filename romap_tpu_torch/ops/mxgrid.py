"""MX-grid encoding, plain PyTorch (counterpart of romap_tpu/ops/mxgrid.py).

The encoding is a learned multi-resolution spatial table read through
linear-interpolation (tent) bases: CP lines (per-axis factors, multiplied
over x, y, z) plus TensoRF-style plane x line components. See the JAX
module's docstring for the design; this file keeps its spec, its fold and
its chunked dense encode, with a leading object axis written out where JAX
vmaps.

`encode` here is the plain version: the CPU path of `models/nerf.py` and
the oracle the CUDA kernels of `ops/mxgrid_cuda.py` are held against. It
never runs on a CUDA tensor in the train or render path (field_apply sends
CUDA tensors to the kernels).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class MXGridSpec:
    """Static shape of one object's encoding; fields and defaults equal
    romap_tpu.ops.mxgrid.MXGridSpec (the parity tests compare them)."""

    resolutions: tuple[int, ...]  # 1D resolution ladder (shared by x, y, z)
    features: int  # K output channels of the CP part
    offsets: tuple[int, ...]  # row offset of each level in the ladder
    total_res: int  # sum of resolutions
    chunk: int = 4096  # points per dense-basis chunk in `encode`
    plane_specs: tuple[tuple[int, int, int], ...] = ()  # ((ru, rv, k), ...)
    # (u, v, orthogonal-line) axes of the three plane pairs
    plane_axes: tuple[tuple[int, int, int], ...] = (
        (0, 1, 2), (0, 2, 1), (1, 2, 0))
    # evaluate the CP ladder through the finest level's tent basis, with the
    # constant fold matrix absorbed into the line weights once per call
    snap_levels: bool = False

    @property
    def plane_out_dims(self) -> int:
        return 3 * sum(k for _, _, k in self.plane_specs)

    @property
    def fold_res(self) -> tuple[int, int]:
        """(finest resolution, 16-padded row count) of the folded basis."""
        rf = max(self.resolutions)
        return rf, ((rf + 15) // 16) * 16

    @property
    def n_output_dims(self) -> int:
        return self.features + self.plane_out_dims


def make_mxspec(
    n_levels: int = 8,
    base_resolution: int = 16,
    max_resolution: int = 1024,
    features: int = 64,
    chunk: int = 4096,
    plane_res: int = 0,
    plane_features: int = 0,
    plane_specs: tuple[tuple[int, ...], ...] | None = None,
    plane_axes: str = "uuv",
    snap_levels: bool = False,
) -> MXGridSpec:
    """Geometric resolution ladder and plane levels, as the JAX make_mxspec."""
    b = (max_resolution / base_resolution) ** (1.0 / (n_levels - 1)) if n_levels > 1 else 1.0
    res = tuple(int(round(base_resolution * b**l)) for l in range(n_levels))
    offsets = tuple(int(o) for o in np.cumsum((0,) + res[:-1]))
    if plane_specs is None:
        plane_specs = ((plane_res, plane_features),) if plane_features > 0 else ()
    norm = tuple((p[0], p[0], p[1]) if len(p) == 2 else tuple(p) for p in plane_specs)
    axes = {"uuv": ((0, 1, 2), (0, 2, 1), (1, 2, 0)),
            "balanced": ((0, 1, 2), (2, 0, 1), (1, 2, 0))}[plane_axes]
    return MXGridSpec(
        resolutions=res, features=features, offsets=offsets, total_res=sum(res),
        chunk=chunk, plane_specs=norm, plane_axes=axes, snap_levels=snap_levels,
    )


def fold_matrix(spec: MXGridSpec) -> np.ndarray:
    """[total_res, rfp] fold: row (level l, index b) holds coarse hat b of
    level l sampled at the finest grid's nodes, so C @ hat_fine(x) is the
    fine-grid interpolation of the whole ladder. Pad columns are zero."""
    rf, rfp = spec.fold_res
    c = np.zeros((spec.total_res, rfp), np.float32)
    nodes = np.arange(rf, dtype=np.float64) / (rf - 1)
    for r, off in zip(spec.resolutions, spec.offsets):
        z = nodes[None, :] * (r - 1) - np.arange(r, dtype=np.float64)[:, None]
        c[off : off + r, :rf] = np.maximum(0.0, 1.0 - np.abs(z))
    return c


@functools.cache
def _fold_tensor(spec: MXGridSpec, device: torch.device) -> torch.Tensor:
    """fold_matrix on `device`, made once: a per-step host-to-device copy
    would stall the host on the device queue."""
    return torch.from_numpy(fold_matrix(spec)).to(device)


def fold_lines(lines: torch.Tensor, spec: MXGridSpec) -> torch.Tensor:
    """W [..., 3, total_res, K] -> effective fine-basis weights [..., 3, rfp, K]
    (fp32 contraction, cast back to the parameter dtype)."""
    c = _fold_tensor(spec, lines.device)
    out = torch.einsum("...drk,rf->...dfk", lines.float(), c)
    return out.to(lines.dtype)


def unfold_dlines(dw_eff: torch.Tensor, spec: MXGridSpec, dtype) -> torch.Tensor:
    """Transpose of the fold: dW_eff [..., 3, rfp, K] (fp32) -> dW
    [..., 3, total_res, K] in `dtype` (romap_tpu mxgrid_pallas._unfold_dlines)."""
    c = _fold_tensor(spec, dw_eff.device)
    return torch.einsum("...dfk,rf->...drk", dw_eff.float(), c).to(dtype)


def init_mxgrid(generator: torch.Generator, spec: MXGridSpec, n_objects: int,
                device="cpu"):
    """fp32 parameters with a leading object axis: lines [O, 3, total_res, K]; with
    planes, a dict {lines, planes: tuple of [O, 3, ru, rv, k], plane_lines:
    tuple of [O, 3, max(ru, rv), k]}. N(0, 0.3^2) entries, as the JAX init
    (different random numbers: torch draws from `generator`, on its device)."""

    def normal(*shape):
        x = torch.randn((n_objects, *shape), generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (0.3 * x).to(device)

    lines = normal(3, spec.total_res, spec.features)
    if not spec.plane_specs:
        return lines
    return {
        "lines": lines,
        "planes": tuple(normal(3, ru, rv, k) for ru, rv, k in spec.plane_specs),
        "plane_lines": tuple(normal(3, max(ru, rv), k) for ru, rv, k in spec.plane_specs),
    }


def hat1(x: torch.Tensor, r: int) -> torch.Tensor:
    """[...] coords -> [..., r] single-resolution tent basis
    hat_r(x)[i] = max(0, 1 - |x (r-1) - i|)."""
    i = torch.arange(r, dtype=x.dtype, device=x.device)
    return torch.clamp(1.0 - torch.abs(x[..., None] * (r - 1) - i), min=0.0)


def hat_basis(x: torch.Tensor, spec: MXGridSpec) -> torch.Tensor:
    """[...] coords -> [..., total_res] concatenated tent bases."""
    return torch.cat([hat1(x, r) for r in spec.resolutions], dim=-1)


def _encode_chunk(factors, pts: torch.Tensor, spec: MXGridSpec) -> torch.Tensor:
    """[O, C, 3] -> [O, C, n_output_dims]; dense bases live only in here."""
    lines = factors["lines"] if isinstance(factors, dict) else factors
    ax = []
    for d in range(3):
        if spec.snap_levels:  # lines arrive folded, [O, 3, rfp, K]
            h = hat1(pts[..., d], spec.fold_res[0])
            w = lines[:, d, : h.shape[-1]]
        else:
            h = hat_basis(pts[..., d], spec)
            w = lines[:, d]
        ax.append(torch.matmul(h, w))
    out = ax[0] * ax[1] * ax[2]
    if not isinstance(factors, dict):
        return out
    o, c = pts.shape[:2]
    blocks = [out]
    for lvl, (ru, rv, kp) in enumerate(spec.plane_specs):
        for i, (u, v, w) in enumerate(spec.plane_axes):
            hu = hat1(pts[..., u], ru)  # [O, C, ru]
            hv = hat1(pts[..., v], rv)
            t = torch.matmul(hu, factors["planes"][lvl][:, i].reshape(o, ru, rv * kp))
            f_pl = torch.sum(t.reshape(o, c, rv, kp) * hv[..., None], dim=2)
            f_li = torch.matmul(hat1(pts[..., w], max(ru, rv)),
                                factors["plane_lines"][lvl][:, i])
            blocks.append(f_pl * f_li)
    return torch.cat(blocks, dim=-1)


def encode(factors, p: torch.Tensor, spec: MXGridSpec) -> torch.Tensor:
    """Encode points, plain PyTorch.

    Args:
      factors: lines [O, 3, total_res, K] or the dict of `init_mxgrid`.
      p: [O, ..., 3] points in the unit cube.
    Returns:
      [O, ..., n_output_dims] features in the parameter dtype.

    Points go through in chunks of spec.chunk under activation
    checkpointing, so the dense [C, R] bases are rebuilt in the backward
    instead of being kept (as jax.checkpoint does in the reference).
    Gradients flow to the factors and to the points.
    """
    lines = factors["lines"] if isinstance(factors, dict) else factors
    dtype = lines.dtype
    if spec.snap_levels:  # fold once per call, outside the chunk loop
        folded = fold_lines(lines, spec)
        factors = dict(factors, lines=folded) if isinstance(factors, dict) else folded
    o, batch_shape = p.shape[0], p.shape[1:-1]
    pts = p.reshape(o, -1, 3).to(dtype)
    chunks = []
    for s in range(0, pts.shape[1], spec.chunk):
        q = pts[:, s : s + spec.chunk]
        if torch.is_grad_enabled():
            chunks.append(checkpoint(_encode_chunk, factors, q, spec, use_reentrant=False))
        else:
            chunks.append(_encode_chunk(factors, q, spec))
    out = torch.cat(chunks, dim=1)
    return out.reshape(o, *batch_shape, spec.n_output_dims)
