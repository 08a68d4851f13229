"""Precision of the reference's forward values: fp32, or the control's
narrower type."""

from __future__ import annotations

import torch

F32 = torch.float32


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x through `dtype` and back to fp32; an 8-bit float is scaled per
    tensor to its largest value first."""
    scale = 1.0
    if torch.finfo(dtype).bits == 8:
        scale = torch.finfo(dtype).max / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(F32) / scale


class _Rounded(torch.autograd.Function):
    """A value rounded forward, and its gradient rounded backward."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return _round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype), None


class Precision:
    """None: fp32. Otherwise a torch dtype that every weight at use, the
    encode's output and each hidden activation is rounded to, and each of
    their gradients on the way back (sums stay fp32, as tensor cores keep
    them): the forward and backward of a path that computes in `dtype`."""

    def __init__(self, dtype=None):
        self.dtype = dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return x
        return _Rounded.apply(x, self.dtype)


FP32 = Precision()
