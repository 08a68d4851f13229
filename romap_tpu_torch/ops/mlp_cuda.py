"""Each network's last product on the card: kernels M1 and M2 (csrc/mlp.cu).

  M1 `forward`   h [O, P, K], w [O, K, N] -> out [O, P, N] fp32, the sums
                 in fp32 (`torch.bmm(h.float(), w.float())`)
  M2 `backward`  h, w, dy [O, P, N] fp32 -> (dh in h's dtype, dw in w's
                 dtype), each summed in fp32 and rounded once, in one pass
                 over the points; a second launch adds the weight
                 gradient's block partials in a fixed order

`last_product` is the network's last matrix (`ops/mlp._chain`). It picks by
device alone: a CPU tensor runs the plain twin, `torch.bmm(h.float(),
w.float())` with autograd's own backward, bit for bit what the port ran
before these kernels; a CUDA tensor goes through `_LastProduct`, whose
forward is M1 and whose backward is M2 for the gradients asked for (dw
alone where h needs none, dh alone where w needs none: pose refinement).
The node keeps h and w, the tensors the ReLU before it and the cast of the
weights keep already: no fp32 copy of h exists.

`forward` and `backward` have plain twins (`forward_plain`,
`backward_plain`: autograd's arithmetic of the twin, written out) and take
them for CPU tensors; a CUDA tensor launches the kernel or raises: h and w
of one dtype (float32 or bfloat16), contiguous, h 16-byte aligned, K a
multiple of 8 up to `MAX_IN`, N up to `MAX_OUT`; dy fp32 and contiguous.
No failure of the build or of a launch is caught. Launches count on the
wrappers (`cuda_lib.launch_counts()`: M1, M2, after A1; M2 counts its
sum's launch too), and each call on the card counts its points under
`mlp.fused_points` (tracing on).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from romap_tpu_torch.ops import cuda_lib
from romap_tpu_torch.utils import tracing

MAX_IN, MAX_OUT = 128, 32  # kMaxIn, kMaxOut of csrc/mlp.cu
BLOCK_POINTS = 1024  # points a block of M2 (kTileP x kBwdTiles): one partial each

_ptr, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the C entries of csrc/mlp.cu: M1, M2 and M2's sum (dtype code first, stream last)
ARGTYPES = {
    "romap_last_fwd": [_i32] + [_ptr] * 3 + [_i32, _i64, _i32, _i32, _ptr],
    "romap_last_bwd": [_i32] + [_ptr] * 5 + [_i32, _i64] + [_i32] * 5 + [_ptr],
    "romap_last_bwd_sum": [_i32] + [_ptr] * 2 + [_i32] * 4 + [_ptr],
}
cuda_lib.declare(ARGTYPES)


# --------------------------------------------------------------------------
# The plain twins
# --------------------------------------------------------------------------


def forward_plain(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """M1's twin: [O, P, N] fp32."""
    return torch.bmm(h.float(), w.float())


def backward_plain(h, w, dy, need_dh: bool = True, need_dw: bool = True):
    """M2's twin: autograd's backward of `forward_plain` (bmm's two
    products in fp32, each cast back to its input's dtype); None where a
    gradient is not needed."""
    dh = torch.bmm(dy, w.float().transpose(1, 2)).to(h.dtype) if need_dh else None
    dw = torch.bmm(h.float().transpose(1, 2), dy).to(w.dtype) if need_dw else None
    return dh, dw


# --------------------------------------------------------------------------
# The kernels
# --------------------------------------------------------------------------


def _check(h: torch.Tensor, w: torch.Tensor) -> tuple[int, int, int, int]:
    """(O, P, K, N) of a product the kernels take, or raise."""
    if h.ndim != 3 or w.ndim != 3:
        raise ValueError(f"last product: h {tuple(h.shape)} and w {tuple(w.shape)} "
                         "must be [O, P, K] and [O, K, N]")
    (o, p, k), n = h.shape, w.shape[2]
    if k % 8 or not 8 <= k <= MAX_IN:
        raise NotImplementedError(f"last product: input width {k}; the kernels take "
                                  f"multiples of 8 up to {MAX_IN}")
    if not 1 <= n <= MAX_OUT:
        raise NotImplementedError(f"last product: output width {n}; the kernels take "
                                  f"1 to {MAX_OUT}")
    cuda_lib.check("h", h, (o, p, k), h.dtype, h.device, align=16)  # 16-byte copies of rows
    cuda_lib.check("w", w, (o, k, n), h.dtype, h.device)
    return o, p, k, n


@cuda_lib.counted
def forward(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """M1 (its twin for CPU tensors)."""
    dt, dev = h.dtype, h.device
    if not cuda_lib.on_card(h, dt):
        return forward_plain(h, w)
    o, p, k, n = _check(h, w)
    out = torch.empty((o, p, n), dtype=torch.float32, device=dev)
    cuda_lib.launch(forward, "M1 last product", "romap_last_fwd", dt, dev, h.data_ptr(),
                    w.data_ptr(), out.data_ptr(), o, p, k, n)
    return out


@cuda_lib.counted
def backward(h, w, dy, need_dh: bool = True, need_dw: bool = True):
    """M2 (its twin for CPU tensors): (dh, dw), None where not needed."""
    dt, dev = h.dtype, h.device
    if not cuda_lib.on_card(h, dt):
        return backward_plain(h, w, dy, need_dh, need_dw)
    o, p, k, n = _check(h, w)
    cuda_lib.check("dy", dy, (o, p, n), torch.float32, dev)
    blocks = -(-p // BLOCK_POINTS)
    dh = torch.empty_like(h) if need_dh else None
    dw = torch.empty_like(w) if need_dw else None
    partials = (torch.empty((o, blocks, k, n), dtype=torch.float32, device=dev)
                if need_dw else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    if need_dh or need_dw:
        cuda_lib.launch(backward, "M2 last product backward", "romap_last_bwd", dt, dev,
                        h.data_ptr(), w.data_ptr(), dy.data_ptr(), ptr(dh), ptr(partials), o, p,
                        k, n, blocks, int(need_dh), int(need_dw))
    if need_dw:
        cuda_lib.launch(backward, "M2 weight gradient sum", "romap_last_bwd_sum", dt, dev,
                        partials.data_ptr(), dw.data_ptr(), o, k, n, blocks)
    return dh, dw


KERNELS = cuda_lib.register({"M1": forward, "M2": backward}, rank=3)


# --------------------------------------------------------------------------
# The differentiable product
# --------------------------------------------------------------------------


class _LastProduct(torch.autograd.Function):
    """Forward: M1. Backward: M2 for the gradients asked for, once
    differentiable: a graph built through it (`create_graph`) raises where
    it is differentiated, as no kernel computes M2's own derivative."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return forward(h, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        return backward(h, w, dy.contiguous(), *ctx.needs_input_grad)


def last_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [O, P, K] @ w [O, K, N] -> [O, P, N] fp32: the plain twin with
    autograd's backward for CPU tensors, M1 and M2 for CUDA ones."""
    if h.device.type == "cpu":
        return forward_plain(h, w)
    tracing.count("mlp.fused_points", h.shape[0] * h.shape[1])
    return _LastProduct.apply(h, w)
