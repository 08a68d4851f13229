"""The optimizer's update on the card: kernel A1 (csrc/optimizer.cu).

One train step's update of every parameter leaf, per object slot:
optax's chain(zero_nans, add_decayed_weights(l2), scale_by_adam), the
exponential-decay rate, the EMA of the params, and the per-slot keep
(inactive slots and empty batches keep params, EMA and optimizer state bit
for bit), as romap_tpu/models/nerf.py runs it in jnp and optax.

`update` picks by device alone: CPU tensors go to the plain twin
`update_plain` (eager PyTorch, some 28 elementwise launches a leaf); CUDA
tensors launch A1, one pass over each leaf, once for up to `MAX_LEAVES`
leaves, or raise (a leaf not fp32, not contiguous or not 16-byte aligned;
a shape that differs from its param's). No failure of the build or of a
launch is caught. The [O] vectors (the bias corrections from `count + 1`,
`learning_rate`, the slots kept) are a few torch ops on either path; A1
reads them from the device. A1's arithmetic rounds where the twin's does,
so the two agree bit for bit.

The update returns fresh tensors, or writes into the tensors of `out=` (a
CUDA graph of the train step keeps its state there): the old state is not
changed. A1's launches are counted on `update.launches`
(`cuda_lib.launch_counts()` reports them as A1), and every call counts the
elements it updated under `optimizer.fused_params` (tracing on).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.utils import _pytree as pytree

from romap_tpu_torch.config import NerfConfig
from romap_tpu_torch.ops import cuda_lib
from romap_tpu_torch.utils import tracing

MAX_LEAVES = 16  # kMaxLeaves of csrc/optimizer.cu

_ptr, _i32, _ptrs = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
_int64s, _floats = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)
# the C entry of csrc/optimizer.cu: A1 (dtype code first, stream last)
ARGTYPES = {"romap_adam_ema": [_i32] * 2 + [_ptrs, _int64s, _floats] + [_ptr] * 5 + [_i32, _ptr]}
cuda_lib.declare(ARGTYPES)


def learning_rate(cfg: NerfConfig, step: torch.Tensor) -> torch.Tensor:
    """ExponentialDecay around Adam: lr * base^n, n = max(0, (step - start)
    // interval + 1), per object."""
    o = cfg.optimizer
    n = torch.clamp(torch.div(step - o.decay_start, o.decay_interval,
                              rounding_mode="floor") + 1, min=0)
    return o.learning_rate * torch.pow(o.decay_base, n.float())


def _per_object(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[O] -> [O, 1, ..., 1] broadcastable against `like`."""
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


# --------------------------------------------------------------------------
# The plain twin
# --------------------------------------------------------------------------


def _optimizer_update(grads, opt, params, cfg: NerfConfig):
    """optax chain(zero_nans, add_decayed_weights, scale_by_adam), leafwise:
    returns (updates, new AdamState)."""
    o = cfg.optimizer
    b1, b2 = o.beta1, o.beta2
    count = opt.count + 1
    c1 = 1 - torch.pow(b1, count.float())
    c2 = 1 - torch.pow(b2, count.float())
    flat_g, treedef = pytree.tree_flatten(grads)
    flat_p = pytree.tree_leaves(params)
    flat_mu = pytree.tree_leaves(opt.mu)
    flat_nu = pytree.tree_leaves(opt.nu)
    found, ups, mus, nus = [], [], [], []
    for g, p, mu, nu in zip(flat_g, flat_p, flat_mu, flat_nu):
        nan = torch.isnan(g)
        found.append(nan.reshape(nan.shape[0], -1).any(dim=1))
        g = torch.where(nan, torch.zeros_like(g), g)
        g = g + o.l2_reg * p
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g**2 + b2 * nu
        mu_hat = mu / _per_object(c1, mu)
        nu_hat = nu / _per_object(c2, nu)
        ups.append(mu_hat / (torch.sqrt(nu_hat) + o.epsilon))
        mus.append(mu)
        nus.append(nu)
    unflat = lambda xs: pytree.tree_unflatten(xs, treedef)
    return unflat(ups), opt._replace(found_nan=unflat(found), count=count, mu=unflat(mus),
                                     nu=unflat(nus))


def update_plain(grads, state, ok: torch.Tensor, cfg: NerfConfig):
    """A1's twin: (params, ema, opt) after one step of `state` (a
    TrainState: params, ema, opt, step) with gradients `grads`, the slots
    where `ok` [O] is false kept as they were."""
    updates, new_opt = _optimizer_update(grads, state.opt, state.params, cfg)
    lr = learning_rate(cfg, state.step)
    new_params = pytree.tree_map(lambda p, u: p - _per_object(lr, u) * u,
                                 state.params, updates)
    decay = cfg.optimizer.ema_decay
    new_ema = pytree.tree_map(lambda e, p: decay * e + (1.0 - decay) * p,
                              state.ema, new_params)
    keep = lambda old, new: pytree.tree_map(
        lambda a, b: torch.where(_per_object(ok, b), b, a), old, new)
    return keep(state.params, new_params), keep(state.ema, new_ema), keep(state.opt, new_opt)


# --------------------------------------------------------------------------
# The kernel
# --------------------------------------------------------------------------


def _consts(cfg: NerfConfig):
    """1 - b1, b1, 1 - b2, b2, l2, eps, decay, 1 - decay, each formed in
    Python's doubles and rounded to fp32, as PyTorch rounds a Python number
    it multiplies or adds to an fp32 tensor."""
    o = cfg.optimizer
    vals = (1 - o.beta1, o.beta1, 1 - o.beta2, o.beta2, o.l2_reg, o.epsilon, o.ema_decay,
            1.0 - o.ema_decay)
    return (ctypes.c_float * 8)(*(float(np.float32(v)) for v in vals))


def _written(out, new):
    """`out`'s (params, ema, opt), `new`'s (params, ema, opt) copied in."""
    for o, n in zip(pytree.tree_leaves((out.params, out.ema, out.opt)),
                    pytree.tree_leaves(new)):
        o.copy_(n)
    return out.params, out.ema, out.opt


@cuda_lib.counted
def update(grads, state, ok: torch.Tensor, cfg: NerfConfig, out=None):
    """(params, ema, opt) after one optimizer step, as `update_plain`: A1 for
    CUDA tensors, the twin for CPU ones. `state` is a TrainState; `grads` a
    tree like its params; `ok` [O] bool, the slots that take the step. With
    `out` (a TrainState like `state` that shares no memory with it) the
    result is written into its params, EMA and optimizer state, which are
    returned, and no new tensor is made for it."""
    flat_p, treedef = pytree.tree_flatten(state.params)
    tracing.count("optimizer.fused_params", sum(p.numel() for p in flat_p))
    dev = state.step.device
    if not cuda_lib.on_card(state.step, torch.float32):
        new = update_plain(grads, state, ok, cfg)
        return new if out is None else _written(out, new)
    o = cfg.optimizer
    count = state.opt.count + 1
    c1 = 1 - torch.pow(o.beta1, count.float())
    c2 = 1 - torch.pow(o.beta2, count.float())
    lr = learning_rate(cfg, state.step)
    n_obj = state.step.shape[0]
    cuda_lib.check("ok", ok, (n_obj,), torch.bool, dev)
    ins = {"g": pytree.tree_leaves(grads), "p": flat_p, "mu": pytree.tree_leaves(state.opt.mu),
           "nu": pytree.tree_leaves(state.opt.nu), "ema": pytree.tree_leaves(state.ema)}
    found_old = pytree.tree_leaves(state.opt.found_nan)
    if {len(v) for v in ins.values()} | {len(found_old)} != {len(flat_p)}:
        raise ValueError("grads, params, moments, EMA and found_nan differ in their leaves")
    for name, leaves in ins.items():
        for i, (t, p) in enumerate(zip(leaves, flat_p)):
            cuda_lib.check(f"{name}[{i}]", t, p.shape, torch.float32, p.device, align=16)
    for i, f in enumerate(found_old):
        cuda_lib.check(f"found_nan[{i}]", f, (n_obj,), torch.bool, dev)
    if out is None:
        outs = [[torch.empty_like(p) for p in flat_p] for _ in range(4)]  # p, mu, nu, ema
        found = [torch.empty_like(f) for f in found_old]
    else:
        outs = [pytree.tree_leaves(t) for t in (out.params, out.opt.mu, out.opt.nu, out.ema)]
        found = pytree.tree_leaves(out.opt.found_nan)
        if {len(v) for v in outs} | {len(found)} != {len(flat_p)}:
            raise ValueError("out differs from the state in its leaves")
        for name, leaves in zip(("p", "mu", "nu", "ema"), outs):
            for i, (t, p) in enumerate(zip(leaves, flat_p)):
                cuda_lib.check(f"out {name}[{i}]", t, p.shape, torch.float32, dev, align=16)
        for i, f in enumerate(found):
            cuda_lib.check(f"out found_nan[{i}]", f, (n_obj,), torch.bool, dev)
    starts = range(0, len(flat_p), MAX_LEAVES)
    # a launch's NaN flags and finished-tile counters, zeroed
    scratch = torch.zeros((len(starts), 2 * MAX_LEAVES * n_obj), dtype=torch.int32, device=dev)
    consts = _consts(cfg)
    for part, s in zip(scratch, starts):
        leaves = range(s, min(s + MAX_LEAVES, len(flat_p)))
        ptrs = [t.data_ptr() for i in leaves
                for t in (*(v[i] for v in ins.values()), *(v[i] for v in outs), found_old[i],
                          found[i])]
        rows = [flat_p[i].numel() // max(n_obj, 1) for i in leaves]
        cuda_lib.launch(
            KERNELS["A1"], "A1 optimizer update", "romap_adam_ema", torch.float32, dev, len(leaves),
            (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int64 * len(rows))(*rows), consts,
            c1.data_ptr(), c2.data_ptr(), lr.data_ptr(), ok.data_ptr(), part.data_ptr(), n_obj)
    unflat = lambda xs: pytree.tree_unflatten(xs, treedef)
    params, mu, nu, ema = map(unflat, outs)
    count = torch.where(ok, count, state.opt.count, out=None if out is None else out.opt.count)
    opt = state.opt._replace(found_nan=unflat(found), count=count, mu=mu, nu=nu)
    return params, ema, opt


KERNELS = cuda_lib.register({"A1": update}, rank=2)
