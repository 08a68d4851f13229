"""Move a train state between romap_tpu (JAX) and the port, as numpy.

The JAX side hands over `jax.device_get(state)`: its TrainState with numpy
leaves (params, ema, opt_state, key, step, loss). The optax chain's state
is read by position, (ZeroNansState(found_nan), EmptyState(),
ScaleByAdamState(count, mu, nu)), so this module needs neither jax nor
optax. The params' "table" is whatever the encoding holds (MX-grid lines,
planes and plane lines, or the hash table [O, total_params, F]); it moves
leaf by leaf like the rest. The PRNG key stays on the JAX side: the port
draws its uniforms from a torch.Generator or a replay source.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from romap_tpu_torch.models.nerf import AdamState, TrainState


def _to_torch(tree, device):
    return pytree.tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def _to_numpy(tree):
    return pytree.tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def train_state_from_jax(jstate, device="cpu") -> TrainState:
    """A JAX TrainState with numpy leaves -> the port's TrainState."""
    zero_nans, _, adam = jstate.opt_state
    return TrainState(
        params=_to_torch(jstate.params, device),
        ema=_to_torch(jstate.ema, device),
        opt=AdamState(
            found_nan=_to_torch(zero_nans[0], device),
            count=_to_torch(adam[0], device),
            mu=_to_torch(adam[1], device),
            nu=_to_torch(adam[2], device),
        ),
        step=_to_torch(jstate.step, device),
        loss=_to_torch(jstate.loss, device),
    )


def train_state_to_numpy(state: TrainState) -> dict:
    """The port's TrainState -> numpy leaves in the JAX layout:
    {"params", "ema", "opt_state": (found_nan, count, mu, nu), "step",
    "loss"}; the caller rebuilds the optax state tuple from "opt_state"."""
    return {
        "params": _to_numpy(state.params),
        "ema": _to_numpy(state.ema),
        "opt_state": _to_numpy((state.opt.found_nan, state.opt.count,
                                state.opt.mu, state.opt.nu)),
        "step": _to_numpy(state.step),
        "loss": _to_numpy(state.loss),
    }
