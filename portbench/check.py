"""How `correct` is decided: the program's checked steps against the plain
reference (`portbench/reference/`), at the timed sizes, on the inputs the
benchmark made.

The program ran `CHECKED_STEPS` steps of the window's own call from the
benchmark's weights and random stream (`program.Readings`). The reference
follows the same steps, one object at a time, from the same weights,
draws, frames and object table, in fp32 (TF32 off around it). Compared,
by the worst slot and leaf (a leaf is one object's parameter tensor):

  loss_gap         |program's logged loss - reference's| / reference's, over
                   every step and active slot
  grad_gap         |norm of the program's first gradient (as Adam holds it)
                   - the reference's| / max(reference's norm of that leaf,
                   the median leaf's)
  change_gap       the same for the change of the parameters after the last
                   checked step, over the leaves whose reference gradient
                   is at least a thousandth of the median leaf's (others move
                   by round-off under Adam)
  ema_gap          the same for the change of the parameters' EMA (decay and
                   blend as the configuration states), which the program
                   renders and meshes from
  flip_share       the share of a slot's parameters whose first update
                   goes the other way than the reference's (Adam's first
                   step moves each by the rate, the sign of its gradient),
                   worst slot
  inactive_change  the largest change of a slot that is not active (must
                   stay bit for bit): only where the table has such slots

Norms average independent rounding away (a vector's norm moves by about
the square of its entries' relative noise), and the hash grid starts at
1e-4, where every precision gives the first step's loss to 1e-7: the
share of first updates that flip sign is what separates one precision
from the next (PERF.md, the limits).

The control puts the reference in the program's place, computed in the
precision below the configuration's (`CONTROL`). The reference is the
field module that the configuration file names (`registry.reference`).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import registry
from portbench.reference.precision import FP32, Precision

# the precision below each stated compute precision
CONTROL = {torch.bfloat16: torch.float8_e4m3fn, torch.float16: torch.float8_e4m3fn,
           torch.float32: torch.bfloat16}


class NoTF32:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def weight_seed(seed: int) -> int:
    return (seed * 2 + 1) % 2**63


def draw_seed(seed: int) -> int:
    return (seed * 2 + 2) % 2**63


def reference(cfg: dict, seed: int, n_slots: int, n_steps: int, frames: dict,
              objects: list[dict], device, q: Precision = FP32) -> dict:
    """`follow` on the run's inputs, made again from the seed: the weights
    (the field's `init_weights`) and each step's draws."""
    g = torch.Generator(device=device).manual_seed(weight_seed(seed))
    weights = registry.reference(cfg).init_weights(g, cfg, n_slots)
    gen = torch.Generator(device=device).manual_seed(draw_seed(seed))
    return follow(cfg, frames, objects, weights, draws(gen, n_slots, cfg["train"], n_steps), q)


def draws(gen: torch.Generator, n_slots: int, train: dict, steps: int):
    """Each step's (pixel offsets, background colours, jitter) for every
    slot, in the order of the draws: [steps] of ([O,R,2], [O,R,3], [O,R,S])."""
    r, s = train["rays_per_batch"], train["samples_per_ray"]
    rand = lambda *shape: torch.rand((n_slots, *shape), generator=gen, device=gen.device)
    return [(rand(r, 2), rand(r, 3), rand(r, s)) for _ in range(steps)]


def follow(cfg: dict, frames: dict, objects: list[dict], weights: dict, steps_draws,
           q: Precision = FP32) -> dict:
    """The reference's readings, shaped as the program's: losses [steps][O]
    (NaN where a slot is not followed), grad_norm, change_norm and
    ema_change_norm {leaf: [O]}, over the active objects, through the
    configuration's field (its `fresh_state` and `step`)."""
    ref = registry.reference(cfg)
    n_slots = next(iter(weights.values())).shape[0]
    steps = len(steps_draws)
    losses = np.full((steps, n_slots), np.nan)
    gn = {k: np.full(n_slots, np.nan) for k in weights}
    cn = {k: np.full(n_slots, np.nan) for k in weights}
    en = {k: np.full(n_slots, np.nan) for k in weights}
    signs = {k: torch.zeros(v.shape, dtype=torch.int8) for k, v in weights.items()}
    with NoTF32(), torch.no_grad():
        for obj in objects:
            if not obj["active"]:
                continue
            i = obj["slot"]
            p0 = {k: v[i].float() for k, v in weights.items()}
            st = ref.fresh_state(p0)
            for k in range(steps):
                d = tuple(x[i] for x in steps_draws[k])
                st, logged, seen = ref.step(st, frames, obj, d, cfg, q)
                losses[k, i] = float(logged)
                if k == 0:
                    for name, g in seen.items():
                        gn[name][i] = float(torch.linalg.vector_norm(g))
                        signs[name][i] = torch.sign(st["params"][name] - p0[name]).to(
                            torch.int8).cpu()
            for name, p in st["params"].items():
                cn[name][i] = float(torch.linalg.vector_norm(p - p0[name]))
                en[name][i] = float(torch.linalg.vector_norm(st["ema"][name] - p0[name]))
    return dict(losses=losses, grad_norm=gn, change_norm=cn, ema_change_norm=en,
                first_sign=signs)


def compare(prog: dict, refr: dict, active: np.ndarray) -> dict:
    """The numbers compared (see the module docstring)."""
    idx = np.flatnonzero(active)
    pl, rl = np.asarray(prog["losses"])[:, idx], refr["losses"][:, idx]
    out = {"loss_gap": float(np.max(np.abs(pl - rl) / np.maximum(np.abs(rl), 1e-30)))}
    names = sorted(refr["grad_norm"])
    g_ref = np.stack([refr["grad_norm"][k][idx] for k in names])  # [leaf, slot]
    moved = g_ref >= 1e-3 * np.median(g_ref)
    for name, key in (("grad_gap", "grad_norm"), ("change_gap", "change_norm"),
                      ("ema_gap", "ema_change_norm")):
        r = np.stack([refr[key][k][idx] for k in names])
        p = np.stack([np.asarray(prog[key][k])[idx] for k in names])
        gap = np.abs(p - r) / np.maximum(np.maximum(r, np.median(r)), 1e-30)
        keep = np.ones_like(moved) if key == "grad_norm" else moved
        out[name] = float(np.max(gap[keep])) if keep.any() else 0.0
    if "first_sign" in prog:
        flips = [sum(int((prog["first_sign"][k][i] != refr["first_sign"][k][i]).sum())
                     for k in refr["first_sign"])
                 / sum(refr["first_sign"][k][i].numel() for k in refr["first_sign"])
                 for i in idx]
        out["flip_share"] = float(max(flips))
    return out


def inactive_change(prog_change: dict, active: np.ndarray) -> float | None:
    idx = np.flatnonzero(~active)
    if len(idx) == 0:
        return None
    return float(max(np.max(np.asarray(v)[idx]) for v in prog_change.values()))


def program_side(r) -> dict:
    """The program's `program.Readings` as `compare` reads a side."""
    return dict(losses=r.losses, grad_norm=r.grad_norm, change_norm=r.change_norm,
                ema_change_norm=r.ema_change_norm, first_sign=r.first_sign)


def numbers(readings, refr: dict, active: np.ndarray) -> dict:
    """Every number compared for the program's readings: `compare`, and
    `inactive_change` where the table has slots that are not active."""
    out = compare(program_side(readings), refr, active)
    moved = inactive_change(readings.change_norm, active)
    if moved is not None:
        out["inactive_change"] = moved
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit; a number that is not finite fails."""
    table = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return bool(ok), table
