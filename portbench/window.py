"""The measured window: whole units of the traffic's repeating pattern.

A unit is one mesh period: `mesh_every_waves` waves of training and the
mesh round that closes them. Every boundary is a point where the runner
has synchronised with the card (its own `.cpu()` barrier after a wave, and
a mesh ends in host work on the mesh's vertices). The window opens at one
boundary and closes at a later one; its rate is the work of the units
between them over the time between them. The window holds the traffic's `window_units` units, fewer
where a unit as long as the last would end past `--seconds`: a unit that
is not timed is not started. A fixed count keeps the work of a run the
same from seed to seed, where units grow longer as the fields train (the
meshes gain vertices).
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Unit:
    seconds: float
    obj_steps: int  # active object slot-steps trained
    steps: int  # train steps (each over every slot)


class Window:
    """Boundaries as they come: `open()` at the first, `close_unit()` at
    each later one. `want_more()` says whether another unit is due."""

    def __init__(self, seconds: float, max_units: int, clock=time.perf_counter):
        self.seconds = seconds
        self.max_units = max_units
        self.clock = clock
        self.t0 = None
        self.last = None
        self.units: list[Unit] = []
        self.closed = False

    def open(self) -> None:
        self.t0 = self.last = self.clock()

    def close_unit(self, obj_steps: int, steps: int) -> None:
        now = self.clock()
        self.units.append(Unit(now - self.last, obj_steps, steps))
        self.last = now

    def want_more(self) -> bool:
        """Whether another unit is due: fewer than `max_units` so far, and a
        unit as long as the last still ends inside `seconds` of the window's
        opening (there is always a first)."""
        if not self.units:
            return True
        return (len(self.units) < self.max_units
                and (self.last - self.t0) + self.units[-1].seconds <= self.seconds)

    @property
    def window_s(self) -> float:
        return sum(u.seconds for u in self.units)

    def rate(self) -> float:
        """Active object-steps a second over the whole units."""
        return sum(u.obj_steps for u in self.units) / self.window_s

    def step_seconds(self) -> float:
        """Window time per train step (mesh rounds included)."""
        return self.window_s / sum(u.steps for u in self.units)
