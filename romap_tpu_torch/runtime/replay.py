"""Deterministic record/replay of online-manager call traces.

The reference's online path is only testable by running full ORB-SLAM2; its
README warns results vary run-to-run (threading + randomness, README.md:96).
Here the manager API is pure host calls, so a recorded trace of
(dataset_init / new_frame_to_dataset / create_nerf / update_nerf_bbox /
pump / wait_threads_end) replays bit-identically — the fake-SLAM-frontend
fixture of SURVEY.md §4(d).
"""

from __future__ import annotations

import pickle
from typing import Any

RECORDED = (
    "dataset_init",
    "new_frame_to_dataset",
    "update_dataset",
    "create_nerf",
    "update_nerf_bbox",
    "pump",
    "wait_threads_end",
)


class TraceRecorder:
    """Proxy that forwards calls to a manager while recording them."""

    def __init__(self, manager):
        self._manager = manager
        self.trace: list[tuple[str, tuple, dict]] = []

    def __getattr__(self, name: str):
        target = getattr(self._manager, name)
        if name in RECORDED and callable(target):
            def wrapper(*args, **kwargs):
                self.trace.append((name, args, kwargs))
                return target(*args, **kwargs)

            return wrapper
        return target

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.trace, f)


def load_trace(path: str) -> list[tuple[str, tuple, dict]]:
    with open(path, "rb") as f:
        return pickle.load(f)


def replay(trace: list[tuple[str, tuple, dict]] | str, manager) -> None:
    if isinstance(trace, str):
        trace = load_trace(trace)
    for name, args, kwargs in trace:
        getattr(manager, name)(*args, **kwargs)
