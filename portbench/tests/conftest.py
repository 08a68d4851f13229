"""The benchmark's own tests: `python3 -m pytest portbench/tests -q` from the
repo root (CPU; tests marked `card` run only where a CUDA card is, decided
inside the `card` fixture)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tiny sizes the CPU runs in seconds; the shapes of the cells, scaled down
TINY_CONFIG = {"encoding": dict(mx_levels=2, mx_max_resolution=32, mx_features=8,
                                mx_plane_res=[16, 8], mx_plane_features=2, n_levels=4,
                                log2_hashmap_size=10),
               "train": dict(rays_per_batch=64, samples_per_ray=8, mc_resolution=17)}
TINY_TRAFFIC = {"offline": {"scene": dict(res=48, frames=12, objects=4), "steps_per_wave": 2}}
WORKLOAD = "tcnn.offline.room10"
# the configuration files the tests run the cell's traffic with: the cell's
# own (the hash grid), and the MX-grid of `configs/flagship.json` (K1/K2's
# path), which no cell runs yet
CONFIGS = ["tcnn", "flagship"]


def tiny(workload: str, dtype: str = "auto", config: str | None = None) -> dict:
    """Overrides that run `workload` at tiny sizes in `dtype`, with the
    encoding of `portbench/configs/<config>.json` where given."""
    import json

    from portbench import registry
    entry = registry.cell(workload)["traffic"]["entry"]
    cfg = {k: dict(v) for k, v in TINY_CONFIG.items()}
    if config is not None:
        with open(os.path.join(ROOT, "portbench", "configs", f"{config}.json")) as f:
            cfg["encoding"] = {**json.load(f)["encoding"], **cfg["encoding"]}
    cfg["train"]["compute_dtype"] = dtype
    return {"config": cfg, "traffic": TINY_TRAFFIC[entry]}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
