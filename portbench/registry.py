"""Finding a cell's parts by name: its entry in `BENCHMARK.json`, its
configuration file, its traffic file (`portbench/traffic/<traffic>.json`),
its limits (`portbench/limits/<workload>.json`), the plain reference of
its configuration's field (`portbench/reference/<reference>.py`, named by
the configuration file's `"reference"`) and the reader of each per-layer
metric (`portbench/metrics/<metric>.py`, a `read(ctx)` that returns a
number or None). A later cell, mix, field or metric is new files and new
entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """{workload, config, traffic, limits, end_to_end, per_layer} of one
    workload: the files' contents and the metrics that apply to it."""
    b = benchmark(root)
    wl = {w["name"]: w for w in b["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(wl)})")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in b["configs"]}[w["config"]]
    applies = lambda m: name in m.get("workloads", [name])
    e2e = [m for m in b["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in b["per_layer"] if applies(m) and m["moves"] in e2e_names]
    return dict(
        workload=w,
        config=_load(os.path.join(root, cfg_entry["file"])),
        traffic=_load(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
        limits=_load(os.path.join(HERE, "limits", f"{name}.json")),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def reader(metric: str):
    """The `read(ctx)` of `portbench/metrics/<metric>.py`."""
    return importlib.import_module(f"portbench.metrics.{metric}").read


def reference(cfg: dict):
    """The field module (`portbench/reference/__init__.py`'s contract) that
    a configuration file names under `"reference"`."""
    from portbench.reference import FIELD

    name = cfg["reference"]
    mod = importlib.import_module(f"portbench.reference.{name}")
    missing = [f for f in FIELD if not hasattr(mod, f)]
    if missing:
        raise ValueError(f"portbench.reference.{name} is not a field: it lacks {missing}")
    return mod
