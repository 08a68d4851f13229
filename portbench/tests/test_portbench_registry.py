"""BENCHMARK.json against the contract's shape, and every part of a cell
found by name."""

import json
import os
import re

import pytest

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
B = registry.benchmark()


def test_keys_and_names():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= B["run_seconds"] <= 51
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {"obj_iters_per_s", "setup_s"} <= {m["name"] for m in B["end_to_end"]}
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] == "obj_iters_per_s"
    assert os.path.getsize(os.path.join(registry.ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in B["workloads"]])
def test_cell_found_by_name(workload):
    from portbench.program import ENTRIES
    c = registry.cell(workload)
    assert c["traffic"]["entry"] in ENTRIES
    assert c["config"]["name"] == c["workload"]["config"]
    assert set(c["limits"]) >= {"loss_gap", "grad_gap", "change_gap"}
    assert {m["name"] for m in c["end_to_end"]} == {"obj_iters_per_s", "setup_s"}
    for m in c["per_layer"]:
        assert callable(registry.reader(m["name"]))


def test_config_files_state_the_program_config():
    from portbench.program import nerf_config
    for c in B["configs"]:
        with open(os.path.join(registry.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == []
        n = nerf_config(cfg)
        assert n.encoding.kind == cfg["encoding"]["kind"]
        assert n.train.rays_per_batch * n.train.samples_per_ray == 4096 * 32


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        registry.cell("no.such.cell")
