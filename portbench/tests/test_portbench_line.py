"""The result line: its keys in both modes, the compared numbers last, and
no result without a card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import CONFIGS, ROOT, WORKLOAD, tiny
from portbench import run


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("config", CONFIGS)
def test_keys(config, trace):
    out = run.run_cell(WORKLOAD, 2**33 + 1, 0.5, trace, device="cpu",
                       overrides=tiny(WORKLOAD, "float32", config))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "compared"
    assert out["correct"] is True and out["attempted"] > 0
    assert all(set(v) == {"value", "limit"} for v in out["compared"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    names = set(out["metrics"])
    if not trace:
        assert names == {"obj_iters_per_s", "setup_s"}
        assert out["metrics"]["obj_iters_per_s"]["value"] > 0
    else:
        assert "breakdown" in out and "busy_s" in out["device"]
        assert {"mesh_ms", "host_issue_ms"} <= names
    assert out["window"]["units"] >= 1
    json.dumps(out)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", WORKLOAD,
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and portbench/ runs nothing."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", WORKLOAD,
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
def test_one_run_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", WORKLOAD,
                        "--seed", "12345678901", "--seconds", "5", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
