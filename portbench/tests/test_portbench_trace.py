"""The trace reader on a small hand-made Chrome trace."""

import pytest

from portbench import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_spans_busy_and_gaps():
    events = [
        ev("user_annotation", "encode forward", 0, 50),
        ev("cpu_op", "aten::mm", 5, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 8, 2, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 2, corr=2),
        ev("user_annotation", "optimizer", 60, 40),
        ev("cuda_runtime", "cudaLaunchKernel", 70, 2, corr=3),
        ev("kernel", "k1", 100, 20, tid=7, corr=1),
        ev("kernel", "k2", 110, 30, tid=7, corr=2),  # overlaps k1
        ev("kernel", "k3", 200, 10, tid=7, corr=3),
    ]
    r = trace.read({"traceEvents": events}, ("encode forward", "optimizer"))
    assert r["busy_s"] == pytest.approx(50e-6)
    assert r["launches"] == 3
    assert r["span_s"]["encode forward"] == pytest.approx(50e-6)
    assert r["span_s"]["optimizer"] == pytest.approx(10e-6)
    assert r["idle_gaps"] == [("optimizer/idle", pytest.approx(60e-6))]
    assert r["device_ops"][0] == ("k2", pytest.approx(30e-6))
