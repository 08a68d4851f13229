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


def test_the_programs_step_spans_with_the_backward_on_autograds_thread():
    """The program's span names (`trace.STEP_SPANS`) under its `train.step`;
    the backward's spans, their host operations and their launches on
    autograd's thread (tid 9); a kernel launched under `train.step` alone
    falls outside every step span."""
    main, grad = 1, 9
    events = [
        ev("user_annotation", "train.step", 0, 400, tid=main),
        ev("user_annotation", "batch", 0, 20, tid=main),
        ev("cuda_runtime", "cudaLaunchKernel", 5, 2, tid=main, corr=1),
        ev("user_annotation", "encode.fwd", 20, 20, tid=main),
        ev("cuda_runtime", "cudaLaunchKernel", 25, 2, tid=main, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 45, 2, tid=main, corr=3),  # between spans
        ev("user_annotation", "loss.fwd", 50, 20, tid=main),
        ev("cuda_runtime", "cudaLaunchKernel", 55, 2, tid=main, corr=4),
        ev("user_annotation", "loss.bwd", 70, 30, tid=grad),
        ev("cuda_runtime", "cudaLaunchKernel", 75, 2, tid=grad, corr=5),
        ev("user_annotation", "mlp.bwd", 100, 30, tid=grad),
        ev("cuda_runtime", "cudaLaunchKernel", 105, 2, tid=grad, corr=6),
        ev("user_annotation", "encode.bwd", 130, 70, tid=grad),
        ev("cpu_op", "HashGridBackward", 140, 50, tid=grad),
        ev("cuda_runtime", "cudaLaunchKernel", 150, 2, tid=grad, corr=7),
        ev("user_annotation", "optimizer.update", 210, 100, tid=main),
        ev("cuda_runtime", "cudaLaunchKernel", 220, 2, tid=main, corr=8),
        ev("kernel", "draws", 100, 10, tid=7, corr=1),
        ev("kernel", "hash_fwd", 110, 10, tid=7, corr=2),
        ev("kernel", "cast", 120, 5, tid=7, corr=3),
        ev("kernel", "render", 125, 15, tid=7, corr=4),
        ev("kernel", "fill", 140, 5, tid=7, corr=5),
        ev("kernel", "gemm", 145, 25, tid=7, corr=6),
        ev("kernel", "hash_bwd", 200, 30, tid=7, corr=7),  # after a 30 us gap
        ev("kernel", "adam", 230, 20, tid=7, corr=8),
    ]
    r = trace.read({"traceEvents": events}, trace.STEP_SPANS)
    assert r["span_s"] == pytest.approx({
        "batch": 10e-6, "encode.fwd": 10e-6, "loss.fwd": 15e-6, "loss.bwd": 5e-6,
        "mlp.bwd": 25e-6, "encode.bwd": 30e-6, "optimizer.update": 20e-6})
    assert "train.step" not in r["span_s"]
    assert r["busy_s"] == pytest.approx(120e-6) and r["launches"] == 8
    assert r["idle_gaps"] == [("encode.bwd/HashGridBackward", pytest.approx(30e-6))]
