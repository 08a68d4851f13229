"""Reading a `torch.profiler` trace of a few train steps.

The profiler's Chrome trace is read as data: device operations (kernels,
copies, sets) with their start and length on the card's clock, the CUDA
runtime calls that launched them (joined by their correlation id), the
host operations and the program's own spans on the launching thread (its
tracing enters `record_function(name)` for each span while the profiler
runs; the backward pass's spans open and close in tensor hooks on
autograd's thread, which launches those kernels). From them:

  busy_s      the union of the device operations' intervals
  launches    how many kernels ran
  span_s      device seconds under each span: a kernel belongs to the
              innermost span open on its launching thread when it was
              launched
  device_ops  device seconds by operation name, largest first
  idle_gaps   the gaps between device operations, by what the host was
              doing when it launched the operation after the gap (its span
              and its innermost host operation), longest first
"""

from __future__ import annotations

import bisect
import collections
import json

# the spans of one train step, as the program names them
# (`romap_tpu_torch/models/nerf.py::STEP_SPANS`; written here, not imported):
# `batch` opens twice a step, around the draws and around the batch
STEP_SPANS = ("batch", "encode.fwd", "mlp.fwd", "loss.fwd", "loss.bwd", "mlp.bwd",
              "encode.bwd", "optimizer.update")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _corr(e):
    a = e.get("args", {})
    return a.get("correlation", a.get("External id"))


class _Intervals:
    """Host intervals of one thread, for the innermost one holding a time."""

    def __init__(self, events):
        self.ev = sorted(events, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.ev]

    def innermost(self, ts):
        """The latest-starting interval that holds `ts` (spans nest)."""
        i = bisect.bisect_right(self.starts, ts) - 1
        for j in range(i, max(i - 200, -1), -1):
            e = self.ev[j]
            if ts <= e["ts"] + e.get("dur", 0):
                return e
        return None


def read(trace: dict | str, spans: tuple[str, ...]) -> dict:
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    launch = {_corr(e): e for e in events if e.get("cat") in LAUNCH_CATS and _corr(e) is not None}
    by_tid_span = collections.defaultdict(list)
    by_tid_op = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in spans:
            by_tid_span[e["tid"]].append(e)
        elif e.get("cat") == "cpu_op":
            by_tid_op[e["tid"]].append(e)
    span_iv = {t: _Intervals(v) for t, v in by_tid_span.items()}
    op_iv = {t: _Intervals(v) for t, v in by_tid_op.items()}

    def host_of(dev):
        """(span, host op) open when `dev` was launched."""
        lc = launch.get(_corr(dev))
        if lc is None:
            return None, None
        tid, ts = lc["tid"], lc["ts"]
        sp = span_iv[tid].innermost(ts) if tid in span_iv else None
        op = op_iv[tid].innermost(ts) if tid in op_iv else None
        return (sp["name"] if sp else None), (op["name"] if op else None)

    busy = 0.0
    end = None
    span_s = collections.Counter()
    ops = collections.Counter()
    gaps = collections.Counter()
    for e in device:
        ts, te = e["ts"], e["ts"] + e.get("dur", 0)
        sp, op = host_of(e)
        if end is not None and ts > end:
            gaps[f"{sp or 'outside spans'}/{op or 'idle'}"] += (ts - end) / 1e6
        if end is None or ts > end:
            busy += te - ts
            end = te
        elif te > end:
            busy += te - end
            end = te
        ops[e["name"]] += e.get("dur", 0) / 1e6
        if sp is not None:
            span_s[sp] += e.get("dur", 0) / 1e6
    return dict(
        busy_s=busy / 1e6,
        launches=sum(1 for e in device if e.get("cat") == "kernel"),
        span_s=dict(span_s),
        device_ops=ops.most_common(10),
        idle_gaps=gaps.most_common(10),
    )
