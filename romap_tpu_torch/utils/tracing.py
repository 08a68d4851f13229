"""Spans and counters of the port's own layers (counterpart of
romap_tpu/utils/profiling.py::Timers, whose summary `summary()` gives:
count, median, mean and total, here per parent's name and name).

Off by default. With tracing off, `span` returns one shared do-nothing
context and `count`, `backward_span` and `backward_spans` return at once:
no clock is read, nothing is allocated, no tensor hook is registered and no
`record_function` is entered.

With tracing on (`enable()`), each span is kept in memory: its name, its
parent (the span open on the same thread when it opened, from a per-thread
stack), its thread, the identifiers of the work it belongs to (its own
keywords over its parent's: `wave`, `step`, `object`) and its start and end
from `time.perf_counter_ns()`. While a `torch.profiler` session is active,
and only then, a span also enters `torch.profiler.record_function(name)`,
so that it lies on the device trace's timeline beside the kernels it
launched. A counter record is a name, a number and the identifiers of the
span open where it was counted; counters are taken only where the host
already holds the value or has already waited on the card.

The backward pass runs on autograd's thread (one a device on CUDA): its
spans open and close in tensor hooks there. `backward_spans()` opens a
chain for one backward pass on the thread that will start it;
`backward_span(tensor, name)` switches the chain to `name` when the pass
reaches `tensor`'s gradient, and the chain's last span closes when the pass
ends. Their parent is the span open where the chain was opened.

`drain()` returns the records and the counters and clears them;
`write_chrome_trace` writes a drained set as Chrome trace JSON, with the
kernels' launch counts that its caller read for the same interval.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import threading
import time

import torch

_on = False
_records: list = []  # closed spans
_counters: list = []
_ids = itertools.count()
_local = threading.local()
_OFF = contextlib.nullcontext()  # the one context of tracing off


class _Record:
    __slots__ = ("name", "id", "parent", "thread", "ids", "start_ns", "end_ns")

    def __init__(self, name, parent, ids):
        self.name = name
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.thread = threading.get_ident()
        self.ids = {**parent.ids, **ids} if parent is not None else ids
        self.start_ns = time.perf_counter_ns()
        self.end_ns = None

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


def _profiler_active() -> bool:
    return torch._C._autograd._profiler_enabled()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "ids", "rec", "rf")

    def __init__(self, name, ids):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = _stack()
        self.rec = _Record(self.name, stack[-1] if stack else None, self.ids)
        stack.append(self.rec)
        self.rf = None
        if _profiler_active():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec.end_ns = time.perf_counter_ns()
        _stack().pop()
        _records.append(self.rec)
        return False


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, **ids):
    """A context that records the span `name` (tracing on) or does nothing."""
    if not _on:
        return _OFF
    return _Span(name, ids)


def count(name: str, n, **ids) -> None:
    """Add `n` under `name`, with `ids` over the identifiers of the span
    open here."""
    if not _on:
        return
    stack = _stack()
    _counters.append(dict(name=name, n=n, ids={**stack[-1].ids, **ids} if stack else ids,
                          t_ns=time.perf_counter_ns()))


class _Chain:
    """Spans that follow one another on the thread that runs one backward
    pass; the open one closes when the next opens or the pass ends."""

    def __init__(self, parent):
        self.parent = parent
        self.rec = self.rf = None
        self.queued = False

    def switch(self, name):
        if not self.queued:  # the first hook of the pass: close at its end
            torch.autograd.Variable._execution_engine.queue_callback(self.close)
            self.queued = True
        self.close()
        self.rec = _Record(name, self.parent, {})
        if _profiler_active():
            self.rf = torch.profiler.record_function(name)
            self.rf.__enter__()

    def close(self):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        if self.rec is not None:
            self.rec.end_ns = time.perf_counter_ns()
            _records.append(self.rec)
            self.rec = None

    def __enter__(self):
        _local.chain = self
        return self

    def __exit__(self, *exc):
        _local.chain = None
        self.close()  # a pass that raised
        return False


def backward_spans():
    """The chain of spans of the backward pass that the block starts."""
    if not _on:
        return _OFF
    stack = _stack()
    return _Chain(stack[-1] if stack else None)


def backward_span(tensor: torch.Tensor, name: str) -> None:
    """Inside `backward_spans()`: open `name` when the backward pass reaches
    `tensor`'s gradient (the chain's open span closes)."""
    if not _on:
        return
    chain = getattr(_local, "chain", None)
    if chain is not None and tensor.requires_grad:
        tensor.register_hook(lambda grad: chain.switch(name))


def drain() -> dict:
    """{"spans": [record dicts by start], "counters": [...]}; both are
    cleared."""
    spans = sorted((r.as_dict() for r in list(_records)), key=lambda r: r["start_ns"])
    counters = list(_counters)
    del _records[: len(spans)], _counters[: len(counters)]
    return dict(spans=spans, counters=counters)


def summary(drained: dict) -> dict:
    """Of a drained set: per span, keyed "parent/name" by the name of the
    span it opened under (its name alone where none was open), so that
    `train.step/encode.fwd` and `mesh.density/encode.fwd` stay apart:
    count, median_ms, mean_ms, total_s; per counter name: count and total."""
    names = {r["id"]: r["name"] for r in drained["spans"]}
    by_key: dict[str, list[float]] = {}
    for r in drained["spans"]:
        key = f"{names[r['parent']]}/{r['name']}" if r["parent"] in names else r["name"]
        by_key.setdefault(key, []).append((r["end_ns"] - r["start_ns"]) / 1e9)
    out = {key: dict(count=len(v), median_ms=1e3 * statistics.median(v),
                     mean_ms=1e3 * statistics.fmean(v), total_s=sum(v))
           for key, v in by_key.items()}
    counters: dict[str, dict] = {}
    for c in drained["counters"]:
        s = counters.setdefault(c["name"], dict(count=0, total=0))
        s["count"] += 1
        s["total"] += c["n"]
    return dict(spans=out, counters=counters)


def write_chrome_trace(path: str, drained: dict, launches: dict) -> None:
    """The drained spans as Chrome trace events ("X", microseconds on the
    perf_counter clock; args: the identifiers and the parent's id), and the
    counters' records, `launches` (kernel: launches over the same interval)
    and the summary under their own keys."""
    pid = os.getpid()
    events = [dict(name=r["name"], ph="X", cat="romap", pid=pid, tid=r["thread"],
                   ts=r["start_ns"] / 1e3, dur=(r["end_ns"] - r["start_ns"]) / 1e3,
                   args=dict(r["ids"], id=r["id"], parent=r["parent"]))
              for r in drained["spans"]]
    with open(path, "w") as f:
        json.dump(dict(traceEvents=events, displayTimeUnit="ms", counters=drained["counters"],
                       launches=launches, summary=summary(drained)), f)
