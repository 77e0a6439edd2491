"""In-program spans and counters of the assign path.

Off by default.  HMMUFOTU_TIMING=1 in the environment turns the tracer
on; the environment is read once, when this module is imported (and
again by enable(), which hmm.viterbi.TIMING.clear() calls).  When off,
span() returns one shared do-nothing context manager after a single
check of the module flag ON, and count() returns after the same check.

When on, each span records its name, the batch index (given, or the
enclosing span's), the enclosing span on the same thread, the thread,
its start and end on time.perf_counter_ns() and the thread's CPU time
over it (time.thread_time_ns()).  Records stay in memory until read
(records(), counts(), summary()) or dropped (reset()).  Spans are at
batch grain: a handful per batch of reads, never one per read.

While a torch profiler is active on a span's thread, the span marks
its start in the profiler's chrome trace: a
torch.profiler.record_function(name) opened and closed at once.  (A
range held open over the span would also make a gpu_user_annotation
around the kernels launched inside it, which the profiler's key
averages then count as device time.)  The profiler records such marks
only on the thread that started it; trace_clock() maps this module's
timestamps onto the trace's clock, calibrated on the spans marked in
both, so that the spans of every thread can be placed beside the
device's intervals.
"""

from __future__ import annotations

import itertools
import os
import statistics
import threading
import time
from typing import NamedTuple

ON = bool(os.environ.get("HMMUFOTU_TIMING"))


class Span(NamedTuple):
    id: int
    name: str
    batch: int | None
    parent: int | None      # id of the enclosing span on the same thread
    thread: int             # threading.get_ident()
    start_ns: int           # time.perf_counter_ns()
    end_ns: int
    cpu_ns: int             # the thread's CPU time over the span
    profiled: bool          # marked in an active profiler's trace


_records: list[Span] = []
_counts: dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()


def enable(on: bool | None = None):
    """Turn the tracer on or off; None: on where HMMUFOTU_TIMING is set
    in the environment now."""
    global ON
    ON = bool(os.environ.get("HMMUFOTU_TIMING")) if on is None else on


def reset():
    """Drop every record and counter."""
    with _lock:
        _records.clear()
        _counts.clear()


def records() -> list[Span]:
    with _lock:
        return list(_records)


def counts() -> dict[str, int]:
    with _lock:
        return dict(_counts)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, batch: int | None = None, sink: dict | None = None):
    """A context manager timing the block as span `name`; batch: the
    batch index (default: the enclosing span's); sink: a dict to which
    the span's seconds are also added under `name`."""
    if not ON:
        return _OFF
    return _Open(name, batch, sink)


def count(name: str, n: int = 1):
    """Add n to counter `name` (the key is made at 0 where n is 0)."""
    if not ON:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def _profiling() -> bool:
    """A torch profiler is active on this thread."""
    import torch
    return torch._C._autograd._profiler_enabled()


class _Open:
    __slots__ = ("name", "batch", "sink", "id", "parent", "marked", "t0",
                 "cpu0")

    def __init__(self, name, batch, sink):
        self.name, self.batch, self.sink = name, batch, sink

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        if self.batch is None and up is not None:
            self.batch = up.batch
        self.parent = up.id if up is not None else None
        self.id = next(_ids)
        stack.append(self)
        self.cpu0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        self.marked = _profiling()
        if self.marked:
            import torch
            with torch.profiler.record_function(self.name):
                pass
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self.cpu0
        _local.stack.remove(self)
        rec = Span(self.id, self.name, self.batch, self.parent,
                   threading.get_ident(), self.t0, t1, cpu, self.marked)
        with _lock:
            _records.append(rec)
            if self.sink is not None:
                self.sink[self.name] = (self.sink.get(self.name, 0.0)
                                        + (t1 - self.t0) / 1e9)
        return False


def summary() -> str:
    """One line: seconds (and calls) by span, then the counters."""
    recs, cnt = records(), counts()
    secs: dict[str, float] = {}
    calls: dict[str, int] = {}
    for r in recs:
        secs[r.name] = secs.get(r.name, 0.0) + (r.end_ns - r.start_ns) / 1e9
        calls[r.name] = calls.get(r.name, 0) + 1
    spans = ", ".join(f"{k} {v:.3f} s/{calls[k]}"
                      for k, v in sorted(secs.items(), key=lambda kv: -kv[1]))
    counters = ", ".join(f"{k} {v}" for k, v in sorted(cnt.items()))
    return f"trace: spans {spans or 'none'}; counters {counters or 'none'}"


def trace_clock(annotations, recs: list[Span] | None = None):
    """A function from this module's perf_counter_ns timestamps to a
    profiler chrome trace's microseconds, or None where no span is in
    both.  annotations: the trace's user_annotation events as dicts
    with 'name' and 'ts' (us).  The offset is the median, over the
    marked spans, of the mark's time less the span's start, each name's
    spans paired in order with its marks where their numbers agree."""
    recs = records() if recs is None else recs
    mine: dict[str, list[int]] = {}
    for r in recs:
        if r.profiled:
            mine.setdefault(r.name, []).append(r.start_ns)
    theirs: dict[str, list[float]] = {}
    for e in annotations:
        if e["name"] in mine:
            theirs.setdefault(e["name"], []).append(float(e["ts"]))
    offs = []
    for name, ts in theirs.items():
        starts = mine[name]
        if len(ts) == len(starts):
            offs += [t - s / 1e3 for t, s in zip(sorted(ts), sorted(starts))]
    if not offs:
        return None
    off = statistics.median(offs)
    return lambda ns: ns / 1e3 + off
