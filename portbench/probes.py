"""What a traced run records around the program: host spans from
wrappers of the functions the assign CLI calls, what each per-layer
metric's own module installs (such as the kernels' launches with the
shapes their work is counted from), and the profiler window.

Frozen copies, from commit 7ecd7fc: device_busy and the profiler part
of profile_window (scripts/torch_scale_assign.py); the wrappers follow
clock and StreamStages (scripts/torch_scale_cli.py).  The program is
not edited: its module attributes are replaced for the run and put
back after it.
"""

from __future__ import annotations

import gzip
import json
import threading
import time

import numpy as np


class Patches:
    """Replaced attributes, restored by undo()."""

    def __init__(self):
        self.saved = []

    def set(self, owner, name, value):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        for owner, name, value in reversed(self.saved):
            setattr(owner, name, value)
        self.saved.clear()


class Spans:
    """Seconds inside each wrapped function, summed over every call on
    whatever thread makes it, and each call's (span, start, end) in log
    (for labelling the device's idle gaps)."""

    def __init__(self):
        self.s: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.log: list[tuple[str, float, float]] = []
        self.lock = threading.Lock()

    def wrap(self, patches, owner, name, keys):
        """Time owner.name as each of the spans keys (a name or a list)."""
        fn = getattr(owner, name)
        spans = self
        keys = [keys] if isinstance(keys, str) else list(keys)

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                e = time.perf_counter()
                with spans.lock:
                    for key in keys:
                        spans.s[key] = spans.s.get(key, 0.0) + e - t
                        spans.calls[key] = spans.calls.get(key, 0) + 1
                        spans.log.append((key, t, e))

        patches.set(owner, name, timed)


class Instruments:
    """What the selected per-layer metrics need in a traced window, each
    declared in its own metrics/<name>.py:

    - SPANS: [(module, attribute, span)]: the program's function
      module.attribute (a dotted path inside the module, such as
      'ViterbiAligner.finalize_batch') is timed as that span; a function
      that several metrics name is wrapped once and timed as each span;
    - KERNELS: {key: substring}: the device seconds of the kernels whose
      names hold the substring, read from the trace as kernel_s[key];
    - install(patches, store): any other wrapper, which records into
      the metric's own store (run['store'] when it is read);
    - read(run): the metric's number from the window's record, or None.
    """

    def __init__(self, root: str, metrics: list[dict]):
        self.root = root
        self.patches, self.spans = Patches(), Spans()
        self.mods = {m["name"]: metric_module(root, m["name"])
                     for m in metrics}
        self.stores = {name: {} for name in self.mods}
        self.kernels = {}
        for mod in self.mods.values():
            self.kernels.update(getattr(mod, "KERNELS", {}))

    def install(self):
        import importlib
        keys = {}
        for mod in self.mods.values():
            for module, attr, key in getattr(mod, "SPANS", ()):
                got = keys.setdefault((module, attr), [])
                if key not in got:
                    got.append(key)
        for (module, attr), got in keys.items():
            owner = importlib.import_module(module)
            *path, last = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            self.spans.wrap(self.patches, owner, last, got)
        for name, mod in self.mods.items():
            if hasattr(mod, "install"):
                mod.install(self.patches, self.stores[name])

    def undo(self):
        self.patches.undo()

    def read(self, name, run):
        mod = self.mods.get(name) or metric_module(self.root, name)
        return mod.read(dict(run, store=self.stores.get(name, {})))


def metric_module(root: str, name: str):
    """portbench/metrics/<name>.py, loaded by its name."""
    import importlib.util
    import os
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_kread(run, key):
    """Seconds in a span per 1,000 rows of the window; None where the
    span never ran."""
    s = run["spans"].get(key)
    if s is None or not run["rows"]:
        return None
    return 1000.0 * s / run["rows"]


def roofline(run, key, work_fn):
    """A kernel's share of its roofline in %: work_fn(store) gives the
    (bytes, operations) of the window's launches, kernel_s[key] their
    device time."""
    from .work import roofline_pct
    t = run.get("kernel_s", {}).get(key)
    w = work_fn(run["store"]) if run.get("store") else None
    if not t or not w:
        return None
    return roofline_pct(w[0], w[1], t)[0]


def device_busy(events) -> tuple[float, float, list] | None:
    """(device-busy us, window us, device intervals) of a chrome trace's
    events: the union of the card's kernel, copy and set intervals, over
    the span from the first to the last event.  None when the trace
    holds no device event."""
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        spans.append((ts, ts + dur))
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((ts, ts + dur))
    if not dev:
        return None
    busy, end, merged = 0.0, -np.inf, []
    for a, b in sorted(dev):
        if b <= end:
            continue
        busy += b - max(a, end)
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
        end = b
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    return busy, window, merged


def read_trace(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh).get("traceEvents", [])


def device_ops(prof, torch, n=10) -> list:
    """[[name, seconds], ...] of the device operations that took most
    time, from the profiler's key averages."""
    def dev_us(e):
        for k in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, k):
                return float(getattr(e, k))
        return 0.0
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(ev, key=dev_us, reverse=True)[:n]
    return [[e.key[:120], dev_us(e) / 1e6] for e in rows if dev_us(e) > 0]


def kernel_seconds(events, names) -> dict:
    """Device seconds of the kernels whose names hold each given
    substring, from the trace."""
    out = {k: 0.0 for k in names}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            for key, sub in names.items():
                if sub in e.get("name", ""):
                    out[key] += float(e["dur"]) / 1e6
    return out


def idle_gaps(merged, span_log, t0_host, t0_trace, n=10) -> list:
    """The longest idle gaps of the device, each labelled with the host
    span open at the middle of the gap (or 'other')."""
    gaps = []
    for (a, b), (c, d) in zip(merged[:-1], merged[1:]):
        if c > b:
            gaps.append((c - b, b, c))
    gaps.sort(reverse=True)
    out = []
    for dur, b, c in gaps[:n]:
        mid = t0_host + ((b + c) / 2 - t0_trace) / 1e6
        label = "other"
        for key, s, e in span_log:
            if s <= mid <= e:
                label = key
                break
        out.append([label, dur / 1e6])
    return out
