"""The program's own spans and counters (hmmufotu_tpu_torch.utils.trace,
the tracer HMMUFOTU_TIMING=1 turns on), as the per-layer metrics of
metrics/ read them.

A metric's install(patches, store) calls install() here: the tracer is
turned on through the window's patches, so that their undo() turns it
off, and its records are emptied; read(run) then finds the tracer in
run['store'].  Nothing wraps the program's functions.  A program that
has no tracer leaves the store empty, and every reading here is None.
"""

from __future__ import annotations


def install(patches, store):
    try:
        from hmmufotu_tpu_torch.utils import trace
    except ImportError:
        return
    patches.set(trace, "ON", True)
    trace.reset()
    store["trace"] = trace


def records(run, name):
    """The window's spans called name, or None without a tracer."""
    trace = run["store"].get("trace")
    if trace is None:
        return None
    return [r for r in trace.records() if r.name == name]


def per_kread(run, name):
    """Seconds in span name, summed over its calls, per 1,000 rows of the
    window; None where it never ran."""
    recs = records(run, name)
    if not recs or not run["rows"]:
        return None
    return 1000.0 * sum(r.end_ns - r.start_ns for r in recs) / 1e9 \
        / run["rows"]


def counter_pct(run, part, whole):
    """100 x counter part over counter whole; None where whole is 0 or
    was never counted."""
    trace = run["store"].get("trace")
    if trace is None:
        return None
    c = trace.counts()
    if not c.get(whole):
        return None
    return 100.0 * c.get(part, 0) / c[whole]


def capture_device(patches, store):
    """Keep, from the traced window's chrome trace as the harness exports
    it, the device's merged busy intervals, the trace's window and its
    user_annotation events: torch.profiler.profile is replaced for the
    window by a subclass whose export_chrome_trace also reads them."""
    import torch.profiler as tp

    from . import probes
    base = tp.profile

    class Profile(base):
        def export_chrome_trace(self, path):
            out = super().export_chrome_trace(path)
            events = probes.read_trace(path)
            busy = probes.device_busy(events)
            spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("ph") == "X" and "dur" in e]
            if busy is not None:
                store["busy"] = busy[2]
                store["window"] = (min(a for a, _ in spans),
                                   max(b for _, b in spans))
            store["annotations"] = [
                dict(name=e["name"], ts=float(e["ts"]),
                     dur=float(e.get("dur", 0.0)), tid=e.get("tid"))
                for e in events if e.get("cat") == "user_annotation"]
            return out

    patches.set(tp, "profile", Profile)


def idle(busy, lo, hi):
    """The gaps of the sorted, merged intervals busy within [lo, hi]."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def overlap(xs, ys):
    """Total length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    tot = 0.0
    while i < len(xs) and j < len(ys):
        a, b = xs[i]
        c, d = ys[j]
        tot += max(0.0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            j += 1
    return tot
