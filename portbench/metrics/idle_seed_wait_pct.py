"""idle_seed_wait_pct: The share, in %, of the card's idle time in the traced window during which
the stream's main thread waited for the seed-search worker (the program's span wait_seed), its
spans mapped onto the device trace's clock by the tracer's calibration on the spans in both."""

from portbench import progtrace

LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"


def install(patches, store):
    progtrace.install(patches, store)
    progtrace.capture_device(patches, store)


def read(run):
    store = run["store"]
    trace, busy = store.get("trace"), store.get("busy")
    if trace is None or busy is None:
        return None
    recs = trace.records()
    clock = trace.trace_clock(store["annotations"], recs)
    if clock is None:
        return None
    idle = progtrace.idle(busy, *store["window"])
    total = sum(b - a for a, b in idle)
    if not total:
        return None
    waits = sorted((clock(r.start_ns), clock(r.end_ns)) for r in recs
                   if r.name == "wait_seed")
    return 100.0 * progtrace.overlap(idle, waits) / total
