"""device_idle_pct: The share of the traced window in which no kernel, copy or set ran on the card."""

LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"


def read(run):
    busy, win = run.get("busy_s"), run.get("trace_window_s")
    if not busy or not win:
        return None
    return 100.0 * (1.0 - busy / win)
