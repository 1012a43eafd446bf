"""device_idle_pct.<cells>: the share of the traced window in which no
device operation ran (1 minus the union of their intervals)."""


def read(rec):
    trace = rec.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return (1.0 - trace.busy_s() / trace.window_s) * 100
