"""solve_sketch_ms: the mean device time of the traced estimates'
``solve.sketch`` spans, the sketch inside ``solve()`` (the device trace's
busy time while each ran, `_window.busy_ms`)."""
from perfbench.metrics._window import mean_busy_ms


def read(rec):
    return mean_busy_ms(rec, "solve.sketch")
