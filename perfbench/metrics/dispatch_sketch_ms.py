"""dispatch_sketch_ms.<mix>: the mean device time of the executor's
``executor.sketch`` spans in the traced window, a bucket's sketches built
and padded apart from its loop (the device trace's busy time while each
ran, `_window.busy_ms`)."""
from perfbench.metrics._window import mean_busy_ms


def read(rec):
    return mean_busy_ms(rec, "executor.sketch")
