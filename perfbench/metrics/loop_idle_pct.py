"""loop_idle_pct.<cells>: the share of the traced window's
``sinkhorn.loop`` spans, on the host clock, in which no device operation
ran (the loop's host reads of its flag and its launches starving the
device)."""
from perfbench.metrics._window import idle_pct


def read(rec):
    return idle_pct(rec, "sinkhorn.loop")
