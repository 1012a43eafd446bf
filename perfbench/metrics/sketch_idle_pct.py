"""sketch_idle_pct: the share of the traced estimates' ``solve.sketch``
spans, on the host clock, in which no device operation ran."""
from perfbench.metrics._window import idle_pct


def read(rec):
    return idle_pct(rec, "solve.sketch")
