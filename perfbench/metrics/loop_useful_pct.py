"""loop_useful_pct.<cells>: of the element iterations the traced window's
``sinkhorn.loop`` spans launched (``batch`` x ``launched``, padding
duplicates counted as elements), the share that advanced an element
(``element_iters``); the rest ran past a stop, frozen."""
from perfbench.metrics._window import spans_in


def read(rec):
    useful = launched = 0
    for s in spans_in(rec, "sinkhorn.loop"):
        counts = s.counts
        useful += counts["element_iters"]
        launched += counts["batch"] * counts["launched"]
    return useful / launched * 100 if launched else None
