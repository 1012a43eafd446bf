"""loop_iter_ms.<cells>: the device time of the traced window's
``sinkhorn.loop`` spans (the device trace's busy time while each ran,
`_window.busy_ms`) over the iterations they launched (a padded batch's
iteration counts once)."""
from perfbench.metrics._window import busy_ms, on_device, spans_in


def read(rec):
    loops = on_device(spans_in(rec, "sinkhorn.loop"))
    launched = sum(s.counts["launched"] for s in loops)
    return sum(busy_ms(rec, loops)) / launched if launched else None
