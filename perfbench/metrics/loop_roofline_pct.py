"""loop_roofline_pct: an iteration's least time over the sketch
(`perfbench.roofline.loop`, at the traced estimates' mean nnz) over its
device time: the traced estimates' device time, less the sketch's device
time (profiled after the window), over their iterations."""
from perfbench.roofline import loop


def read(rec):
    trace = rec.get("trace")
    iters = rec.get("traced_iters")
    if trace is None or not iters or "sketch_device_s" not in rec:
        return None
    total, _ = trace.op_seconds(lambda name: True)
    loop_s = total / len(iters) - rec["sketch_device_s"]
    per_iter_ms = loop_s / (sum(iters) / len(iters)) * 1e3
    if per_iter_ms <= 0:
        return None
    nnz = sum(rec["traced_nnz"]) / len(rec["traced_nnz"])
    return loop.bound_ms(round(nnz), rec["n"], rec["n"]) / per_iter_ms * 100
