"""state_hbm_pct.<cell>: a step's least bytes (``records["step_min_bytes"]``,
`perfbench.roofline.ssm_decode`: the decode state read and written once,
the weights read once, the logits written once) over its device time (the
traced steps' busy time, the union of their device operations, a step),
as a share of the HBM peak."""
from perfbench.roofline.peaks import HBM_BYTES_PER_S


def read(rec):
    trace = rec.get("trace")
    if trace is None or not rec.get("traced_steps"):
        return None
    busy = trace.busy_s()
    if busy <= 0:
        return None
    return rec["step_min_bytes"] / HBM_BYTES_PER_S / (busy / rec["traced_steps"]) * 100
