"""mfu.<cell>: the traced steps' model operations
(``records["step_flops"]``, `perfbench.roofline.ssm_decode`) over the
traced window's wall time, as a share of the bfloat16 dense peak."""
from perfbench.roofline.peaks import BF16_FLOPS


def read(rec):
    trace = rec.get("trace")
    if trace is None or not rec.get("traced_steps") or trace.window_s <= 0:
        return None
    return rec["step_flops"] * rec["traced_steps"] / trace.window_s / BF16_FLOPS * 100
