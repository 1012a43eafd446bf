"""b1_roofline_pct: kernel B1's least time (`perfbench.roofline.b1`, at
k = s drawn pairs, the mode of the cell's domain) over its device time a
launch, ``pack_rows`` plus the gather, from the traced estimates."""
from perfbench.roofline import b1


def read(rec):
    trace = rec.get("trace")
    if trace is None or "s" not in rec:
        return None
    seconds, _ = trace.op_seconds(lambda name: "pack_rows" in name or "gathered_" in name)
    _, launches = trace.op_seconds(lambda name: "gathered_" in name)
    if launches == 0 or seconds <= 0:
        return None
    mode = "cost" if rec["domain"] == "log" else "kernel"
    return b1.bound_ms(rec["n"], rec["d"], round(rec["s"]), mode) / (seconds / launches * 1e3) * 100
