"""dispatch_ms.<mix>: the mean of the executor's ``dispatch_seconds`` over
the window (a bucket's batched solve, ending in a device sync)."""


def read(rec):
    hist = rec.get("dispatch")
    return hist["mean"] * 1e3 if hist and hist["count"] else None
