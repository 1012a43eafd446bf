"""gen_lag_ms.<mix>: the 99th percentile (nearest rank) of how late the
harness submitted a request after its due time (under a closed loop
a request is due when it is sent, so this reads about 0)."""
import math


def read(rec):
    lags = sorted(rec.get("gen_lag_s") or [])
    if not lags:
        return None
    return lags[max(math.ceil(0.99 * len(lags)) - 1, 0)] * 1e3
