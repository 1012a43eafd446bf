"""Static batches decoded in lockstep, one after another: every sequence
of a batch is fed ``prompt_len`` prompt tokens one position at a time and
then decoded greedily for ``gen_len`` positions, and the next batch starts
when the last one's final step is done. The window closes after the step
that passes its end, once at least ``least`` batches are whole."""
from __future__ import annotations

import time

__all__ = ["KEYS", "KIND", "drive"]

KIND = "lm_decode"
#: the traffic keys this discipline reads
KEYS = frozenset({"prompt_len", "gen_len"})


def drive(traffic: dict, step, t0: float, seconds: float, least: int) -> int:
    """Calls ``step(b, i)`` for position ``i`` of batch ``b``, in order;
    returns how many steps ran."""
    steps = traffic["prompt_len"] + traffic["gen_len"]
    done, b = 0, 0
    while True:
        for i in range(steps):
            step(b, i)
            done += 1
            if b >= least and time.perf_counter() - t0 >= seconds:
                return done
        b += 1
        if b >= least and time.perf_counter() - t0 >= seconds:
            return done
