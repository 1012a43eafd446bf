"""One estimate after another: each starts when the last has returned,
until the window has passed and at least ``least`` have run."""
from __future__ import annotations

import time

__all__ = ["KEYS", "KIND", "drive"]

KIND = "estimate"
#: the traffic keys this discipline reads
KEYS = frozenset()


def drive(traffic: dict, one, t0: float, seconds: float, least: int) -> int:
    """Calls ``one(i)`` for ``i = 0, 1, ...``; returns how many ran."""
    i = 0
    while time.perf_counter() - t0 < seconds or i < least:
        one(i)
        i += 1
    return i
