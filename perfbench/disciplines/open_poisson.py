"""Independent callers: an open loop of Poisson arrivals at the fixed rate
``rate_per_s``. Each request is due at its arrival time and is sent then,
whatever is outstanding; it is timed from when it was due."""
from __future__ import annotations

import math
import time

import torch

from perfbench.harness.inputs import SHARED, generator

__all__ = ["KEYS", "KIND", "drive", "offsets"]

KIND = "serve"
#: the traffic keys this discipline reads
KEYS = frozenset({"rate_per_s"})


def offsets(rate: float, seconds: float, gen: torch.Generator) -> list[float]:
    """Due times of a Poisson stream at ``rate`` over ``seconds``: the gaps
    are the ``floor(rate * seconds)`` midpoint quantiles of the exponential
    distribution, in an order drawn from ``gen``, so all of them are due
    within the window."""
    count = int(rate * seconds)
    gaps = [-math.log(1.0 - (k + 0.5) / count) / rate for k in range(count)]
    order = torch.randperm(count, generator=gen).tolist()
    due, t = [], 0.0
    for k in order:
        due.append(t)
        t += gaps[k]
    return due


def drive(traffic: dict, feed, first: int, t0: float, length: float, tag: str) -> list:
    """Requests ``first, first + 1, ...`` at their due times over ``length``
    seconds from ``t0``. The order of the gaps is the same for every seed
    (drawn from `SHARED` and ``tag``), so every run offers the same bursts."""
    sent = []
    for k, off in enumerate(offsets(traffic["rate_per_s"], length, generator("cpu", SHARED, tag))):
        due = t0 + off
        with feed.spans.span("wait"):
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        sent.append(feed.send(first + k, due))
    return sent
