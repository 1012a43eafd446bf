"""A closed loop of ``clients`` clients: each sends its next request when
its last one resolves, so as many requests are outstanding all the time.
A request is due when its client sends it."""
from __future__ import annotations

import queue
import time

__all__ = ["KEYS", "KIND", "drive"]

KIND = "serve"
#: the traffic keys this discipline reads
KEYS = frozenset({"clients"})


def drive(traffic: dict, feed, first: int, t0: float, length: float, tag: str) -> list:
    """Requests ``first, first + 1, ...`` over ``length`` seconds from
    ``t0``; returns those sent."""
    sent = []
    freed: "queue.Queue[int]" = queue.Queue()

    def client(i: int, due: float) -> None:
        sent.append(feed.send(i, due, lambda: freed.put(1)))

    for c in range(traffic["clients"]):
        client(first + c, t0)
    nxt = first + traffic["clients"]
    close = t0 + length
    while (now := time.perf_counter()) < close:
        with feed.spans.span("wait"):
            try:
                freed.get(timeout=close - now)
            except queue.Empty:
                continue
        client(nxt, time.perf_counter())
        nxt += 1
    return sent
