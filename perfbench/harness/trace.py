"""The harness's own spans and the device trace of a traced window.

Spans are recorded around the harness's calls into the program's layers
(``estimate``, ``sketch``, ``submit``, ``wait``) on the host clock
(`time.perf_counter`), kept in memory. A traced window runs under
`torch.profiler`; its device operations (kernels, copies, sets) come back
as intervals on the same host clock, aligned through a marker that the
harness records when the profiler starts. The profiler's own host cost
(several microseconds a launch) slows a launch-bound window, so the idle
share it reads is an upper bound.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = ["DeviceTrace", "Spans", "breakdown", "union_seconds"]


class Spans:
    """``(name, start, end)`` on the host clock, appended from any thread."""

    def __init__(self) -> None:
        self.items: list[tuple[str, float, float]] = []
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.items.append((name, t0, t1))

    def open_at(self, t: float) -> str:
        """The innermost span open at host time ``t`` (the latest started),
        or ``"none"``."""
        best = None
        for name, t0, t1 in self.items:
            if t0 <= t <= t1 and (best is None or t0 > best[1]):
                best = (name, t0)
        return best[0] if best else "none"


@dataclass
class DeviceTrace:
    """The device operations of one traced window, on the host clock."""

    start: float = 0.0
    end: float = 0.0
    ops: list[tuple[float, float, str]] = field(default_factory=list)
    _prof: object = None
    _mark: float = 0.0

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        # no sync here: a served window's trace opens while the server is busy
        with record_function("perfbench.mark"):
            self._mark = time.perf_counter()
        self.start = self._mark

    def finish(self) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.end = time.perf_counter()
        self._prof.__exit__(None, None, None)
        # the raw records: building the profiler's event tree would cost
        # seconds of host time a hundred thousand launches
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        marks = [e.start_ns() for e in events if e.name() == "perfbench.mark"]
        if not marks:
            raise RuntimeError("the profiler recorded no marker: its device times cannot be placed")
        offset = self._mark - marks[0] / 1e9
        self.ops = sorted(
            (e.start_ns() / 1e9 + offset, e.end_ns() / 1e9 + offset, e.name())
            for e in events
            if e.device_type() == DeviceType.CUDA and e.end_ns() > e.start_ns()
        )

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def intervals(self) -> list[tuple[float, float]]:
        """The merged intervals in which some device operation ran, clipped
        to the window."""
        merged: list[list[float]] = []
        for t0, t1, _ in self.ops:
            t0, t1 = max(t0, self.start), min(t1, self.end)
            if t1 <= t0:
                continue
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return union_seconds(self.intervals())

    def op_seconds(self, match) -> tuple[float, int]:
        """Summed device seconds and count of the operations whose name
        ``match(name)`` accepts."""
        total, count = 0.0, 0
        for t0, t1, name in self.ops:
            if match(name):
                total += t1 - t0
                count += 1
        return total, count


def union_seconds(intervals) -> float:
    return sum(b - a for a, b in intervals)


def breakdown(trace: DeviceTrace, spans: Spans, top: int = 10) -> dict:
    """The device operations that took the most time, and the longest idle
    gaps, each named by the harness's span open at its middle."""
    by_name: dict[str, float] = {}
    for t0, t1, name in trace.ops:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    prev = trace.start
    for a, b in trace.intervals() + [(trace.end, trace.end)]:
        if a > prev:
            gaps.append((a - prev, spans.open_at((a + prev) / 2)))
        prev = max(prev, b)
    gaps.sort(key=lambda g: -g[0])
    return {
        "device_ops": [[name[:120], sec] for name, sec in ops],
        "idle_gaps": [[name, sec] for sec, name in gaps[:top]],
    }
