"""Host-side runtime metrics: counters, gauges, and quantile histograms.

A copy of ``repro.obs.metrics`` (host-only Python, no array code), kept in
the port so that it imports nothing of the reference. A `MetricsRegistry`
is a thread-safe bag of named metrics for the Python-level orchestration
layers (the batched executor and the OT server, once ported); it never
runs on the device. Histograms keep a bounded window of raw observations
(exact p50/p95/p99 over the last `HISTOGRAM_WINDOW` samples) plus running
count/sum, so long-running servers don't grow unboundedly.

Compound updates that must be atomic with respect to readers (e.g. a
server's stats reset vs an in-flight dispatch recording latencies) run
under ``registry.locked()`` — the registry lock is reentrant, so metric
methods remain usable inside the block.

`export` renders a snapshot either as structured JSON event rows
(``fmt="json"``) or Prometheus text exposition (``fmt="prometheus"``:
real cumulative ``_bucket{le="..."}``/``_sum``/``_count`` histogram
families over the `DEFAULT_BUCKETS` ladder — scrapeable by
``histogram_quantile()`` — plus windowed-exact quantiles as a companion
``_quantile`` gauge family). A module-level `default_registry` serves code
that doesn't inject its own.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from collections import deque
from contextlib import contextmanager
from typing import Iterator

__all__ = [
    "DEFAULT_BUCKETS",
    "HISTOGRAM_WINDOW",
    "MetricsRegistry",
    "default_registry",
    "export",
]

#: bounded per-histogram observation window for exact quantiles
HISTOGRAM_WINDOW = 8192

#: Prometheus-style cumulative bucket ladder (upper bounds, ``le``
#: semantics). Log-spaced 1-2.5-5 decades covering sub-millisecond
#: latencies up to tens of seconds — which also serves the unit-interval
#: ratios (batch fill, occupancy) and certificate gaps we record.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
)

_QUANTILES = (0.5, 0.95, 0.99)


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated quantile of an already-sorted list."""
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    if lo == hi:
        return sorted_vals[lo]
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class _Histogram:
    __slots__ = ("window", "count", "total", "bucket_counts")

    def __init__(self) -> None:
        self.window: deque[float] = deque(maxlen=HISTOGRAM_WINDOW)
        self.count = 0
        self.total = 0.0
        # per-slot (non-cumulative) counts over DEFAULT_BUCKETS; values past
        # the last bound live only in the implicit +Inf bucket (= count).
        # Cumulative-since-start, unlike the bounded quantile window.
        self.bucket_counts = [0] * len(DEFAULT_BUCKETS)

    def observe(self, value: float) -> None:
        self.window.append(value)
        self.count += 1
        self.total += value
        i = bisect.bisect_left(DEFAULT_BUCKETS, value)
        if i < len(DEFAULT_BUCKETS):
            self.bucket_counts[i] += 1

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """``(le, cumulative_count)`` pairs in Prometheus ``le`` semantics
        (the +Inf bucket is ``count`` and is left to the exporter)."""
        out: list[tuple[float, int]] = []
        c = 0
        for le, k in zip(DEFAULT_BUCKETS, self.bucket_counts):
            c += k
            out.append((le, c))
        return out

    def snapshot(self) -> dict:
        vals = sorted(self.window)
        out = {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count if self.count else 0.0,
        }
        for q in _QUANTILES:
            out[f"p{int(q * 100)}"] = _quantile(vals, q)
        return out


class MetricsRegistry:
    """Named counters, gauges, and windowed-quantile histograms.

    All mutators and readers take the registry's reentrant lock, so single
    calls are atomic; wrap multi-metric invariants in ``with locked():``.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, _Histogram] = {}

    # ------------------------------------------------------------- mutators

    def counter(self, name: str, inc: float = 1.0) -> None:
        """Increment a monotone counter (created at 0 on first use)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time gauge."""
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """Record one histogram observation."""
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = _Histogram()
            hist.observe(float(value))

    @contextmanager
    def locked(self) -> Iterator["MetricsRegistry"]:
        """Hold the registry lock across a compound update or read — e.g.
        an atomic reset that must not interleave with an in-flight dispatch
        recording into the same histograms."""
        with self._lock:
            yield self

    def reset(self, prefix: str = "") -> None:
        """Drop all metrics whose name starts with ``prefix`` ('' = all)."""
        with self._lock:
            for store in (self._counters, self._gauges, self._histograms):
                for name in [n for n in store if n.startswith(prefix)]:
                    del store[name]

    # -------------------------------------------------------------- readers

    def get_counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def get_gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    def get_histogram(self, name: str) -> dict:
        """Snapshot dict: count / sum / mean / p50 / p95 / p99 (zeros if
        the histogram doesn't exist yet)."""
        with self._lock:
            hist = self._histograms.get(name)
            return hist.snapshot() if hist else _Histogram().snapshot()

    def snapshot(self, include_buckets: bool = False) -> dict:
        """Consistent point-in-time copy of every metric.

        ``include_buckets=True`` adds each histogram's cumulative
        ``"buckets"`` list (``(le, count)`` pairs) — used by the Prometheus
        exporter; the default keeps the JSON-facing shape unchanged."""
        with self._lock:
            hists = {}
            for n, h in self._histograms.items():
                snap = h.snapshot()
                if include_buckets:
                    snap["buckets"] = h.cumulative_buckets()
                hists[n] = snap
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": hists,
            }


#: shared registry used by instrumented components unless one is injected
default_registry = MetricsRegistry()


def _prom_name(name: str) -> str:
    """Sanitize a metric name for Prometheus exposition (dots -> underscores)."""
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def export(fmt: str = "json", registry: MetricsRegistry | None = None) -> str:
    """Render a registry snapshot.

    ``fmt="json"``: one structured event row per metric —
    ``{"metric": name, "type": kind, ...values}`` — as a JSON array.
    ``fmt="prometheus"``: text exposition; each histogram becomes a real
    ``histogram`` family — cumulative ``_bucket{le="..."}`` counters over
    `DEFAULT_BUCKETS` (plus ``le="+Inf"``), ``_sum`` and ``_count`` — so
    ``histogram_quantile()`` works server-side; the windowed-exact
    p50/p95/p99 are kept as a companion ``<name>_quantile`` gauge family.
    """
    reg = registry if registry is not None else default_registry
    snap = reg.snapshot(include_buckets=fmt == "prometheus")
    if fmt == "json":
        rows = []
        for name, v in sorted(snap["counters"].items()):
            rows.append({"metric": name, "type": "counter", "value": v})
        for name, v in sorted(snap["gauges"].items()):
            rows.append({"metric": name, "type": "gauge", "value": v})
        for name, h in sorted(snap["histograms"].items()):
            rows.append({"metric": name, "type": "histogram", **h})
        return json.dumps(rows, indent=2)
    if fmt == "prometheus":
        lines: list[str] = []
        for name, v in sorted(snap["counters"].items()):
            pn = _prom_name(name)
            lines += [f"# TYPE {pn} counter", f"{pn} {v:g}"]
        for name, v in sorted(snap["gauges"].items()):
            pn = _prom_name(name)
            lines += [f"# TYPE {pn} gauge", f"{pn} {v:g}"]
        for name, h in sorted(snap["histograms"].items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} histogram")
            for le, c in h["buckets"]:
                lines.append(f'{pn}_bucket{{le="{le:g}"}} {c}')
            lines.append(f'{pn}_bucket{{le="+Inf"}} {h["count"]}')
            lines += [f"{pn}_sum {h['sum']:g}", f"{pn}_count {h['count']}"]
            lines.append(f"# TYPE {pn}_quantile gauge")
            for q in _QUANTILES:
                lines.append(
                    f'{pn}_quantile{{quantile="{q:g}"}} {h[f"p{int(q * 100)}"]:g}'
                )
        return "\n".join(lines) + "\n"
    raise ValueError(f"unknown export format {fmt!r} (use 'json' or 'prometheus')")
