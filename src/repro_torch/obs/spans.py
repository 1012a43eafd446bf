"""Spans: when each layer of the program started and ended, and what it did.

A span is opened at a layer boundary (``with span("solve.sketch",
device=dev):``) and, once closed, kept in a bounded in-memory ring
(`RING_LEN` finished spans, oldest dropped first) that `recorded` reads
and `clear` empties. Each finished `Span` holds

* its name, its own id, its parent's id (the innermost span open on the
  same thread when it opened) and a trace id (its parent's, or its own id
  for a span that opens with none; the server gives each request's queue
  span the request's id);
* its start and end on `time.perf_counter`, the host clock that a
  profiler trace can be mapped onto, so a span and the device operations
  under it compare directly;
* where its work is on a CUDA device, a pair of CUDA events recorded on
  the device's current stream at open and close: `Span.device_ms` reads
  their elapsed time when asked, never inside the span;
* a small dict of counts: the span's own keywords, and what `annotate`
  adds to the innermost open span on this thread. A count may be a
  tensor, summed on the host when `Span.counts` is read, so a span site
  reads nothing back from the device.

Recording is off by default. It is on inside `recording()` (the
operator's switch, for every thread of the process) and while a
`torch.profiler` session records, so a profiled window records the spans
of what it profiles. Off, a span site costs one flag check and gets a
shared no-op context: no CUDA event, no launch, no device read.

Spans are kept apart from the profiler's own ranges (no
``record_function``, no NVTX): those would come back as device-side
annotation intervals in the trace and count as device work.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = [
    "RING_LEN",
    "Span",
    "annotate",
    "clear",
    "enabled",
    "new_id",
    "record",
    "recorded",
    "recording",
    "span",
]

#: how many finished spans the ring keeps
RING_LEN = 65536

_ids = itertools.count(1)
_ring: deque = deque(maxlen=RING_LEN)
_ring_lock = threading.Lock()
_local = threading.local()
_switch_lock = threading.Lock()
_switch_depth = 0

# torch.profiler sets this module flag for the whole process while a session
# records; torch builds without it only have the calling thread's state
if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:  # pragma: no cover - older or newer torch
    _profiling = torch._C._autograd._profiler_enabled


def new_id() -> int:
    """A fresh id from the spans' own sequence (requests take theirs from
    it too, so a request's id never names another span)."""
    return next(_ids)


def enabled() -> bool:
    """Whether a span opened now is recorded."""
    return _switch_depth > 0 or _profiling()


@contextmanager
def recording():
    """Record spans on every thread while the block runs (nests)."""
    global _switch_depth
    with _switch_lock:
        _switch_depth += 1
    try:
        yield
    finally:
        with _switch_lock:
            _switch_depth -= 1


def _resolve(value):
    if isinstance(value, torch.Tensor):
        return sum(value.reshape(-1).tolist())
    return value


class Span:
    """One finished span (see the module docstring)."""

    __slots__ = ("name", "id", "parent", "trace", "start", "end", "events", "_counts", "_device_ms")

    def __init__(self, name: str, id: int, parent: int | None, trace: int, start: float, end: float,
                 counts: dict | None = None, events: tuple | None = None):
        self.name, self.id, self.parent, self.trace = name, id, parent, trace
        self.start, self.end = start, end
        self._counts = {} if counts is None else counts
        self.events = events
        self._device_ms = None

    @property
    def counts(self) -> dict:
        """The counts, tensors summed on the host."""
        return {k: _resolve(v) for k, v in self._counts.items()}

    @property
    def device_ms(self) -> float | None:
        """Milliseconds between the span's two CUDA events, or ``None`` for
        a span with no device work."""
        if self._device_ms is None and self.events is not None:
            start, end = self.events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
        return self._device_ms

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, trace={self.trace}, "
                f"seconds={self.end - self.start:.6f}, counts={self._counts})")


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(finished: Span) -> None:
    with _ring_lock:
        _ring.append(finished)


def _event(device: torch.device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Open:
    """A span being recorded: pushed on its thread's stack while open."""

    __slots__ = ("name", "device", "id", "parent", "trace", "start", "counts", "_first")

    def __init__(self, name: str, device, counts: dict):
        self.name, self.counts = name, counts
        self.device = device if device is not None and torch.device(device).type == "cuda" else None

    def __enter__(self) -> "_Open":
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else None
        self.trace = outer.trace if outer is not None else self.id
        self._first = _event(self.device) if self.device is not None else None
        self.start = time.perf_counter()
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        last = _event(self.device) if self.device is not None else None
        end = time.perf_counter()
        _stack().pop()
        events = (self._first, last) if last is not None else None
        _keep(Span(self.name, self.id, self.parent, self.trace, self.start, end, self.counts, events))


#: the shared context of a span site while recording is off
_NO_SPAN = nullcontext()


def span(name: str, *, device=None, **counts):
    """A context that records span ``name`` if recording is on when it is
    opened, with its parent's trace id. ``device``: where the span's work
    runs (CUDA events are taken only for a CUDA device); ``counts``: the
    span's first counts."""
    if not enabled():
        return _NO_SPAN
    return _Open(name, device, counts)


def annotate(**counts) -> None:
    """Add ``counts`` to the innermost span open on this thread, if any."""
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].counts.update(counts)


def record(name: str, start: float, end: float, *, trace: int | None = None, **counts) -> None:
    """Record a host-only span that has already ended (from ``start`` to
    ``end`` on the host clock), as a child of the innermost open span on
    this thread, with trace id ``trace`` (by default its parent's);
    nothing if recording is off."""
    if not enabled():
        return
    stack = getattr(_local, "stack", None)
    outer = stack[-1] if stack else None
    sid = next(_ids)
    if trace is None:
        trace = outer.trace if outer is not None else sid
    _keep(Span(name, sid, outer.id if outer is not None else None, trace, start, end, counts))


def recorded() -> list[Span]:
    """The finished spans in the ring, oldest first."""
    with _ring_lock:
        return list(_ring)


def clear() -> None:
    """Empty the ring."""
    with _ring_lock:
        _ring.clear()

