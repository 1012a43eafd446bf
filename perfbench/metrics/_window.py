"""The program's own spans (`repro_torch.obs.spans`) in a traced window,
for the readers of the span metrics.

A profiled window records the program's spans; a reader takes those that
descend from a ``solve`` or ``serve.batch`` span and lie inside the
window (the sketch timed after an estimate window calls the public
builders, which record none). A program without spans gives none, and
its readers return ``None``.

A span's device time here is the device trace's busy time (the union of
its operations) while the span's work can run: from the span's host
start to the later of its host end and its end event's place on the
stream (its start plus the stream time between its two CUDA events), so
work still queued when the host leaves counts and the stream's waits for
the host do not."""
from bisect import bisect_right

#: the spans under which the readers take a span
ROOTS = ("solve", "serve.batch")


def descends(spans) -> list:
    """The spans of ``spans`` whose own name or an ancestor's (through the
    parent ids among ``spans``) is one of `ROOTS`."""
    by_id = {s.id: s for s in spans}
    keep: dict[int, bool] = {}

    def under(s) -> bool:
        chain = []
        found = False
        while s is not None:
            if s.id in keep:
                found = keep[s.id]
                break
            chain.append(s.id)
            if s.name in ROOTS:
                found = True
                break
            s = by_id.get(s.parent)
        for sid in chain:
            keep[sid] = found
        return found

    return [s for s in spans if under(s)]


def spans_in(rec, name=None) -> list:
    """The window's spans under a ``solve`` or ``serve.batch`` span (named
    ``name``, or all)."""
    trace = rec.get("trace")
    if trace is None:
        return []
    try:
        from repro_torch.obs import spans
    except ImportError:
        return []
    return [s for s in descends(spans.recorded())
            if (name is None or s.name == name) and trace.start <= s.start and s.end <= trace.end]


def _busy_s(ops, starts, a, b) -> float:
    """Seconds of the merged, sorted intervals ``ops`` inside ``[a, b]``."""
    busy = 0.0
    for k in range(max(bisect_right(starts, a) - 1, 0), len(ops)):
        lo, hi = ops[k]
        if lo >= b:
            break
        busy += max(0.0, min(b, hi) - max(a, lo))
    return busy


def on_device(spans) -> list:
    """The spans of ``spans`` whose work ran on a CUDA device (they carry
    CUDA events)."""
    return [s for s in spans if s.device_ms is not None]


def busy_ms(rec, spans) -> list[float]:
    """The device milliseconds of each of ``spans``, spans on a CUDA device
    in the window (see the module docstring)."""
    if not spans:
        return []
    ops = rec["trace"].intervals()
    starts = [a for a, _ in ops]
    return [_busy_s(ops, starts, s.start, max(s.end, s.start + s.device_ms / 1e3)) * 1e3 for s in spans]


def mean_busy_ms(rec, name):
    """The mean device milliseconds of the window's spans ``name`` that
    ran on a CUDA device."""
    times = busy_ms(rec, on_device(spans_in(rec, name)))
    return sum(times) / len(times) if times else None


def _union(intervals) -> list[list[float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    return merged


def idle_pct(rec, name):
    """The share of the host intervals of the window's spans ``name`` in
    which no device operation ran."""
    held = _union((s.start, s.end) for s in spans_in(rec, name))
    total = sum(b - a for a, b in held)
    if total <= 0:
        return None
    ops = rec["trace"].intervals()
    starts = [a for a, _ in ops]
    busy = sum(_busy_s(ops, starts, a, b) for a, b in held)
    return (1.0 - busy / total) * 100
