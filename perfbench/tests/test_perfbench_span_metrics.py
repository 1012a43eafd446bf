"""The readers of the span metrics (``perfbench/metrics/``) on synthetic
spans and device traces, with the cases where they find nothing; and on
the spans of real solves and a served batch on the CPU."""
import math
import random
import sys
import time

import pytest
import torch

torch.set_num_threads(1)

import repro_torch.obs  # noqa: E402
from perfbench.harness.manifest import load, reader  # noqa: E402
from perfbench.harness.trace import DeviceTrace  # noqa: E402
from perfbench.metrics._window import descends  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.obs.spans import Span  # noqa: E402

SPAN_METRICS = ["solve_sketch_ms", "api_host_ms", "loop_iter_ms.estimate", "loop_iter_ms.closed64",
                "loop_useful_pct.estimate", "loop_useful_pct.closed64", "loop_idle_pct.estimate",
                "loop_idle_pct.closed64", "sketch_idle_pct", "dispatch_sketch_ms.closed64"]


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _span(name, sid, parent, start, end, device_ms=None, **counts):
    events = None if device_ms is None else (_Event(0.0), _Event(device_ms))
    return Span(name, sid, parent, 1, start, end, counts, events)


def _estimates():
    """Two traced estimates in a window [0, 10], a loop after the window, a
    sketch of the public builder (no solve above it) inside. The first
    sketch's stream runs 0.2 s past its host end (600 ms of events from
    1.1 s), the second's ends inside it."""
    return [
        _span("solve.sketch", 2, 1, 1.1, 1.5, 600.0),
        _span("sinkhorn.setup", 12, 1, 1.5, 1.6, 50.0),
        _span("sinkhorn.loop", 3, 1, 1.6, 4.5, 2900.0, batch=1, launched=144, element_iters=130),
        _span("solve.value", 4, 1, 4.5, 4.8, 1.0),
        _span("solve", 1, None, 1.0, 5.0, 345.0),
        _span("solve.sketch", 6, 5, 6.0, 6.4, 42.0),
        _span("sinkhorn.loop", 7, 5, 6.5, 9.0, 280.0, batch=1, launched=128, element_iters=121),
        _span("solve.value", 8, 5, 9.0, 9.2, 1.0),
        _span("solve", 5, None, 5.9, 9.3, 330.0),
        _span("solve.sketch", 9, None, 9.4, 9.6, 500.0),
        _span("sinkhorn.loop", 11, 10, 11.0, 12.0, 999.0, batch=1, launched=16, element_iters=1),
        _span("solve", 10, None, 10.5, 12.5, 999.0),
    ]


def _served():
    """One served batch: two bucket dispatches, four and two real elements;
    the second sketch's stream runs 0.3 s past its host end."""
    return [
        _span("serve.queue", 21, 20, 0.2, 1.0),
        _span("executor.sketch", 23, 22, 1.0, 1.1, 12.0),
        _span("sinkhorn.loop", 24, 22, 1.1, 3.0, 150.0, batch=4, launched=64, element_iters=200),
        _span("executor.dispatch", 22, 20, 1.0, 3.1, 170.0),
        _span("executor.sketch", 26, 25, 3.2, 3.3, 400.0),
        _span("sinkhorn.loop", 27, 25, 3.3, 4.0, 50.0, batch=2, launched=48, element_iters=60),
        _span("executor.dispatch", 25, 20, 3.2, 4.1, 60.0),
        _span("serve.batch", 20, None, 1.0, 4.2, None, requests=[31, 32]),
    ]


def _trace(ops):
    return DeviceTrace(start=0.0, end=10.0, ops=[(a, b, "k") for a, b in ops])


#: device operations of the estimate window: the first loop 1.4 of its
#: 2.9 s busy, the second wholly; the sketches 0.3 of their 0.4 s on the
#: host (0.5 with the stream's tail) and 0.4 of 0.4 s busy
ESTIMATE_OPS = [(1.2, 2.0), (3.0, 4.0), (6.0, 9.0)]
SERVED_OPS = [(1.0, 2.0), (2.5, 3.5)]

EXPECTED = {
    "solve_sketch_ms": (_estimates, ESTIMATE_OPS, (0.5 + 0.4) / 2 * 1e3),
    "api_host_ms": (_estimates, ESTIMATE_OPS, ((4.0 - 3.7) + (3.4 - 3.1)) / 2 * 1e3),
    "loop_iter_ms.estimate": (_estimates, ESTIMATE_OPS, (1.4 + 2.5) * 1e3 / 272),
    "loop_useful_pct.estimate": (_estimates, ESTIMATE_OPS, 251 / 272 * 100),
    "loop_idle_pct.estimate": (_estimates, ESTIMATE_OPS, (1 - (1.4 + 2.5) / 5.4) * 100),
    "sketch_idle_pct": (_estimates, ESTIMATE_OPS, (1 - 0.7 / 0.8) * 100),
    "loop_iter_ms.closed64": (_served, SERVED_OPS, (1.4 + 0.2) * 1e3 / 112),
    "loop_useful_pct.closed64": (_served, SERVED_OPS, 260 / (4 * 64 + 2 * 48) * 100),
    "loop_idle_pct.closed64": (_served, SERVED_OPS, (1 - (0.9 + 0.5 + 0.2) / 2.6) * 100),
    "dispatch_sketch_ms.closed64": (_served, SERVED_OPS, (0.1 + 0.3) / 2 * 1e3),
}


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_reader_on_synthetic_spans(metric, monkeypatch):
    made, ops, expected = EXPECTED[metric]
    monkeypatch.setattr(spans, "recorded", made)
    assert reader(metric)({"trace": _trace(ops)}) == pytest.approx(expected)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_reader_finds_nothing(metric, monkeypatch):
    """No trace; a window with none of its spans; a program without spans."""
    made = _estimates if metric in ("solve_sketch_ms", "api_host_ms", "sketch_idle_pct") or "estimate" in metric \
        else _served
    monkeypatch.setattr(spans, "recorded", made)
    read = reader(metric)
    assert read({}) is None
    assert read({"trace": DeviceTrace(start=20.0, end=30.0)}) is None
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert read({"trace": _trace([])}) is None
    monkeypatch.setattr(spans, "recorded", made)
    monkeypatch.delattr(repro_torch.obs, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    assert read({"trace": _trace([])}) is None


@pytest.mark.parametrize("stats, expected", [
    ({"requests": 64, "batches": 4, "mean_queue_wait_s": 1.25}, 1250.0),
    ({"requests": 0, "batches": 0, "mean_queue_wait_s": 0.0}, None),
    ({"requests": 64, "batches": 4, "mean_batch": 16.0}, None),  # a server without the key
    (None, None),
])
def test_queue_wait_reader(stats, expected):
    got = reader("queue_wait_ms.closed64")({} if stats is None else {"server_stats": stats})
    assert got == (None if expected is None else pytest.approx(expected))


def test_shares_stay_in_range_on_random_spans(monkeypatch):
    rng = random.Random(7)
    for _ in range(50):
        made, ops = [], []
        t = 0.0
        for k in range(rng.randrange(1, 6)):
            start, end = t + rng.random(), t + 1 + 3 * rng.random()
            launched = 16 * rng.randrange(1, 9)
            batch = rng.choice([1, 2, 4, 16])
            made += [_span("solve", 100 + k, None, start, end),
                     _span("sinkhorn.loop", 200 + k, 100 + k, start + 0.1, end - 0.1, 1.0, batch=batch,
                           launched=launched, element_iters=sum(rng.randrange(0, launched + 1) for _ in range(batch)))]
            t = end
        for _ in range(rng.randrange(0, 12)):
            a = rng.uniform(-1.0, t + 1)
            ops.append((a, a + rng.random()))
        trace = DeviceTrace(start=0.0, end=t + 0.5, ops=sorted((a, b, "k") for a, b in ops))
        monkeypatch.setattr(spans, "recorded", lambda made=made: made)
        for metric in ("loop_useful_pct.estimate", "loop_idle_pct.estimate"):
            value = reader(metric)({"trace": trace})
            assert value is None or 0.0 <= value <= 100.0, (metric, value)


def test_readers_on_the_programs_own_spans():
    """A solve and a served batch recorded on the CPU: the host-side
    metrics read, the device times (no CUDA events here) do not."""
    import numpy as np

    from repro_torch import OTProblem, PointCloudGeometry, s0, solve
    from repro_torch.batch import BucketedExecutor
    from repro_torch.launch.serve_ot import OTServer
    from repro_torch.obs.metrics import MetricsRegistry

    rng = np.random.default_rng(3)

    def problem(n):
        return OTProblem(PointCloudGeometry(torch.tensor(rng.uniform(size=(n, 3))), device="cpu"),
                         torch.tensor(rng.dirichlet(np.ones(n))), torch.tensor(rng.dirichlet(np.ones(n))), 0.1)

    opts = dict(method="spar_sink_mf", s=8 * s0(64), tol=1e-6, max_iter=500)
    spans.clear()
    try:
        trace = DeviceTrace(start=time.perf_counter())
        with spans.recording():
            sol = solve(problem(64), seed=1, stabilize=True, **opts)
            with OTServer(BucketedExecutor(metrics=MetricsRegistry()), max_batch=3, deadline_s=0.05) as server:
                futures = [server.submit(problem(64), seed=k, **opts) for k in range(3)]
                [f.result(timeout=120) for f in futures]
        trace.end = time.perf_counter()
        rec = {"trace": trace}
        launched = -(-int(sol.n_iter) // 16) * 16
        by_id = {s.id: s for s in spans.recorded()}
        served = [s for s in by_id.values() if s.name == "sinkhorn.loop" and by_id[s.parent].name == "executor.dispatch"]
        assert served and sum(s.counts["batch"] for s in served) >= 3
        assert reader("loop_useful_pct.estimate")(rec) == pytest.approx(
            (int(sol.n_iter) + sum(s.counts["element_iters"] for s in served))
            / (launched + sum(s.counts["batch"] * s.counts["launched"] for s in served)) * 100)
        assert reader("loop_idle_pct.estimate")(rec) == 100.0  # no device operation in this trace
        assert 0.0 < reader("api_host_ms")(rec) < math.inf
        for metric in ("solve_sketch_ms", "loop_iter_ms.estimate", "dispatch_sketch_ms.closed64"):
            assert reader(metric)(rec) is None
    finally:
        spans.clear()


def test_descends_follows_parents_to_a_root():
    recorded = [Span("solve", 1, None, 1, 0, 9), Span("sinkhorn.loop", 2, 1, 1, 1, 2), Span("x", 3, 2, 1, 1, 2),
                Span("sinkhorn.loop", 4, None, 4, 3, 4), Span("serve.batch", 5, None, 5, 5, 6),
                Span("executor.sketch", 6, 7, 5, 5, 6), Span("executor.dispatch", 7, 5, 5, 5, 6),
                Span("orphan", 8, 99, 8, 0, 1)]
    assert [s.id for s in descends(recorded)] == [1, 2, 3, 5, 6, 7]


def test_every_span_metric_is_in_the_manifest():
    names = {m["name"]: m for m in load()["per_layer"]}
    for metric in SPAN_METRICS + ["queue_wait_ms.closed64"]:
        m = names[metric]
        assert m["source"] in ("program_span", "program_counter") and m["workloads"]


@pytest.mark.card
def test_spans_time_the_device_on_the_card(card, monkeypatch):
    """On the card: a profiled solve records its spans with CUDA events,
    the loop's counts resolve from the device, the estimate cell's readers
    read finite values from its trace, and with recording off a solve
    creates no event."""
    from repro_torch import OTProblem, PointCloudGeometry, s0, solve

    g = torch.Generator(device=card).manual_seed(5)
    n = 4096
    x = torch.rand(n, 3, device=card, dtype=torch.float64, generator=g)
    a = torch.rand(n, device=card, dtype=torch.float64, generator=g)
    b = torch.rand(n, device=card, dtype=torch.float64, generator=g)
    problem = OTProblem(PointCloudGeometry(x, device=card), a / a.sum(), b / b.sum(), 0.1)
    opts = dict(method="spar_sink_mf", s=4 * s0(n), tol=1e-6, max_iter=300, stabilize=True)
    solve(problem, seed=1, **opts)
    spans.clear()
    try:
        trace = DeviceTrace()
        trace.begin()
        sol = solve(problem, seed=2, **opts)
        trace.finish()
        got = spans.recorded()
        named = {s.name: s for s in got}
        assert [s.name for s in got if s.parent == named["solve"].id] == [
            "solve.sketch", "sinkhorn.setup", "sinkhorn.setup", "sinkhorn.loop", "solve.value"]
        assert all(s.device_ms >= 0 for s in got)
        assert all(named[k].device_ms > 0 for k in ("solve", "solve.sketch", "sinkhorn.loop", "solve.value"))
        assert named["sinkhorn.loop"].counts["element_iters"] == int(sol.n_iter)
        rec = {"trace": trace}
        for metric in ("solve_sketch_ms", "api_host_ms", "loop_iter_ms.estimate", "loop_useful_pct.estimate",
                       "loop_idle_pct.estimate", "sketch_idle_pct"):
            value = reader(metric)(rec)
            assert value is not None and math.isfinite(value) and value >= 0, (metric, value)
            assert "pct" not in metric or value <= 100, (metric, value)
        assert reader("solve_sketch_ms")(rec) > 0 and reader("loop_iter_ms.estimate")(rec) > 0
        spans.clear()

        def no_event(*args, **kwargs):
            raise AssertionError("a CUDA event was created with recording off")

        monkeypatch.setattr(torch.cuda, "Event", no_event)
        solve(problem, seed=3, **opts)
        assert spans.recorded() == []
    finally:
        spans.clear()
