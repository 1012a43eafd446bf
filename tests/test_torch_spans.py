"""The spans of the port's layers (`repro_torch.obs.spans`), on the CPU.

* Off by default: a ``spar_sink_mf`` solve (both domains) and a
  ``solve_batch`` record no span, create no CUDA event, and dispatch the
  same aten ops as the code without spans: frozen copies of the two loop
  drivers as they were before spans, with every other span site stubbed
  out (change the copies only with a deliberate loop change).
* Under `recording()`: parent and trace ids nest from ``solve`` and
  ``executor.dispatch`` down, the loop's set-up is a span of its own
  before the loop, the ring stays bounded, the server's and a caller's
  threads keep their own parents; a `torch.profiler` session alone turns
  recording on, and its end turns it off.
* ``sinkhorn.loop``'s ``launched`` and ``element_iters`` against hand
  counts, per problem and batched (a frozen element and a padding
  duplicate).
* ``OTServer.stats()["mean_queue_wait_s"]`` and the ``serve.queue`` spans
  under the server's injectable clock.
"""
import importlib
import threading

import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers
torch.set_num_threads(1)
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro_torch.robust as rb  # noqa: E402
from repro_torch import OTProblem, PointCloudGeometry, UOTProblem, s0, solve  # noqa: E402
from repro_torch.batch import BucketedExecutor  # noqa: E402
from repro_torch.core.sinkhorn import CHECK_EVERY  # noqa: E402
from repro_torch.launch.serve_ot import OTServer  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402

TOL = 1e-6
# the modules (repro_torch.core re-exports a function named sinkhorn)
csinkhorn = importlib.import_module("repro_torch.core.sinkhorn")
bsolvers = importlib.import_module("repro_torch.batch.solvers")


@pytest.fixture(autouse=True)
def empty_ring():
    spans.clear()
    yield
    spans.clear()


def _problem(n, seed, uot=False):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(size=(n, 3)))
    a = torch.tensor(rng.dirichlet(np.ones(n)))
    b = torch.tensor(rng.dirichlet(np.ones(n)))
    geom = PointCloudGeometry(x, device="cpu")
    if uot:
        return UOTProblem(geom, a * 5.0, b * 3.0, 0.1, lam=0.5)
    return OTProblem(geom, a, b, 0.1)


def _opts(stabilize=False, **kw):
    return dict(method="spar_sink_mf", s=8 * s0(64), tol=TOL, max_iter=500, stabilize=stabilize) | kw


# --------------------------------------------------------------------------
# Off: nothing recorded, no CUDA event, the ops of the code before spans
# --------------------------------------------------------------------------


def _frozen_run(state, active, step, max_iter):
    """`repro_torch.core.sinkhorn._run` before spans."""
    for it in range(max_iter):
        if it % CHECK_EVERY == 0 and not bool(active):
            break
        new, cond = step(state)
        state = {k: torch.where(active, new[k], state[k]) for k in state}
        active = active & cond
    return state, active


def _frozen_batched_run(state, step, max_iter, batch, device):
    """`repro_torch.batch.solvers._run` before spans."""
    active = torch.ones(batch, dtype=torch.bool, device=device)
    for it in range(max_iter):
        if it % CHECK_EVERY == 0 and not bool(active.any()):
            break
        new, cond = step(state, active)
        state = {
            k: torch.where(active.reshape((batch,) + (1,) * (old.ndim - 1)), new[k], old)
            for k, old in state.items()
        }
        active = active & cond
    return state


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def _without_spans(monkeypatch):
    """The program as it was before spans: the frozen drivers, every other
    span site a bare context."""
    monkeypatch.setattr(csinkhorn, "_run", _frozen_run)
    monkeypatch.setattr(bsolvers, "_run", _frozen_batched_run)
    monkeypatch.setattr(spans, "span", lambda name, **kw: _Nothing())
    monkeypatch.setattr(spans, "annotate", lambda **counts: None)
    monkeypatch.setattr(spans, "record", lambda *a, **kw: None)


class _AtenOps(TorchDispatchMode):
    """Records the name of every aten op dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _no_event(*args, **kwargs):
    raise AssertionError("a CUDA event was created with recording off")


def _solve_once(which):
    if which == "batch":
        problems = [_problem(48, 1), _problem(64, 2, uot=True), _problem(64, 3)]
        sols = BucketedExecutor(metrics=MetricsRegistry()).solve_batch(problems, seeds=[5, 6, 7], **_opts())
        return [(s.result.u, s.result.v, s.value) for s in sols]
    sol = solve(_problem(64, 4, uot=True), seed=9, **_opts(stabilize=which == "log"))
    return [(sol.result.u, sol.result.v, sol.value)]


@pytest.mark.parametrize("which", ["scaling", "log", "batch"])
def test_off_records_nothing_and_dispatches_the_ops_before_spans(which, monkeypatch):
    assert not spans.enabled()
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "Event", _no_event)
        with _AtenOps() as now:
            got = _solve_once(which)
    assert spans.recorded() == []
    _without_spans(monkeypatch)
    with _AtenOps() as before:
        old = _solve_once(which)
    assert len(before.ops) > 100 and now.ops == before.ops
    for new_parts, old_parts in zip(got, old):
        assert all(torch.equal(x, y) for x, y in zip(new_parts, old_parts))


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1
        self.at = None

    def record(self, stream=None):
        self.at = len(spans.recorded())

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 2.5


@pytest.mark.parametrize("on", [False, True])
def test_cuda_events_only_while_recording(on, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    _FakeEvent.made = 0
    cuda = torch.device("cuda", 0)
    if on:
        with spans.recording(), spans.span("outer", device=cuda), spans.span("host"):
            pass
    else:
        with spans.span("outer", device=cuda):
            spans.annotate(n=1)
    got = spans.recorded()
    if not on:
        assert got == [] and _FakeEvent.made == 0
        return
    assert [s.name for s in got] == ["host", "outer"] and _FakeEvent.made == 2
    assert got[0].device_ms is None and got[1].device_ms == 2.5


# --------------------------------------------------------------------------
# On: ids, the ring, threads, the profiler
# --------------------------------------------------------------------------


def _by_name(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.mark.parametrize("stabilize", [False, True])
def test_ids_nest_under_solve_and_dispatch(stabilize):
    with spans.recording():
        solve(_problem(64, 4), seed=9, **_opts(stabilize=stabilize))
        problems = [_problem(48, 1), _problem(64, 2)]
        BucketedExecutor(metrics=MetricsRegistry()).solve_batch(problems, seeds=[5, 6], **_opts())
    named = _by_name(spans.recorded())
    (root,) = named["solve"]
    assert root.parent is None and root.trace == root.id and root.counts == {}
    children = [s for s in spans.recorded() if s.parent == root.id]
    # the log domain's set-up in two parts: its inputs, then the layouts
    setup = ["sinkhorn.setup"] * (2 if stabilize else 1)
    assert [s.name for s in children] == ["solve.sketch"] + setup + ["sinkhorn.loop", "solve.value"]
    for earlier, later in zip(children, children[1:]):
        assert earlier.end <= later.start
    for child in children:
        assert child.trace == root.id and root.start <= child.start <= child.end <= root.end
    # 48 and 64 points share one bucket: one dispatch
    (dispatch,) = named["executor.dispatch"]
    assert dispatch.parent is None and dispatch.counts == {}
    (sketch,) = named["executor.sketch"]
    served_loop = named["sinkhorn.loop"][1]
    for child in (sketch, served_loop):
        assert child.parent == dispatch.id and child.trace == dispatch.id
    ids = [s.id for s in spans.recorded()]
    assert len(set(ids)) == len(ids) and all(s.device_ms is None for s in spans.recorded())


def test_ring_is_bounded_and_cleared():
    with spans.recording():
        for k in range(spans.RING_LEN + 10):
            spans.record("tick", float(k), float(k) + 0.5, n=k)
    got = spans.recorded()
    assert len(got) == spans.RING_LEN and got[0].counts == {"n": 10} and got[-1].counts["n"] == spans.RING_LEN + 9
    spans.clear()
    assert spans.recorded() == []
    spans.record("tick", 0.0, 1.0)  # recording off
    assert spans.recorded() == []


def test_annotate_reaches_the_innermost_open_span_and_sums_tensors():
    with spans.recording():
        with spans.span("outer", a=1):
            with spans.span("inner"):
                spans.annotate(t=torch.tensor([3, 4], dtype=torch.int32))
            spans.annotate(b=2)
    inner, outer = spans.recorded()
    assert inner.counts == {"t": 7} and outer.counts == {"a": 1, "b": 2} and inner.parent == outer.id
    spans.annotate(c=3)  # nothing open: no effect
    assert spans.recorded()[1].counts == {"a": 1, "b": 2}


def test_server_and_caller_threads_keep_their_own_parents():
    problems = [_problem(64, k, uot=k % 2 == 1) for k in range(6)]
    with spans.recording(), OTServer(BucketedExecutor(metrics=MetricsRegistry()), max_batch=3,
                                     deadline_s=0.05) as server:
        futures = [server.submit(p, seed=20 + k, **_opts()) for k, p in enumerate(problems)]
        for k in range(3):
            solve(problems[k], seed=40 + k, **_opts())
        for f in futures:
            f.result(timeout=120)
        # the last batch's span closes after its futures are set
        server.stop()
    got = spans.recorded()
    by_id = {s.id: s for s in got}

    def root(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s

    served = {"serve.queue", "executor.dispatch", "executor.sketch", "sinkhorn.loop"}
    called = {"solve.sketch", "sinkhorn.setup", "sinkhorn.loop", "solve.value"}
    for s in got:
        top = root(s)
        assert top.name in ("serve.batch", "solve"), s
        assert s is top or s.name in (served if top.name == "serve.batch" else called), s
    named = _by_name(got)
    assert len(named["solve"]) == 3 and len(named["serve.queue"]) == 6
    assert sorted(sum((b.counts["requests"] for b in named["serve.batch"]), [])) == sorted(
        q.trace for q in named["serve.queue"])


def test_profiler_session_alone_turns_recording_on():
    problem = _problem(64, 4)
    assert not spans.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert spans.enabled()
        solve(problem, seed=9, **_opts())
    assert not spans.enabled()
    inside = len(spans.recorded())
    assert inside == 5  # solve, solve.sketch, sinkhorn.setup, sinkhorn.loop, solve.value
    solve(problem, seed=9, **_opts())
    assert len(spans.recorded()) == inside


# --------------------------------------------------------------------------
# The loop's counts
# --------------------------------------------------------------------------


def _hand_launched(n_iters, max_iter):
    """The drivers' rule: a host read of ``active`` every CHECK_EVERY
    iterations, the loop ending at the first read after every element
    stopped, or at ``max_iter``."""
    return min(-(-max(n_iters) // CHECK_EVERY) * CHECK_EVERY, max_iter)


@pytest.mark.parametrize("max_iter", [500, 20])
@pytest.mark.parametrize("stabilize", [False, True])
def test_loop_counts_per_problem(stabilize, max_iter):
    with spans.recording():
        sol = solve(_problem(64, 4, uot=True), seed=9, **_opts(stabilize=stabilize, max_iter=max_iter))
    n_iter = int(sol.n_iter)
    if max_iter == 500:
        assert n_iter % CHECK_EVERY and n_iter < max_iter
    (loop,) = _by_name(spans.recorded())["sinkhorn.loop"]
    assert loop.counts == {"batch": 1, "launched": _hand_launched([n_iter], max_iter), "element_iters": n_iter}


def test_loop_counts_batched_with_a_frozen_element_and_padding():
    problems = [_problem(64, 11), _problem(64, 12, uot=True), _problem(48, 13)]
    with spans.recording():
        sols = BucketedExecutor(metrics=MetricsRegistry()).solve_batch(problems, seeds=[1, 2, 3], **_opts())
    n_iters = [int(s.n_iter) for s in sols]
    assert len(set(n_iters)) == 3 and max(n_iters) % CHECK_EVERY
    (loop,) = _by_name(spans.recorded())["sinkhorn.loop"]
    # B = 4: the third problem again as the padding duplicate
    assert loop.counts == {"batch": 4, "launched": _hand_launched(n_iters, 500),
                           "element_iters": sum(n_iters) + n_iters[-1]}


# --------------------------------------------------------------------------
# The server's queue wait
# --------------------------------------------------------------------------


def test_mean_queue_wait_under_the_servers_clock():
    clock = rb.SkewedClock(base=lambda: 0.0)
    server = OTServer(BucketedExecutor(metrics=MetricsRegistry()), clock=clock)  # not started
    problems = [_problem(48, 1), _problem(48, 2), _problem(64, 3)]
    with spans.recording():
        futures = []
        for k, p in enumerate(problems):
            futures.append(server.submit(p, seed=k, **_opts()))
            clock.advance(1.0)
        clock.advance(2.0)  # dispatched at 5.0, submitted at 0, 1 and 2
        reqs = [server._queue.get() for _ in problems]
        server._dispatch("spar_sink_mf", reqs)
    assert all(f.done() for f in futures)
    stats = server.stats()
    assert stats["mean_queue_wait_s"] == pytest.approx(4.0) and stats["requests"] == 3
    queued = _by_name(spans.recorded())["serve.queue"]
    assert [(q.start, q.end, q.trace) for q in queued] == [(float(k), 5.0, r.id) for k, r in enumerate(reqs)]
    assert len({r.id for r in reqs}) == 3
    server.reset_stats()
    assert server.stats()["mean_queue_wait_s"] == 0.0


def test_threads_record_under_one_switch():
    seen = []

    def worker():
        with spans.span("worker"):
            pass
        seen.append(spans.enabled())

    with spans.recording():
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [True]
    (w,) = spans.recorded()
    assert w.name == "worker" and w.parent is None
