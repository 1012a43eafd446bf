"""The OT server (`repro_torch.launch.serve_ot`), on the CPU.

Within the port: microbatching (served solutions bitwise the per-problem
``solve(seed=)``), solver-error propagation, a request without a random
source failing alone, the typed load-shed (`ServerOverloaded`,
`CircuitOpen`), degradation, dispatch-time expiry, retries, the breaker
over a `FlakyExecutor`, robust serving (`UnrecoverableSolve`), ``stats()``
and the ``serve.*``/``ot_*`` metric names, which are held against the
reference server's on the same traffic; and the CLI at a tiny size.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers
torch.set_num_threads(1)

import repro_torch.robust as rb
from repro.batch import BucketedExecutor as JBucketedExecutor
from repro.core import Geometry as JGeometry
from repro.core import OTProblem as JOTProblem
from repro.launch.serve_ot import OTServer as JOTServer
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro_torch import Geometry, OTProblem, UOTProblem, s0, solve
from repro_torch.batch import BucketedExecutor
from repro_torch.launch import serve_ot
from repro_torch.launch.serve_ot import (
    CircuitOpen,
    OTRequest,
    OTServer,
    RequestTimeout,
    ServerOverloaded,
    UnrecoverableSolve,
)
from repro_torch.obs.metrics import MetricsRegistry

EPS = 0.05


def _cost(n, m, seed):
    return np.random.default_rng(seed).random((n, m))


def _problem(n=32, m=32, seed=0):
    return OTProblem(Geometry(_cost(n, m, seed), device="cpu"), np.ones(n) / n, np.ones(m) / m, EPS)


def _request(problem, method="dense", generator=None, timeout_s=None, **opts):
    opts.setdefault("tol", 1e-7)
    opts.setdefault("max_iter", 2000)
    return OTRequest(problem, method, generator, opts, timeout_s=timeout_s)


def _server(**kw):
    kw.setdefault("executor", BucketedExecutor(metrics=MetricsRegistry()))
    return OTServer(**kw)


def _mixed(count=8, sizes=(40, 64, 100, 128), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = sizes[i % len(sizes)]
        x, a, b = rng.uniform(size=(n, 3)), rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))
        g = Geometry.from_points(x, normalize=True, device="cpu")
        out.append(UOTProblem(g, a * 5.0, b * 3.0, 0.1, lam=0.5) if i % 2 else OTProblem(g, a, b, 0.1))
    return out


def test_serve_ot_exports():
    assert sorted(serve_ot.__all__) == [
        "CircuitOpen", "OTRequest", "OTServer", "RequestTimeout", "ServerOverloaded", "UnrecoverableSolve"]


def test_microbatching_bitwise_per_problem():
    problems = _mixed()
    s = 8 * s0(128)
    with _server(max_batch=8, deadline_s=0.05) as server:
        futures = [server.submit(p, method="spar_sink_coo", seed=100 + i, s=s, max_iter=2000)
                   for i, p in enumerate(problems)]
        sols = [f.result(timeout=300) for f in futures]
    st = server.stats()
    assert st["requests"] == 8 and 1 <= st["batches"] <= 8 and st["compiles"] >= 1
    assert set(st) == {"requests", "batches", "mean_batch", "p50_latency_s", "p95_latency_s", "p99_latency_s",
                       "mean_queue_wait_s", "compiles"}
    for i, (p, sol) in enumerate(zip(problems, sols)):
        ref = solve(p, method="spar_sink_coo", seed=100 + i, s=s, max_iter=2000)
        assert torch.equal(sol.result.u, ref.result.u) and torch.equal(sol.value, ref.value), p.shape
    gen = torch.Generator().manual_seed(5)
    with _server(max_batch=2, deadline_s=0.01) as server:
        sol = server.submit(problems[0], method="spar_sink_coo", generator=gen, s=s).result(timeout=300)
    ref = solve(problems[0], method="spar_sink_coo", seed=5, s=s)
    assert torch.equal(sol.result.u, ref.result.u)


def test_propagates_solver_errors():
    with _server(max_batch=4, deadline_s=0.01) as server:
        fut = server.submit(_problem(), method="no_such_method")
        with pytest.raises(KeyError):
            fut.result(timeout=60)


def test_request_without_random_source_fails_alone():
    small = [p for p in _mixed() if p.shape[0] <= 64]
    s = 8 * s0(64)
    with _server(max_batch=4, deadline_s=0.2) as server:
        good = server.submit(small[0], method="spar_sink_coo", seed=0, s=s, max_iter=500)
        bad = server.submit(small[1], method="spar_sink_coo", s=s, max_iter=500)
        sol = good.result(timeout=120)
        with pytest.raises(TypeError, match="generators"):
            bad.result(timeout=120)
    assert np.isfinite(float(sol.value))


def test_bounded_queue_sheds_typed():
    srv = _server(max_queue=2)  # not started: the queue only fills
    srv.submit(_problem(), method="dense")
    srv.submit(_problem(), method="dense")
    with pytest.raises(ServerOverloaded):
        srv.submit(_problem(), method="dense")
    assert srv.metrics.get_counter("ot_shed_total") == 1.0


def test_degrade_watermark_applies_overrides():
    srv = _server(degrade_watermark=1, degrade={"max_iter": 7, "certify": False})
    srv.submit(_problem(), method="dense", max_iter=2000)
    srv.submit(_problem(), method="dense", max_iter=2000)
    r1, r2 = srv._queue.get(), srv._queue.get()
    assert not r1.degraded and r1.opts["max_iter"] == 2000
    assert r2.degraded and r2.opts["max_iter"] == 7 and r2.opts["certify"] is False
    assert srv.metrics.get_counter("ot_degraded_total") == 1.0


def test_dispatch_time_expiry_under_skewed_clock():
    clock = rb.SkewedClock()
    srv = _server(clock=clock)
    fut = srv.submit(_problem(), method="dense", timeout_s=0.05, tol=1e-7)
    req = srv._queue.get()
    assert srv._expire([req]) == [req]
    clock.advance(0.2)
    srv._dispatch("dense", [req])
    with pytest.raises(RequestTimeout):
        fut.result(timeout=1)
    assert srv.metrics.get_counter("ot_server_timeouts_total") == 1.0 and srv.batches_dispatched == 0


def test_dispatch_retries_then_succeeds_or_fails_typed():
    sleeps = []
    flaky = rb.FlakyExecutor(BucketedExecutor(metrics=MetricsRegistry()), fail_calls={0, 1})
    srv = _server(executor=flaky, max_retries=2, backoff_s=0.01, sleep=sleeps.append)
    req = _request(_problem())
    assert srv._dispatch_group("dense", [req])
    assert req.future.result(timeout=1).status_label == "converged"
    assert flaky.calls == 3 and flaky.faults == 2 and sleeps == [0.01, 0.02]
    assert srv.metrics.get_counter("ot_retries_total") == 2.0
    flaky = rb.FlakyExecutor(BucketedExecutor(metrics=MetricsRegistry()), fail_calls={0, 1})
    srv = _server(executor=flaky, max_retries=1, sleep=lambda s: None)
    req = _request(_problem())
    assert not srv._dispatch_group("dense", [req])
    with pytest.raises(rb.InjectedFault):
        req.future.result(timeout=1)


def test_breaker_sheds_then_recovers():
    clock = rb.SkewedClock()
    flaky = rb.FlakyExecutor(BucketedExecutor(metrics=MetricsRegistry()), fail_calls={0, 1})
    srv = _server(executor=flaky, clock=clock, breaker=rb.BreakerPolicy(failure_threshold=2, reset_timeout_s=5.0))
    for _ in range(2):
        r = _request(_problem())
        srv._dispatch("dense", [r])
        with pytest.raises(rb.InjectedFault):
            r.future.result(timeout=1)
    assert flaky.calls == 2 and srv.metrics.get_gauge("ot_breaker_open") == 1.0
    assert srv.metrics.get_gauge("ot_breaker_state:dense:64x64") == 1.0
    shed = _request(_problem())
    srv._dispatch("dense", [shed])
    with pytest.raises(CircuitOpen):
        shed.future.result(timeout=1)
    assert flaky.calls == 2 and srv.metrics.get_counter("ot_shed_total") == 1.0
    clock.advance(5.1)
    probe = _request(_problem())
    srv._dispatch("dense", [probe])
    assert probe.future.result(timeout=1).status_label == "converged" and flaky.calls == 3
    assert srv.metrics.get_gauge("ot_breaker_open") == 0.0
    (brk,) = srv._breakers.values()
    assert brk.state_label == "closed"
    # a poisoned (bucket, method) family sheds alone
    flaky = rb.FlakyExecutor(BucketedExecutor(metrics=MetricsRegistry()), fail_calls={0})
    srv = _server(executor=flaky, breaker=rb.BreakerPolicy(failure_threshold=1, reset_timeout_s=60.0))
    srv._dispatch("dense", [_request(_problem())])
    big = _request(_problem(100, 100, seed=3))
    srv._dispatch("dense", [big])
    assert big.future.result(timeout=5).status_label == "converged"
    small = _request(_problem())
    srv._dispatch("dense", [small])
    with pytest.raises(CircuitOpen):
        small.future.result(timeout=1)


def test_robust_serving_recovers_or_fails_typed():
    """The NaN-kernel request (a UOT ``spar_sink_coo`` solve, whose sketch
    reads the poisoned kernel: its status says converged on a NaN value)
    recovers by the log-domain sibling; the undersized one, given two
    attempts, fails with `UnrecoverableSolve`."""
    s = 400.0
    poisoned = rb.corrupt_scaling_kernel(_mixed()[1], 3, mode="nan")
    policy = rb.EscalationPolicy(max_attempts=2)
    with _server(robust=True, policy=policy, max_batch=4, deadline_s=0.02) as server:
        # s = 1600 on 64 x 64 keeps about 25 entries a row: the NaN row is sampled
        saved = server.submit(poisoned, method="spar_sink_coo", seed=1, s=1600.0, tol=1e-7)
        lost = server.submit(_problem(48, 48), method="spar_sink_log", seed=0, s=s, cap=rb.undersized_cap(s))
        sol = saved.result(timeout=120)
        with pytest.raises(UnrecoverableSolve) as err:
            lost.result(timeout=120)
    assert isinstance(sol, rb.RobustSolution) and sol.recovered
    assert [(a.action, a.method) for a in sol.attempts] == [("initial", "spar_sink_coo"), ("log_domain", "spar_sink_log")]
    assert np.isfinite(float(sol.value)) and sol.status_label == "converged"
    assert not err.value.solution.recovered and len(err.value.solution.attempts) == 2
    assert server.metrics.get_counter("ot_escalations_total") == 2.0


def test_metric_names_match_reference():
    """The same dense traffic (one request a dispatch) through both servers
    records the same counters, gauges and histograms by name."""
    names = []
    for jax_side in (False, True):
        if jax_side:
            reg = JMetricsRegistry()
            srv = JOTServer(JBucketedExecutor(metrics=reg), max_batch=2)
            probs = [JOTProblem(JGeometry(jnp.asarray(_cost(32, 32, i))), jnp.ones(32) / 32, jnp.ones(32) / 32, EPS)
                     for i in range(3)]
        else:
            reg = MetricsRegistry()
            srv = OTServer(BucketedExecutor(metrics=reg), max_batch=2)
            probs = [_problem(seed=i) for i in range(3)]
        for p in probs:
            srv.submit(p, method="dense", tol=1e-7, certify=True)
        while not srv._queue.empty():
            r = srv._queue.get()
            srv._dispatch("dense", [r])
            r.future.result(timeout=60)
        snap = reg.snapshot()
        if jax_side:  # the port's deliberate differences: no executor.retrace, a queue-wait histogram
            snap["counters"].pop("executor.retrace")
            snap["histograms"]["serve.queue_wait_seconds"] = None
        names.append({kind: sorted(snap[kind]) for kind in ("counters", "gauges", "histograms")})
        srv.reset_stats()
        assert srv.stats()["requests"] == 0 and reg.get_histogram("serve.latency_seconds")["count"] == 0
    assert names[0] == names[1]
    assert "serve.latency_seconds" in names[0]["histograms"] and "ot_cert_gap_p95" in names[0]["gauges"]


def test_cli_smoke(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve_ot", "--device", "cpu", "--sizes", "96,128", "--requests", "8",
                                      "--method", "spar_sink_mf", "--serial"])
    serve_ot.main()
    out = capsys.readouterr().out
    assert "served 8 requests" in out and "on cpu" in out and "batched speedup" in out
    problems = serve_ot._make_request_problems(4, [96], 0, point_cloud=True, device="cpu")
    assert [type(p).__name__ for p in problems] == ["OTProblem", "UOTProblem"] * 2
    assert float(problems[1].lam) == 0.5 and float(problems[1].eps) == 0.1
