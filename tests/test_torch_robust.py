"""The escalation ladder, breaker and chaos harness (`repro_torch.robust`).

* Against ``repro.robust`` (the same numpy inputs through both packages):
  the exported names, the policy's defaults, and the ladder's attempt
  sequence (actions, methods, statuses, overflow flags, caps, final
  status) on the reference's NaN-kernel, zero-kernel and ``undersized_cap``
  cases. The two packages draw different sketches from their seeds, so the
  overflow case uses ``undersized_cap(s, factor=6)``: every rung's
  capacity then lies at least 7 standard deviations from the draw's size,
  and both take the same steps whatever they draw.
* Within the port: the ladder's rungs on stubbed solves (as the
  reference's own unit tests), a fresh seed for each re-sketch, a NaN
  value read as ``non_finite``, ``solve(robust=True)`` bitwise
  ``robust=False`` on a converged first attempt, the batched executor's
  ladder on the failed elements only, the breaker's state machine under
  `SkewedClock`, and the injectors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers
torch.set_num_threads(1)

import repro.robust as jrb
import repro_torch.robust as rb
from repro.core import Geometry as JGeometry
from repro.core import OTProblem as JOTProblem
from repro_torch import Geometry, OTProblem, PointCloudGeometry, UOTProblem, s0, solve
from repro_torch.batch import BucketedExecutor
from repro_torch.core.api.solution import Solution
from repro_torch.core.sinkhorn import STATUS_LABELS, SinkhornResult
from repro_torch.obs.metrics import MetricsRegistry

EPS = 0.05


def _cost(n, m, seed):
    return np.random.default_rng(seed).random((n, m))


def _problem(n=32, m=32, eps=EPS, seed=0):
    return OTProblem(Geometry(_cost(n, m, seed), device="cpu"), np.ones(n) / n, np.ones(m) / m, eps)


def _jproblem(n=32, m=32, eps=EPS, seed=0):
    return JOTProblem(JGeometry(jnp.asarray(_cost(n, m, seed))), jnp.ones(n) / n, jnp.ones(m) / m, eps)


def _history(rs):
    return [(a.action, a.method, a.status, a.overflowed, a.cap, a.eps) for a in rs.attempts]


def test_robust_exports_the_reference_names():
    assert sorted(rb.__all__) == sorted(jrb.__all__)
    assert rb.BREAKER_STATES == jrb.BREAKER_STATES
    assert dataclasses.asdict(rb.EscalationPolicy()) == dataclasses.asdict(jrb.EscalationPolicy())
    assert rb.BreakerPolicy() == tuple(jrb.BreakerPolicy())
    assert [f.name for f in dataclasses.fields(rb.Attempt)] == [f.name for f in dataclasses.fields(jrb.Attempt)]
    assert rb.undersized_cap(400.0) == jrb.undersized_cap(400.0) == 50


# --------------------------------------------------------------------------
# The ladder against the reference, end to end
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["nan", "zero"])
def test_kernel_chaos_ladder_matches_reference(mode):
    """A corrupted scaling kernel: the dense solve fails, the log-domain
    sibling recovers, in both packages, to the clean value."""
    rs = rb.solve_robust(rb.corrupt_scaling_kernel(_problem(), 1, mode=mode), method="dense", tol=1e-7)
    jrs = jrb.solve_robust(jrb.corrupt_scaling_kernel(_jproblem(), jax.random.PRNGKey(1), mode=mode),
                           method="dense", tol=1e-7)
    assert _history(rs) == _history(jrs)
    assert [a.action for a in rs.attempts] == ["initial", "log_domain"]
    assert rs.recovered and jrs.recovered and rs.status_label == jrs.status_label == "converged"
    np.testing.assert_allclose(float(rs.value), float(jrs.value), rtol=1e-10)
    clean = solve(_problem(), method="dense", tol=1e-7)
    assert float(rs.value) == pytest.approx(float(clean.value), rel=1e-5)


def test_overflow_ladder_matches_reference():
    s = 400.0
    cap = rb.undersized_cap(s, factor=6)
    opts = dict(s=s, cap=cap, tol=1e-7)
    rs = rb.solve_robust(_problem(48, 48), method="spar_sink_log", seed=2, **opts)
    jrs = jrb.solve_robust(_jproblem(48, 48), method="spar_sink_log", key=jax.random.PRNGKey(2), **opts)
    assert _history(rs) == _history(jrs)
    assert [a.action for a in rs.attempts] == ["initial", "resketch", "resketch", "resketch"]
    assert [a.cap for a in rs.attempts] == [66, 132, 264, 528]
    assert [a.overflowed for a in rs.attempts] == [True, True, True, False]
    assert rs.recovered and jrs.recovered and rs.status_label == "converged"


def test_robust_happy_path_bitwise():
    p = _problem()
    plain = solve(p, method="dense", tol=1e-9)
    rs = solve(p, method="dense", robust=True, tol=1e-9)
    assert isinstance(rs, rb.RobustSolution) and rs.recovered and len(rs.attempts) == 1
    for x, y in zip(rs.potentials, plain.potentials):
        assert torch.equal(x, y)
    assert torch.equal(rs.value, plain.value) and rs.status_label == "converged"
    assert rs.solution.method == "dense" and not rs.escalated
    sk = solve(p, method="spar_sink_log", seed=3, s=400.0, robust=True)
    sk0 = solve(p, method="spar_sink_log", seed=3, s=400.0)
    assert torch.equal(sk.result.u, sk0.result.u) and torch.equal(sk.value, sk0.value)
    assert isinstance(solve(p, method="dense", policy=rb.EscalationPolicy(max_attempts=2), tol=1e-9),
                      rb.RobustSolution)


# --------------------------------------------------------------------------
# The ladder's rungs on stubbed solves
# --------------------------------------------------------------------------


def _fake(problem, method="dense", status="stall", domain="scaling", overflowed=None, n_iter=5, value=1.0):
    n, m = problem.shape
    idx = None if status is None else STATUS_LABELS.index(status)
    res = SinkhornResult(torch.zeros(n), torch.zeros(m), torch.tensor(n_iter), torch.tensor(1e-3),
                         None if idx is None else torch.tensor(idx), None)
    return Solution(method=method, problem=problem, value=torch.tensor(value), result=res, domain=domain,
                    overflowed=None if overflowed is None else torch.tensor(overflowed))


@pytest.mark.parametrize("method,opts,status,domain,overflowed", [
    ("dense", {}, "stall", "scaling", None),
    ("log", {"max_iter": 100}, "max_iter", "log", None),
    ("dense", {}, "degenerate", "scaling", None),
    ("log", {}, "non_finite", "log", None),
    ("spar_sink_log", {"seed": 0, "s": 64.0, "cap": 32}, "converged", "log", True),
], ids=["stall", "max_iter", "degenerate", "non_finite", "overflow"])
def test_ladder_terminates(monkeypatch, method, opts, status, domain, overflowed):
    monkeypatch.setattr("repro_torch.robust.ladder.solve",
                        lambda problem, method="dense", **kw: _fake(problem, method, status, domain, overflowed))
    policy = rb.EscalationPolicy(max_attempts=4)
    rs = rb.solve_robust(_problem(), method, policy=policy, **opts)
    assert not rs.recovered and 1 <= len(rs.attempts) <= policy.max_attempts
    assert rs.attempts[0].action == "initial"
    assert rs.total_matvecs == sum(2 * t.n_iter for t in rs.attempts)


def test_ladder_resketch_grows_cap_with_fresh_seeds(monkeypatch):
    seen = []

    def stub(problem, method="dense", **kw):
        seen.append((kw.get("seed"), kw.get("generator")))
        return _fake(problem, method, "converged", "log", overflowed=True)

    monkeypatch.setattr("repro_torch.robust.ladder.solve", stub)
    policy = rb.EscalationPolicy(max_attempts=4, cap_growth=2.0)
    rs = rb.solve_robust(_problem(), "spar_sink_log", policy=policy, seed=0, s=64.0, cap=32)
    assert [t.cap for t in rs.attempts] == [32, 64, 128, 256]
    assert all(t.action == "resketch" for t in rs.attempts[1:])
    seeds = [sd for sd, _ in seen]
    assert seeds[0] == 0 and len(set(seeds)) == 4 and all(g is None for _, g in seen)
    # a generator's re-sketch seeds come from its initial seed, not its state
    gen = torch.Generator().manual_seed(0)
    torch.rand(5, generator=gen)
    seen.clear()
    rb.solve_robust(_problem(), "spar_sink_log", policy=policy, generator=gen, s=64.0, cap=32)
    assert seen[0] == (None, gen) and [sd for sd, _ in seen[1:]] == seeds[1:]


def test_ladder_stall_bumps_then_retightens(monkeypatch):
    p = _problem()
    calls = []

    def stub(problem, method="dense", **kw):
        calls.append((float(problem.eps), method, dict(kw)))
        return _fake(problem, method, "converged", "log")

    monkeypatch.setattr("repro_torch.robust.ladder.solve", stub)
    rs = rb.escalate_from(p, "dense", _fake(p, "dense", "stall"), metrics=MetricsRegistry())
    assert [t.action for t in rs.attempts] == ["initial", "eps_bump", "retighten"] and rs.recovered
    assert rs.attempts[1].eps == pytest.approx(EPS * 10.0) and rs.attempts[2].eps == pytest.approx(EPS)
    assert "init" in calls[-1][2] and calls[0][1] == "log" == calls[-1][1]


def test_ladder_never_downgrades_best(monkeypatch):
    p = _problem()
    first = _fake(p, "spar_sink_log", "converged", "log", overflowed=True, value=7.0)
    monkeypatch.setattr("repro_torch.robust.ladder.solve",
                        lambda problem, method="dense", **kw: _fake(problem, method, "stall", "log", value=-3.0))
    rs = rb.escalate_from(p, "spar_sink_log", first, policy=rb.EscalationPolicy(max_attempts=3),
                          metrics=MetricsRegistry(), seed=0, s=64.0, cap=32)
    assert not rs.recovered and rs.solution is first and float(rs.value) == 7.0


def test_ladder_converged_first_returns_immediately(monkeypatch):
    def boom(problem, **kw):
        raise AssertionError("the ladder escalated a converged solve")

    monkeypatch.setattr("repro_torch.robust.ladder.solve", boom)
    p = _problem()
    first = _fake(p, "log", "converged", "log")
    rs = rb.escalate_from(p, "log", first, metrics=MetricsRegistry())
    assert rs.recovered and not rs.escalated and rs.solution is first


def test_ladder_counts_escalations(monkeypatch):
    reg = MetricsRegistry()
    monkeypatch.setattr("repro_torch.robust.ladder.solve",
                        lambda problem, method="dense", **kw: _fake(problem, method, "stall", "log"))
    p = _problem()
    rs = rb.escalate_from(p, "log", _fake(p, "log", "stall", "log"), policy=rb.EscalationPolicy(max_attempts=3),
                          metrics=reg)
    assert reg.get_counter("ot_escalations_total") == len(rs.attempts) - 1 > 0


def test_ladder_reads_a_nan_value_as_non_finite(monkeypatch):
    """A converged status on a NaN objective escalates to the log-domain
    sibling (the reference checks the status alone)."""
    p = _problem()
    monkeypatch.setattr("repro_torch.robust.ladder.solve",
                        lambda problem, method="dense", **kw: _fake(problem, method, "converged", "log"))
    rs = rb.escalate_from(p, "dense", _fake(p, "dense", "converged", value=float("nan")), metrics=MetricsRegistry())
    assert [t.action for t in rs.attempts] == ["initial", "log_domain"] and rs.recovered


# --------------------------------------------------------------------------
# The executor's ladder: failed elements only
# --------------------------------------------------------------------------


def _uot_points(count, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        x, a, b = rng.uniform(size=(n, 3)), rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))
        out.append(UOTProblem(PointCloudGeometry(x, device="cpu"), a * 5.0, b * 3.0, 0.1, lam=0.5))
    return out


def test_executor_ladder_escalates_only_failed_elements():
    problems = _uot_points(4, 64, 21)
    s = 8 * s0(64)
    problems[3] = rb.corrupt_scaling_kernel(problems[3], 7, mode="nan")
    caps = [None, rb.undersized_cap(s), None, None]
    from repro_torch.core.spar_sink import default_cap

    caps = [default_cap(s) if c is None else c for c in caps]
    ex = BucketedExecutor(metrics=MetricsRegistry())
    opts = dict(method="spar_sink_coo", seeds=range(4), s=s, cap=caps, tol=1e-6, max_iter=2000)
    plain = ex.solve_batch(problems, **opts)
    fills = ex.compile_count
    robust = ex.solve_batch(problems, robust=True, **opts)
    assert ex.compile_count == fills
    assert [r.escalated for r in robust] == [False, True, False, True]
    assert [a.action for a in robust[3].attempts] == ["initial", "log_domain"]
    assert robust[3].attempts[1].method == "spar_sink_log"
    assert robust[1].attempts[0].overflowed and all(a.action == "resketch" for a in robust[1].attempts[1:])
    assert all(r.recovered and r.status_label == "converged" for r in robust)
    for i in (0, 2):
        assert torch.equal(plain[i].result.u, robust[i].result.u) and torch.equal(plain[i].value, robust[i].value)
    assert ex.metrics.get_counter("ot_escalations_total") == sum(len(r.attempts) - 1 for r in robust)


def test_ladder_redraws_from_the_generators_first_state():
    """Through ``generators=`` (as `OTServer` passes its requests' sources)
    and ``solve(generator=, robust=True)``, the log-domain rung draws from
    each generator as attempt 0 found it: its support is attempt 0's, and
    the results are bitwise the ``seeds=`` ones."""
    problems = _uot_points(2, 64, 21)
    problems[1] = rb.corrupt_scaling_kernel(problems[1], 7, mode="nan")
    opts = dict(method="spar_sink_coo", s=8 * s0(64), tol=1e-6, max_iter=2000)
    ex = BucketedExecutor(metrics=MetricsRegistry())
    plain = ex.solve_batch(problems, seeds=[0, 1], **opts)
    by_seed = ex.solve_batch(problems, seeds=[0, 1], robust=True, **opts)
    by_gen = ex.solve_batch(problems, generators=[torch.Generator().manual_seed(i) for i in range(2)],
                            robust=True, **opts)
    method = opts.pop("method")
    alone = solve(problems[1], method, generator=torch.Generator().manual_seed(1), robust=True, **opts)
    first = plain[1].plan()
    nnz = int(first.nnz)
    for rs in (by_gen[1], alone):
        assert [(a.action, a.method) for a in rs.attempts] == [("initial", "spar_sink_coo"),
                                                                ("log_domain", "spar_sink_log")]
        plan = rs.plan()
        assert int(plan.nnz) == nnz
        assert torch.equal(plan.rows[:nnz], first.rows[:nnz]) and torch.equal(plan.cols[:nnz], first.cols[:nnz])
        assert torch.equal(rs.result.u, by_seed[1].result.u) and torch.equal(rs.value, by_seed[1].value)
    assert torch.equal(by_gen[0].result.u, by_seed[0].result.u)


# --------------------------------------------------------------------------
# Breaker and injectors
# --------------------------------------------------------------------------


def test_breaker_state_machine_under_skewed_clock():
    clock = rb.SkewedClock(base=lambda: 0.0)
    brk = rb.CircuitBreaker(rb.BreakerPolicy(failure_threshold=2, reset_timeout_s=5.0), clock=clock)
    assert brk.allow() and brk.state_label == "closed" and brk.state == rb.CircuitBreaker.CLOSED
    brk.record_failure()
    assert brk.allow()
    brk.record_failure()
    assert brk.state_label == "open" and not brk.allow()
    clock.advance(4.9)
    assert not brk.allow()
    clock.advance(0.2)
    assert brk.allow() and brk.state_label == "half_open"
    brk.record_failure()
    assert brk.state_label == "open"
    clock.advance(5.1)
    assert brk.allow()
    brk.record_success()
    assert brk.state_label == "closed" and brk.allow()


def test_skewed_clock():
    clock = rb.SkewedClock(base=lambda: 10.0)
    assert clock() == 10.0
    clock.advance(2.5)
    assert clock() == 12.5


def test_chaos_geometry_corrupts_only_the_scaling_kernel():
    base = Geometry(_cost(16, 16, 0), device="cpu")
    nan = rb.ChaosGeometry(base, 0, mode="nan")
    zero = rb.ChaosGeometry(base, 0, mode="zero")
    K = nan.kernel(0.1)
    assert bool(torch.isnan(K[nan.row]).all()) and int(torch.isnan(K).sum()) == 16
    assert not bool(zero.kernel(0.1).any())
    assert torch.equal(nan.log_kernel(0.1), base.log_kernel(0.1)) and torch.equal(nan.cost, base.cost)
    assert nan.row == rb.ChaosGeometry(base, 0).row  # a function of the seed
    with pytest.raises(ValueError, match="chaos mode"):
        rb.ChaosGeometry(base, 0, mode="exotic")
    pc = PointCloudGeometry(np.random.default_rng(1).uniform(size=(16, 3)), device="cpu")
    cpc = rb.ChaosGeometry(pc, 3)
    assert isinstance(cpc, PointCloudGeometry) and isinstance(cpc, rb.ChaosGeometry)
    rows, cols = torch.arange(16), torch.arange(16)
    k_e, c_e = cpc.entries(rows, cols, 0.1)
    k0, c0 = pc.entries(rows, cols, 0.1)
    assert torch.equal(c_e, c0) and bool(torch.isnan(k_e[cpc.row]))
    assert torch.equal(k_e[rows != cpc.row], k0[rows != cpc.row])


def test_flaky_executor_deterministic():
    class Echo:
        min_bucket = 64

        def solve_batch(self, problems, **kw):
            return list(problems)

    flaky = rb.FlakyExecutor(Echo(), seed=3, fail_rate=0.5, fail_calls={0})
    outcomes = []
    for t in range(12):
        try:
            flaky.solve_batch([t])
            outcomes.append(True)
        except rb.InjectedFault:
            outcomes.append(False)
    again = rb.FlakyExecutor(Echo(), seed=3, fail_rate=0.5, fail_calls={0})
    replay = []
    for t in range(12):
        try:
            again.solve_batch([t])
            replay.append(True)
        except rb.InjectedFault:
            replay.append(False)
    assert outcomes == replay and not outcomes[0] and 0 < sum(outcomes) < 12
    assert flaky.faults == outcomes.count(False) and flaky.min_bucket == 64
    with pytest.raises(ValueError, match="seed"):
        rb.FlakyExecutor(Echo(), fail_rate=0.1)
