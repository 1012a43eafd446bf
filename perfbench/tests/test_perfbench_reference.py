"""The yardstick checked before it judges: the reference's Sinkhorn on a
full sketch (every pair kept) against a dense float64 Sinkhorn, its judge
on an exact estimate, and the control (one precision down) found not
correct at a small size."""
import math

import pytest
import torch

torch.set_num_threads(1)

from perfbench.harness.judge import NUMBERS  # noqa: E402
from perfbench.harness.manifest import Cell, load  # noqa: E402
from perfbench.reference.control import control_estimate  # noqa: E402
from perfbench.reference.spar_sink import (  # noqa: E402
    Estimate,
    Inputs,
    judge,
    log_rates,
    objective,
    sinkhorn_log,
    sinkhorn_scaling,
    sq_costs,
)

N, D, EPS = 48, 3, 0.1


def _inputs(lam: float, s: float = 1.0, seed: int = 0) -> Inputs:
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((N, D), dtype=torch.float64, generator=g)
    a = torch.rand(N, dtype=torch.float64, generator=g) + 0.1
    b = torch.rand(N, dtype=torch.float64, generator=g) + 0.1
    a, b = a / a.sum(), b / b.sum()
    if not math.isinf(lam):
        a, b = 5 * a, 3 * b
    return Inputs(x, a, b, EPS, lam, s)


def _dense_value(inp: Inputs) -> float:
    """Dense float64 Sinkhorn (scaling domain, to 1e-13) and its objective."""
    c = torch.cdist(inp.x, inp.x) ** 2
    k = torch.exp(-c / inp.eps)
    u, v = torch.ones_like(inp.a), torch.ones_like(inp.b)
    for _ in range(20000):
        u_new = (inp.a / (k @ v)) ** inp.fe
        v_new = (inp.b / (k.T @ u_new)) ** inp.fe
        done = float((u_new - u).abs().sum() + (v_new - v).abs().sum()) < 1e-13
        u, v = u_new, v_new
        if done:
            break
    t = u[:, None] * k * v[None, :]
    val = (t * c).sum() + inp.eps * (t * (torch.log(t) - 1)).sum()
    if not math.isinf(inp.lam):
        def kl(p, q):
            return (p * torch.log(p / q) - p + q).sum()
        val = val + inp.lam * (kl(t.sum(1), inp.a) + kl(t.sum(0), inp.b))
    return float(val)


def _full_sketch(inp: Inputs):
    rows = torch.arange(N).repeat_interleave(N)
    cols = torch.arange(N).repeat(N)
    costs = sq_costs(inp.x, inp.x, rows, cols)
    return rows, cols, costs, -costs / inp.eps


@pytest.mark.parametrize("lam", [math.inf, 0.5])
@pytest.mark.parametrize("loop", [sinkhorn_scaling, sinkhorn_log])
def test_full_sketch_matches_dense_sinkhorn(lam, loop):
    inp = _inputs(lam)
    rows, cols, costs, logk = _full_sketch(inp)
    f, g = loop(rows, cols, logk, inp, 1e-13, 20000)
    assert abs(objective(rows, cols, logk, costs, f, g, inp) / _dense_value(inp) - 1) < 1e-10


@pytest.mark.parametrize("lam", [math.inf, 0.5])
def test_judge_finds_an_exact_estimate_correct(lam):
    """An estimate built by the reference itself on a draw of multiplicities
    reads rounding in every number but the draw's deviation."""
    inp = _inputs(lam, s=4000.0, seed=1)
    rows, cols, costs, _ = _full_sketch(inp)
    g = torch.Generator().manual_seed(2)
    est = control_estimate(inp, g, "log", 1e-9, 5000)  # float32 weights: the control's own arithmetic
    logw = log_rates(inp, est.rows, est.cols, sq_costs(inp.x, inp.x, est.rows, est.cols))
    mult = torch.round(torch.exp(torch.log(est.plan) - est.f[est.rows] / EPS - est.g[est.cols] / EPS - logw))
    logk = torch.log(mult) + logw
    f, gg = sinkhorn_log(est.rows, est.cols, logk, inp, 1e-9, 5000)
    plan = torch.exp(logk + f[est.rows] / EPS + gg[est.cols] / EPS)
    value = objective(est.rows, est.cols, logk, sq_costs(inp.x, inp.x, est.rows, est.cols), f, gg, inp)
    got = judge(inp, Estimate(est.rows, est.cols, plan, f, gg, value, "log", 1e-9, 5000))
    assert got["sketch_gap"] < 1e-12 and got["value_gap"] < 1e-12 and got["marginal_gap"] < 1e-7
    assert got["draw_dev"] < 5


@pytest.mark.parametrize("workload", [w["name"] for w in load()["workloads"]])
def test_control_is_not_correct(workload):
    """The control, at a size a test run holds, fails at least one of the
    cell's limits, and the same numbers read by the chip (PERF.md) fail
    the sketch's or the value's."""
    cell = Cell(load(), workload)
    domain = "log" if cell.traffic.get("stabilize") else "scaling"
    lam = math.inf if cell.config["kind"] == "estimate" else 0.5
    inp = _inputs(lam, s=20000.0, seed=3)
    est = control_estimate(inp, torch.Generator().manual_seed(4), domain, 1e-6, 2000)
    got = judge(inp, est)
    assert set(got) == set(NUMBERS)
    assert any(got[k] > cell.limits[k]["limit"] for k in NUMBERS), got
