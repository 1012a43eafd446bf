"""The port's matrix-free sampler, held statistically and by its invariants.

JAX's threefry and torch's Philox give different random streams, so no
sketch is bitwise equal across the packages. The sampler is held instead to
``E[K~] = K`` entry-wise (the bound of the reference's
``test_mf_unbiased_sketch_small``: n=48, 300 draws) and to the sketch
layout every later stage relies on.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.api import Geometry, OTProblem, PointCloudGeometry, UOTProblem
from repro_torch.core.api import build_mf_log_sketch, build_mf_sketch
from repro_torch.core.spar_sink import s0

EPS = 0.1


def _points(n, d=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, d)), rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _problem(kind, n=256, seed=4):
    x, a, b = _points(n, seed=seed)
    if kind == "ot":
        return OTProblem(PointCloudGeometry(x, device="cpu"), a, b, EPS)
    geom = PointCloudGeometry(x, cost="wfr", eta=0.5, device="cpu")
    return UOTProblem(geom, 5 * a, 3 * b, EPS, lam=0.5)


def _weights(sk):
    """Linear sketch values (``exp(logvals)`` for a log-space sketch)."""
    return sk.vals if hasattr(sk, "vals") else torch.exp(sk.logvals)


@pytest.mark.parametrize("kind,log", [("ot", False), ("ot", True), ("uot", False)],
                         ids=["ot-scaling", "ot-log", "uot-thinned"])
def test_mf_sketch_unbiased(kind, log):
    """E[K~] = K entry-wise for the Poissonized factorized draw (with eq. 11
    acceptance thinning for UOT, and in log space for the log sketch)."""
    n = 48
    x, a, b = _points(n, seed=2)
    if kind == "ot":
        problem = OTProblem(PointCloudGeometry(x, device="cpu"), a, b, EPS)
        K = Geometry.from_points(x, device="cpu").kernel(EPS)
    else:
        problem = UOTProblem(PointCloudGeometry(x, cost="wfr", eta=0.5, device="cpu"),
                             5 * a, 3 * b, EPS, lam=0.5)
        K = Geometry.wfr(x, eta=0.5, device="cpu").kernel(EPS)
    build = build_mf_log_sketch if log else build_mf_sketch
    acc = torch.zeros((n, n), dtype=torch.float64)
    n_rep = 300
    for i in range(n_rep):
        sk, _ = build(problem, _gen(i), 400.0)
        acc.index_put_((sk.rows, sk.cols), _weights(sk), accumulate=True)
    mean = (acc / n_rep).numpy()
    K = K.numpy()
    assert np.abs(mean - K).mean() < 0.05 * K.mean() + 0.02
    assert abs(mean.sum() / K.sum() - 1.0) < 0.03  # total mass


@pytest.mark.parametrize("kind", ["ot", "uot"])
@pytest.mark.parametrize("log", [False, True], ids=["scaling", "log"])
def test_mf_sketch_invariants(kind, log):
    problem = _problem(kind)
    n, m = problem.shape
    build = build_mf_log_sketch if log else build_mf_sketch
    sk, c_e = build(problem, _gen(1), 8 * s0(n))
    w = _weights(sk).numpy()
    rows, cols, csort = sk.rows.numpy(), sk.cols.numpy(), sk.csort.numpy()
    nnz = int(sk.nnz)
    assert 0 < nnz <= sk.cap and not bool(sk.overflowed)
    assert (np.diff(rows) >= 0).all()  # row-sorted, padding at the end
    assert (np.diff(cols[csort]) >= 0).all()  # csort sorts the columns
    assert sorted(csort.tolist()) == list(range(sk.cap))  # a permutation
    assert (w[:nnz] > 0).all() and (w[nnz:] == 0).all()  # zeros compacted
    assert (rows[nnz:] == n - 1).all() and (cols[nnz:] == m - 1).all()
    pairs = set(zip(rows[:nnz].tolist(), cols[:nnz].tolist()))
    assert len(pairs) == nnz  # duplicates merged
    assert c_e.shape == (sk.cap,)  # costs stay index-aligned
    gathered = problem.geom.cost_entries(sk.rows[:nnz], sk.cols[:nnz])
    torch.testing.assert_close(c_e[:nnz], gathered, rtol=0, atol=0)
    assert int(sk.n_accepted) >= nnz  # merging only removes entries
    if kind == "uot":
        assert int(sk.n_accepted) < int(sk.n_proposed)  # thinning fired


@pytest.mark.parametrize("log", [False, True], ids=["scaling", "log"])
def test_mf_sketch_overflow_flag_and_determinism(log):
    problem = _problem("ot")
    build = build_mf_log_sketch if log else build_mf_sketch
    s = 8 * s0(256)
    small, _ = build(problem, _gen(0), s, cap=64)
    assert bool(small.overflowed) and int(small.n_proposed) > 64
    assert 0 < int(small.nnz) <= 64
    a, c_a = build(problem, _gen(7), s)
    b, c_b = build(problem, _gen(7), s)
    assert not bool(a.overflowed)
    for ta, tb in zip((*a[:4], a.csort, c_a), (*b[:4], b.csort, c_b)):
        torch.testing.assert_close(ta, tb, rtol=0, atol=0)  # same seed, same sketch


def test_log_sketch_matches_scaling_sketch_on_the_same_draw():
    """The two sketch builders consume the generator identically, so from
    one seed they sample the same support and ``exp(logvals) == vals``."""
    problem = _problem("ot")
    sk, _ = build_mf_sketch(problem, _gen(3), 8 * s0(256))
    lsk, _ = build_mf_log_sketch(problem, _gen(3), 8 * s0(256))
    torch.testing.assert_close(sk.rows, lsk.rows, rtol=0, atol=0)
    torch.testing.assert_close(sk.cols, lsk.cols, rtol=0, atol=0)
    torch.testing.assert_close(sk.vals, torch.exp(lsk.logvals), rtol=1e-12, atol=0)
    assert math.isinf(float(lsk.logvals[-1]))
