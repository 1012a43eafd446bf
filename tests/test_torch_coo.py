"""The port's eq. (7) Bernoulli sketches and the solvers on them, against the
reference (``spar_sink_coo``, ``spar_sink_log``, ``spar_sink_dense``,
``rand_sink``, ``spar_sink_mf(shared_variates=True)``, the legacy shims).

* Sampling probabilities (`uot_sampling_logprobs`, `poisson_keep_probs` in
  both forms, `uniform_prob_factors`) against the reference's arrays at
  rounding level (rtol 1e-13).
* The port's own draw (threefry and Philox streams differ, so no sketch is
  equal across the packages): one support for the three sketches from one
  generator state; the padding and overflow contract; E[K~] = K entry-wise
  (the bound of the reference's mf unbiasedness test: n = 48, 300 draws).
* Everything after the sketch on the **reference's own sketch** (carried by
  `interop.sketch_from_numpy`, or the reference's dense ``Kt``): the same
  ``n_iter`` and ``status``, value and scalings or potentials at rtol 1e-10.
* ``shared_variates=True`` bitwise ``spar_sink_coo``/``spar_sink_log``; the
  shims' `DeprecationWarning` and results equal to ``solve()``; the geometry
  helpers against the reference's arrays.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers, and
# torch's default of one thread a core would put 48 threads on 8 cores
torch.set_num_threads(1)

from repro.core import geometry as jgeometry
from repro.core import sparsify as jsparsify
from repro.core.api import Geometry as JGeometry
from repro.core.api import OTProblem as JOTProblem
from repro.core.api import PointCloudGeometry as JPointCloudGeometry
from repro.core.api import UOTProblem as JUOTProblem
from repro.core.api import solve as jsolve
from repro.core.api import solvers as jsolvers
from repro_torch import interop
from repro_torch.core import geometry as tgeometry
from repro_torch.core import sparsify
from repro_torch.core.api import Geometry, OTProblem, PointCloudGeometry, UOTProblem, solve
from repro_torch.core.api import solvers as tsolvers
from repro_torch.core.spar_sink import SparSinkSolution, s0, spar_sink_ot, spar_sink_uot

EPS = 0.1
LAM = 0.5
N = 128
TOL = 1e-9
MAX_ITER = 3000
RTOL = 1e-10


def _data(n=N, seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, 3)), rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))


def _problems(kind, n=N):
    """(reference problem, port problem) on the dense squared-euclidean cost;
    UOT with masses 5 and 3."""
    x, a, b = _data(n)
    jgeom, tgeom = JGeometry.from_points(jnp.asarray(x)), Geometry.from_points(x, device="cpu")
    if kind == "ot":
        return JOTProblem(jgeom, jnp.asarray(a), jnp.asarray(b), EPS), OTProblem(tgeom, a, b, EPS)
    a, b = 5 * a, 3 * b
    return (JUOTProblem(jgeom, jnp.asarray(a), jnp.asarray(b), EPS, lam=LAM),
            UOTProblem(tgeom, a, b, EPS, lam=LAM))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _carry(sk, log: bool):
    """The reference's sketch as the port's, on the CPU."""
    arrays = dict(logvals=np.asarray(sk.logvals)) if log else dict(vals=np.asarray(sk.vals))
    return interop.sketch_from_numpy(
        np.asarray(sk.rows), np.asarray(sk.cols), np.asarray(sk.nnz), sk.n, sk.m,
        csort=np.asarray(sk.csort), overflowed=np.asarray(sk.overflowed),
        n_proposed=np.asarray(sk.n_proposed), n_accepted=np.asarray(sk.n_accepted),
        device="cpu", **arrays,
    )


def _same_solution(sol_t, sol_j, rtol=RTOL):
    assert sol_t.method == sol_j.method and sol_t.domain == sol_j.domain
    assert int(sol_t.n_iter) == int(sol_j.n_iter) and int(sol_j.n_iter) > 10
    assert int(sol_t.status) == int(sol_j.status)
    np.testing.assert_allclose(float(sol_t.value), float(sol_j.value), rtol=rtol)
    for t, j in zip(sol_t.result[:2], sol_j.result[:2]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol)
    if sol_j.nnz is not None:
        assert int(sol_t.nnz) == int(sol_j.nnz)


# --------------------------------------------------------------------------
# Sampling probabilities
# --------------------------------------------------------------------------


def test_sampling_probabilities_match_reference():
    jp, tp = _problems("uot")
    cost = np.asarray(jp.geom.cost).copy()
    cost[3, :7] = np.inf  # blocked entries get log-probability -inf
    lp_j = jsparsify.uot_sampling_logprobs(jp.a, jp.b, jnp.asarray(cost), LAM, EPS)
    lp_t = sparsify.uot_sampling_logprobs(tp.a, tp.b, torch.tensor(cost), LAM, EPS)
    assert torch.isneginf(lp_t[3, :7]).all()
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-13)
    s = 16 * s0(N)
    probs_j, probs_t = np.asarray(jsolvers.sampling_probs(jp)), tsolvers.sampling_probs(tp)
    np.testing.assert_allclose(probs_t.numpy(), probs_j, rtol=1e-13, atol=1e-300)
    np.testing.assert_allclose(sparsify.poisson_keep_probs(probs_t, s).numpy(),
                               np.asarray(jsparsify.poisson_keep_probs(jnp.asarray(probs_j), s)), rtol=1e-13)
    fr, fc = sparsify.uniform_prob_factors(N, 2 * N, torch.float64, device="cpu")
    jfr, jfc = jsparsify.uniform_prob_factors(N, 2 * N, jnp.float64)
    np.testing.assert_array_equal(fr.numpy(), np.asarray(jfr))
    np.testing.assert_array_equal(fc.numpy(), np.asarray(jfc))
    np.testing.assert_array_equal(sparsify.poisson_keep_probs((fr, fc), s).numpy(),
                                  np.asarray(jsparsify.poisson_keep_probs((jfr, jfc), s)))


# --------------------------------------------------------------------------
# The port's own draw
# --------------------------------------------------------------------------


def test_three_bernoulli_sketches_keep_one_support():
    _, tp = _problems("ot")
    K, cost = tp.kernel(), tp.geom.cost
    probs, s = tsolvers.sampling_probs(tp), 16 * s0(N)
    cap = int(s + 6 * math.sqrt(s) + 16)
    for seed in range(3):
        Kt = sparsify.sparsify_dense(_gen(seed), K, probs, s)
        sk = sparsify.sparsify_coo(_gen(seed), K, probs, s, cap)
        lsk, c_e = sparsify.sparsify_coo_log(_gen(seed), cost, probs, EPS, s, cap)
        nnz = int(sk.nnz)
        flat = torch.nonzero(Kt.reshape(-1))[:, 0]
        assert not bool(sk.overflowed) and nnz == flat.shape[0] > 0
        torch.testing.assert_close(sk.rows[:nnz] * N + sk.cols[:nnz], flat, rtol=0, atol=0)
        for field in ("rows", "cols", "nnz", "csort", "n_proposed"):
            torch.testing.assert_close(getattr(lsk, field), getattr(sk, field), rtol=0, atol=0)
        torch.testing.assert_close(sk.vals[:nnz], Kt.reshape(-1)[flat], rtol=0, atol=0)
        torch.testing.assert_close(torch.exp(lsk.logvals[:nnz]), sk.vals[:nnz], rtol=1e-12, atol=0)
        torch.testing.assert_close(c_e[:nnz], cost[sk.rows[:nnz], sk.cols[:nnz]], rtol=0, atol=0)


@pytest.mark.parametrize("log", [False, True], ids=["coo", "log"])
def test_padding_and_overflow_contract(log):
    _, tp = _problems("ot")
    K, cost = tp.kernel(), tp.geom.cost
    probs, s = tsolvers.sampling_probs(tp), 16 * s0(N)
    flat = torch.nonzero(sparsify.sparsify_dense(_gen(2), K, probs, s).reshape(-1))[:, 0]
    true_nnz = flat.shape[0]

    def build(cap):
        if log:
            return sparsify.sparsify_coo_log(_gen(2), cost, probs, EPS, s, cap)
        return sparsify.sparsify_coo(_gen(2), K, probs, s, cap), None

    # a cap below the draw keeps the first cap hits in row-major order
    small, c_small = build(40)
    assert bool(small.overflowed) and int(small.nnz) == 40
    assert int(small.n_proposed) == true_nnz and int(small.n_accepted) == 40
    torch.testing.assert_close(small.rows * N + small.cols, flat[:40], rtol=0, atol=0)
    assert (torch.diff(small.cols[small.csort]) >= 0).all()
    # a cap above it pads with the last flat index: row n-1, column m-1
    big, c_big = build(true_nnz + 50)
    assert not bool(big.overflowed) and int(big.nnz) == true_nnz == int(big.n_accepted)
    assert (big.rows[true_nnz:] == N - 1).all() and (big.cols[true_nnz:] == N - 1).all()
    assert (torch.diff(big.rows) >= 0).all()
    if log:
        assert torch.isneginf(big.logvals[true_nnz:]).all() and torch.isfinite(big.logvals[:true_nnz]).all()
        assert torch.isposinf(c_big[true_nnz:]).all() and torch.isfinite(c_small).all()
    else:
        assert (big.vals[true_nnz:] == 0).all() and (big.vals[:true_nnz] > 0).all()


@pytest.mark.parametrize("probs_kind", ["eq9", "eq11-log", "uniform"])
def test_bernoulli_sketch_unbiased(probs_kind):
    """E[K~] = K entry-wise: eq. (9) probabilities, the eq. (11)
    log-probability branch of the log sketch, and Rand-Sink's factors."""
    n = 48
    x, a, b = _data(n, seed=2)
    geom = Geometry.from_points(x, device="cpu")
    K, cost = geom.kernel(EPS), geom.cost
    s, cap = 400.0, 1200
    if probs_kind == "uniform":
        probs = sparsify.uniform_prob_factors(n, n, torch.float64, device="cpu")
    else:
        probs = tsolvers.sampling_probs(OTProblem(geom, a, b, EPS))
    logp = sparsify.uot_sampling_logprobs(5 * torch.tensor(a), 3 * torch.tensor(b), cost, LAM, EPS)
    acc = torch.zeros((n, n), dtype=torch.float64)
    n_rep = 300
    for i in range(n_rep):
        if probs_kind == "eq11-log":
            sk, _ = sparsify.sparsify_coo_log(_gen(i), cost, None, EPS, s, cap, logprobs=logp)
            w = torch.exp(sk.logvals)
        else:
            sk = sparsify.sparsify_coo(_gen(i), K, probs, s, cap)
            w = sk.vals
        assert not bool(sk.overflowed)
        acc.index_put_((sk.rows, sk.cols), w, accumulate=True)
    mean, K = (acc / n_rep).numpy(), K.numpy()
    assert np.abs(mean - K).mean() < 0.05 * K.mean() + 0.02
    assert abs(mean.sum() / K.sum() - 1.0) < 0.03  # total mass


# --------------------------------------------------------------------------
# The solvers on the reference's sketch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ot", "uot"])
@pytest.mark.parametrize("method", ["spar_sink_coo", "rand_sink"])
def test_coo_solvers_on_reference_sketch(kind, method):
    jp, tp = _problems(kind)
    key, s = jax.random.PRNGKey(7), 16 * s0(N)
    probs = jsparsify.uniform_prob_factors(N, N, jnp.float64) if method == "rand_sink" else None
    jsk = jsolvers.build_coo_sketch(jp, key, s, probs=probs)
    sol_j = jsolve(jp, method=method, key=key, s=s, tol=TOL, max_iter=MAX_ITER)
    sol_t = tsolvers._spar_sink_coo_on(tp, _carry(jsk, log=False), TOL, MAX_ITER, method=method)
    _same_solution(sol_t, sol_j)
    for mt, mj in zip(sol_t.marginals(), sol_j.marginals()):
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("kind", ["ot", "uot"])
def test_spar_sink_log_on_reference_sketch(kind):
    """UOT runs the eq. (11) log-probability branch of the sketch."""
    jp, tp = _problems(kind)
    key, s = jax.random.PRNGKey(8), 16 * s0(N)
    jsk, jc = jsolvers.build_coo_log_sketch(jp, key, s)
    sol_j = jsolve(jp, method="spar_sink_log", key=key, s=s, tol=TOL, max_iter=MAX_ITER)
    sol_t = tsolvers._sparse_log_solution("spar_sink_log", tp, _carry(jsk, log=True), torch.tensor(np.asarray(jc)),
                                          TOL, MAX_ITER)
    _same_solution(sol_t, sol_j)


@pytest.mark.parametrize("kind", ["ot", "uot"])
def test_spar_sink_dense_on_reference_sketch(kind):
    jp, tp = _problems(kind)
    key, s = jax.random.PRNGKey(9), 16 * s0(N)
    Kt = jsparsify.sparsify_dense(key, jp.kernel(), jsolvers._resolve_probs(jp, None, 0.0), s)
    sol_j = jsolve(jp, method="spar_sink_dense", key=key, s=s, tol=TOL, max_iter=MAX_ITER)
    sol_t = tsolvers._spar_sink_dense_on(tp, torch.tensor(np.asarray(Kt)), TOL, MAX_ITER)
    _same_solution(sol_t, sol_j)
    np.testing.assert_allclose(sol_t.plan().numpy(), np.asarray(sol_j.plan()), rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("method", ["spar_sink_coo", "spar_sink_log", "spar_sink_dense", "rand_sink"])
def test_sketch_solvers_run_and_repeat(method):
    """The registered solvers on the port's own draw: finite, a sketch of
    the expected size, and bitwise equal for one seed; ``generator=`` is
    ``seed=``'s generator."""
    _, tp = _problems("uot")
    s = 16 * s0(N)
    sol = solve(tp, method=method, seed=4, s=s, tol=TOL, max_iter=MAX_ITER)
    again = solve(tp, method=method, generator=_gen(4), s=s, tol=TOL, max_iter=MAX_ITER)
    assert sol.method == method and math.isfinite(float(sol.value))
    assert 0.5 * s < int(sol.nnz) < 1.5 * s
    assert float(sol.value) == float(again.value) and torch.equal(sol.result.u, again.result.u)


# --------------------------------------------------------------------------
# Modes, shims and helpers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ot", "uot"])
@pytest.mark.parametrize("stabilize", [False, True], ids=["scaling", "log"])
def test_shared_variates_is_bitwise_the_dense_sketch_solver(kind, stabilize):
    x, a, b = _data()
    geom = PointCloudGeometry(x, device="cpu")
    tp = OTProblem(geom, a, b, EPS) if kind == "ot" else UOTProblem(geom, 5 * a, 3 * b, EPS, lam=LAM)
    s = 16 * s0(N)
    mf = solve(tp, method="spar_sink_mf", seed=6, s=s, shared_variates=True, stabilize=stabilize,
               tol=TOL, max_iter=MAX_ITER)
    coo = solve(tp, method="spar_sink_log" if stabilize else "spar_sink_coo", seed=6, s=s,
                tol=TOL, max_iter=MAX_ITER)
    assert mf.method == "spar_sink_mf" and mf.domain == coo.domain
    assert int(mf.n_iter) == int(coo.n_iter) and int(mf.status) == int(coo.status)
    assert torch.equal(mf.result.u, coo.result.u) and torch.equal(mf.result.v, coo.result.v)
    # only the objective's costs differ: gathered from the points, or read
    # from the dense cost matrix (the log sketch reads the matrix for both)
    np.testing.assert_allclose(float(mf.value), float(coo.value), rtol=1e-12)


@pytest.mark.parametrize("method", ["coo", "dense", "block_ell"])
def test_legacy_shims_warn_and_equal_solve(method):
    x, a, b = _data(N)
    C = tgeometry.squared_euclidean_cost(torch.tensor(x), torch.tensor(x))
    s = 16 * s0(N)
    name = {"coo": "spar_sink_coo", "dense": "spar_sink_dense", "block_ell": "spar_sink_block_ell"}[method]
    opts = dict(block=32) if method == "block_ell" else {}
    with pytest.warns(DeprecationWarning, match="spar_sink_ot"):
        old = spar_sink_ot(C, a, b, EPS, s, seed=1, method=method, **opts)
    new = solve(OTProblem(Geometry(C), a, b, EPS), method=name, seed=1, s=s, **opts)
    assert isinstance(old, SparSinkSolution)
    assert float(old.value) == float(new.value) and int(old.nnz) == int(new.nnz)
    assert torch.equal(old.result.u, new.result.u) and torch.equal(old.result.v, new.result.v)
    with pytest.warns(DeprecationWarning, match="spar_sink_uot"):
        old = spar_sink_uot(C, 5 * a, 3 * b, LAM, EPS, s, generator=_gen(2), method=method, **opts)
    new = solve(UOTProblem(Geometry(C), 5 * a, 3 * b, EPS, lam=LAM), method=name, seed=2, s=s, **opts)
    assert float(old.value) == float(new.value) and torch.equal(old.result.v, new.result.v)


def test_legacy_shims_refuse_unknown_methods():
    C = torch.ones((4, 4), dtype=torch.float64)
    a = np.full(4, 0.25)
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="unknown method"):
        spar_sink_ot(C, a, a, EPS, 8.0, seed=0, method="mf")


def test_new_helpers_without_device_raise_instead_of_running_on_cpu(monkeypatch):
    """The device rule of `repro_torch._device`: ``device=None`` means the
    card, and with no card present the helpers raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
        lambda: sparsify.uniform_prob_factors(8, 8, torch.float64),
        lambda: sparsify.uniform_probs(8, 8, torch.float64),
        lambda: tgeometry.grid_support_2d(3, 4),
        lambda: Geometry.from_grid(3, 4),
        lambda: PointCloudGeometry.from_grid(3, 4),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    fr, fc = sparsify.uniform_prob_factors(8, 8, torch.float64, device="cpu")
    assert fr.device.type == fc.device.type == "cpu"


def test_geometry_helpers_match_reference():
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        np.testing.assert_array_equal(tgeometry.grid_support_2d(5, 7, dtype, device="cpu").numpy(),
                                      np.asarray(jgeometry.grid_support_2d(5, 7, jdtype)))
    x, _, _ = _data(40)
    y = x[::-1] + 0.1
    np.testing.assert_allclose(tgeometry.kernel_from_points(torch.tensor(x), torch.tensor(y), EPS).numpy(),
                               np.asarray(jgeometry.kernel_from_points(jnp.asarray(x), jnp.asarray(y), EPS)),
                               rtol=1e-12)
    for eta in (None, 0.3):
        jg, tg = JGeometry.from_grid(6, 5, eta=eta), Geometry.from_grid(6, 5, eta=eta, device="cpu")
        np.testing.assert_allclose(tg.cost.numpy(), np.asarray(jg.cost), rtol=1e-12, atol=1e-15)
        jpc, tpc = JPointCloudGeometry.from_grid(6, 5, eta=eta), PointCloudGeometry.from_grid(6, 5, eta=eta, device="cpu")
        assert tpc.cost_name == jpc.cost_name and tpc.x.dtype == torch.float64
        np.testing.assert_array_equal(tpc.x.numpy(), np.asarray(jpc.x))
        np.testing.assert_allclose(tpc.cost_block(3, 17, 2, 30).numpy(), np.asarray(jpc.cost_block(3, 17, 2, 30)),
                                   rtol=1e-12, atol=1e-15)
    guarded = PointCloudGeometry(x, y, device="cpu", dense_guard=16)
    with pytest.raises(ValueError, match="cost_block"):
        guarded.cost
    torch.testing.assert_close(guarded.cost_block(0, 40, 0, 40),
                               tgeometry.squared_euclidean_cost(guarded.x, guarded.y), rtol=0, atol=0)
