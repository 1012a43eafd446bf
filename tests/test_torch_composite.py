"""The composite workloads built on `solve` (``repro_torch.core.divergence``,
``barycenter``, ``proximal``) against the reference on the same inputs.

* `sinkhorn_divergence` by ``dense`` and by ``log`` at rtol 1e-10, with
  ``with_status`` (the worst of the three codes); one random source feeds
  the three terms in order (xy, xx, yy), and a deterministic method
  ignores it.
* `ibp` with a shared and with a stacked kernel at rtol 1e-10, with the
  same ``n_iter`` and ``status``; `solve_barycenter`'s front end.
* `spar_ibp` and `prox_spar_sink` on the reference's own sketches (their
  helpers after the draw, `_spar_ibp_on` and `_prox_spar_sink_on`) at rtol
  1e-10; `prox_sinkhorn` at rtol 1e-10.
* The port's own draws within the reference tests' bounds: Spar-IBP's
  error falls with s and stays below 0.5 (test_barycenter.py); the sparse
  proximal plan's marginals stay within 0.05 (test_proximal.py); the
  Spar-Sink divergence's mean error over 4 draws is no worse than twice the
  reference's over 4 of its draws (or a quarter of the divergence).
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

from repro.core import barycenter as jbarycenter
from repro.core import proximal as jproximal
from repro.core import sparsify as jsparsify
from repro.core.divergence import sinkhorn_divergence as j_sinkhorn_divergence
from repro.core.divergence import spar_sink_divergence as j_spar_sink_divergence
from repro.core.spar_sink import default_cap as j_default_cap
from repro_torch import interop, sinkhorn_divergence, solve_barycenter, spar_sink_divergence
from repro_torch.core import barycenter, proximal
from repro_torch.core.geometry import gibbs_kernel, normalize_cost, squared_euclidean_cost
from repro_torch.core.sinkhorn import STATUS_CONVERGED, STATUS_MAX_ITER
from repro_torch.core.spar_sink import s0

RTOL = 1e-10


def _t(x):
    return torch.tensor(np.asarray(x))


def _carry(sk):
    """The reference's COO sketch as the port's, on the CPU."""
    return interop.sketch_from_numpy(
        np.asarray(sk.rows), np.asarray(sk.cols), np.asarray(sk.nnz), sk.n, sk.m, vals=np.asarray(sk.vals),
        csort=np.asarray(sk.csort), overflowed=np.asarray(sk.overflowed),
        n_proposed=np.asarray(sk.n_proposed), n_accepted=np.asarray(sk.n_accepted), device="cpu",
    )


def _close(t, j, rtol=RTOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=1e-300)


# --------------------------------------------------------------------------
# Sinkhorn divergence
# --------------------------------------------------------------------------


def _clouds(n=24, m=20, seed=0):
    """The reference's test_divergence_with_status inputs."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 2)), rng.normal(size=(m, 2)), rng.dirichlet(np.ones(n)),
            rng.dirichlet(np.ones(m)))


@pytest.mark.parametrize("method", ["dense", "log"])
def test_divergence_matches_reference(method):
    x, y, a, b = _clouds()
    v_j, st_j = j_sinkhorn_divergence(*map(jnp.asarray, (x, y, a, b)), 0.5, method=method, with_status=True)
    v_t, st_t = sinkhorn_divergence(*map(_t, (x, y, a, b)), 0.5, method=method, with_status=True)
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=RTOL)
    assert int(st_t) == int(st_j) == STATUS_CONVERGED
    assert float(sinkhorn_divergence(*map(_t, (x, y, a, b)), 0.5, method=method)) == float(v_t)


def test_divergence_with_status():
    x, y, a, b = map(_t, _clouds())
    v, st = sinkhorn_divergence(x, y, a, b, 0.5, with_status=True)
    assert int(st) == STATUS_CONVERGED
    assert float(v) == float(sinkhorn_divergence(x, y, a, b, 0.5))
    # one starved term taints the whole divergence with the worst code
    _, st_bad = sinkhorn_divergence(x, y, a, b, 0.5, with_status=True, max_iter=2, tol=1e-13)
    assert int(st_bad) == STATUS_MAX_ITER
    # greenkhorn reports no status, and takes neither tol nor max_iter
    v_g, st_g = sinkhorn_divergence(x, y, a, b, 0.5, method="greenkhorn", with_status=True)
    assert st_g is None and math.isfinite(float(v_g))


def test_divergence_feeds_one_generator_in_order():
    from repro_torch.core.api import Geometry, OTProblem, solve

    x, y, a, b = map(_t, _clouds())
    s = 200.0
    v = sinkhorn_divergence(x, y, a, b, 0.5, method="spar_sink_coo", seed=3, s=s)
    gen = torch.Generator().manual_seed(3)
    terms = [float(solve(OTProblem(Geometry.from_points(p, q), wp, wq, 0.5), method="spar_sink_coo",
                         generator=gen, s=s, tol=1e-6, max_iter=500).value)
             for p, q, wp, wq in ((x, y, a, b), (x, x, a, a), (y, y, b, b))]
    assert float(v) == terms[0] - 0.5 * (terms[1] + terms[2])
    assert float(spar_sink_divergence(x, y, a, b, 0.5, s, generator=torch.Generator().manual_seed(3))) == float(v)
    # a deterministic method ignores the random source
    assert float(sinkhorn_divergence(x, y, a, b, 0.5, seed=3)) == float(sinkhorn_divergence(x, y, a, b, 0.5))
    with pytest.raises(TypeError, match="exactly one of generator"):
        spar_sink_divergence(x, y, a, b, 0.5, s)


def test_spar_sink_divergence_within_reference_noise():
    x, y, a, b = _clouds(n=64, m=64, seed=1)
    s = 16 * s0(64)
    truth = float(sinkhorn_divergence(*map(_t, (x, y, a, b)), 0.5, tol=1e-9, max_iter=5000))
    err_t = np.mean([abs(float(spar_sink_divergence(*map(_t, (x, y, a, b)), 0.5, s, seed=i)) - truth)
                     for i in range(4)])
    err_j = np.mean([abs(float(j_spar_sink_divergence(jax.random.PRNGKey(i), *map(jnp.asarray, (x, y, a, b)),
                                                      0.5, s)) - truth) for i in range(4)])
    assert err_t < max(2.0 * err_j, 0.25 * abs(truth)), (err_t, err_j, truth)


# --------------------------------------------------------------------------
# Barycenters
# --------------------------------------------------------------------------


def _grid_measures(n=32, mm=3, eps=0.05):
    """The reference's test_barycenter_status inputs: a 1-D grid, 3 measures."""
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 1.0, n)[:, None]
    C = (x - x.T) ** 2
    return C, np.exp(-C / eps), rng.dirichlet(np.ones(n), size=mm), np.ones(mm) / mm


@pytest.mark.parametrize("stacked", [False, True], ids=["shared", "stacked"])
def test_ibp_matches_reference(stacked):
    _, K, bs, w = _grid_measures()
    Ks = np.stack([K * (1.0 + 0.1 * k) for k in range(3)]) if stacked else K
    for tol, max_iter in ((1e-8, 5000), (1e-13, 3)):
        res_j = jbarycenter.ibp(jnp.asarray(Ks), jnp.asarray(bs), jnp.asarray(w), tol=tol, max_iter=max_iter)
        res_t = barycenter.ibp(_t(Ks), _t(bs), _t(w), tol=tol, max_iter=max_iter)
        assert int(res_t.n_iter) == int(res_j.n_iter) and int(res_t.status) == int(res_j.status)
        for field in ("q", "u", "v"):
            _close(getattr(res_t, field), getattr(res_j, field))
        np.testing.assert_allclose(float(res_t.err), float(res_j.err), rtol=1e-8)
    assert bool(res_t.converged) is False and int(res_t.status) == STATUS_MAX_ITER


def test_barycenter_status():
    C, K, bs, w = map(_t, _grid_measures())
    res = barycenter.ibp(K, bs, w, tol=1e-8, max_iter=5000)
    assert int(res.status) == STATUS_CONVERGED and bool(res.converged)
    capped = barycenter.ibp(K, bs, w, tol=1e-13, max_iter=3)
    assert int(capped.status) == STATUS_MAX_ITER and not bool(capped.converged)
    front = solve_barycenter(C, bs, w, 0.05, tol=1e-8, max_iter=5000)
    assert int(front.status) == STATUS_CONVERGED
    j_front = jbarycenter.solve_barycenter(*map(jnp.asarray, _grid_measures()[::2]), jnp.asarray(w), 0.05,
                                           tol=1e-8, max_iter=5000)
    _close(front.q, j_front.q)
    with pytest.raises(TypeError, match="spar_ibp"):
        solve_barycenter(C, bs, w, 0.05, s=100.0)
    with pytest.raises(ValueError, match="requires s="):
        solve_barycenter(C, bs, w, 0.05, method="spar_ibp", s=100.0)
    with pytest.raises(KeyError, match="available: ibp, spar_ibp"):
        solve_barycenter(C, bs, w, 0.05, method="wasserstein")
    sparse = solve_barycenter(C, bs, w, 0.05, method="spar_ibp", seed=0, s=16 * 32.0, tol=1e-8, max_iter=5000)
    assert math.isfinite(float(sparse.err)) and abs(float(sparse.q.sum()) - 1.0) < 1e-3


def _scattered(n=64, mm=3, eps=0.05, seed=0):
    """The reference's test_barycenter.py setup: uniform points, normalized
    cost, Dirichlet measures smoothed by 1e-2 of their maximum."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(size=(n, 2)))
    C, _ = normalize_cost(squared_euclidean_cost(x, x))
    bs = rng.dirichlet(np.ones(n), size=mm)
    bs = bs + 1e-2 * bs.max(axis=1, keepdims=True)
    return gibbs_kernel(C, eps), torch.tensor(bs / bs.sum(axis=1, keepdims=True)), torch.full((mm,), 1.0 / mm)


@pytest.mark.parametrize("stacked", [False, True], ids=["shared", "stacked"])
def test_spar_ibp_on_reference_sketches(stacked):
    K, bs, w = _scattered()
    Ks = torch.stack([K * (1.0 + 0.1 * k) for k in range(3)]) if stacked else K
    key, s = jax.random.PRNGKey(4), 16 * 64.0
    res_j, nnz_j = jbarycenter.spar_ibp(key, jnp.asarray(Ks.numpy()), jnp.asarray(bs.numpy()), jnp.asarray(w.numpy()),
                                        s, tol=1e-10, max_iter=5000)
    # the reference's m sketches, as its spar_ibp draws them
    probs = jbarycenter.barycenter_sampling_probs(jnp.asarray(bs.numpy()))
    keys = jax.random.split(key, 3)
    sks = [_carry(jsparsify.sparsify_coo(keys[k], jnp.asarray((Ks if not stacked else Ks[k]).numpy()), probs[k], s,
                                         j_default_cap(s))) for k in range(3)]
    res_t, nnz_t = barycenter._spar_ibp_on(sks, bs, w, tol=1e-10, max_iter=5000)
    assert nnz_t.tolist() == np.asarray(nnz_j).tolist()
    assert int(res_t.n_iter) == int(res_j.n_iter) > 10 and int(res_t.status) == int(res_j.status)
    for field in ("q", "u", "v"):
        _close(getattr(res_t, field), getattr(res_j, field))


def test_spar_ibp_approaches_ibp_with_s():
    K, bs, w = _scattered(n=128)
    ref = barycenter.ibp(K, bs, w, tol=1e-10, max_iter=5000).q
    errs = []
    for mult in (4, 32):
        res, nnz = barycenter.spar_ibp(K, bs, w, mult * 128.0, seed=0, tol=1e-10, max_iter=5000)
        assert nnz.shape == (3,) and (nnz > 0).all()
        errs.append(float(torch.abs(res.q - ref).sum()))
    assert errs[1] < errs[0] and errs[1] < 0.5, errs


# --------------------------------------------------------------------------
# Proximal point OT
# --------------------------------------------------------------------------


def _prox_problem(n=30, seed=0):
    """The reference's test_proximal.py setup."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(size=(n, 3)))
    a, b = rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))
    C, _ = normalize_cost(squared_euclidean_cost(x, x))
    return torch.tensor(a), torch.tensor(b), C


def test_prox_sinkhorn_matches_reference():
    a, b, C = _prox_problem()
    res_j, T_j = jproximal.prox_sinkhorn(*(jnp.asarray(t.numpy()) for t in (C, a, b)), 0.05, n_outer=8,
                                         inner_iters=2000)
    res_t, T_t = proximal.prox_sinkhorn(C, a, b, 0.05, n_outer=8, inner_iters=2000)
    _close(T_t, T_j)
    np.testing.assert_allclose(float(res_t.cost), float(res_j.cost), rtol=RTOL)
    np.testing.assert_allclose(float(res_t.marginal_err), float(res_j.marginal_err), rtol=1e-6, atol=1e-14)
    assert int(res_t.n_outer) == 8 and float(res_t.marginal_err) < 1e-5


def test_prox_spar_sink_on_reference_sketch():
    a, b, C = _prox_problem(n=60, seed=1)
    key, s, eps = jax.random.PRNGKey(2), 16 * s0(60), 0.05
    Cj, aj, bj = (jnp.asarray(t.numpy()) for t in (C, a, b))
    res_j = jproximal.prox_spar_sink(key, Cj, aj, bj, eps, s, n_outer=6, inner_iters=1000)
    K = jnp.where(jnp.isinf(Cj), 0.0, jnp.exp(-Cj / eps))
    sk = _carry(jsparsify.sparsify_coo(key, K, jsparsify.ot_sampling_probs(aj, bj), s, j_default_cap(s)))
    res_t = proximal._prox_spar_sink_on(sk, C, a, b, n_outer=6, inner_tol=1e-8, inner_iters=1000)
    np.testing.assert_allclose(float(res_t.cost), float(res_j.cost), rtol=RTOL)
    np.testing.assert_allclose(float(res_t.marginal_err), float(res_j.marginal_err), rtol=1e-8, atol=1e-14)
    assert int(res_t.n_outer) == 6


def test_prox_spar_sink_marginals_feasible():
    a, b, C = _prox_problem(n=200, seed=2)
    res = proximal.prox_spar_sink(C, a, b, 0.05, 16 * s0(200), seed=0, n_outer=10, inner_iters=1000)
    assert float(res.marginal_err) < 0.05 and math.isfinite(float(res.cost))
    again = proximal.prox_spar_sink(C, a, b, 0.05, 16 * s0(200), generator=torch.Generator().manual_seed(0),
                                    n_outer=10, inner_iters=1000)
    assert float(again.cost) == float(res.cost)
