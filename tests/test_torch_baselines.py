"""The paper's competitors (``repro_torch.core.baselines`` and their registry
entries ``greenkhorn``, ``nys_sink``, ``screenkhorn_lite``) against the
reference, on the same inputs.

* Greenkhorn, balanced and ``fe < 1``, with the same ``K, a, b,
  n_updates``: ``u``, ``v`` and ``err`` at rtol 1e-10 (the greedy choices
  must agree update by update for that), and through ``solve()``.
* Screenkhorn-lite with tied (uniform) marginals, where only a stable sort
  picks the reference's atoms: the same atoms, ``n_iter``, ``status``, and
  scalings at rtol 1e-10.
* Nys-Sink on the reference's landmark set (re-derived with
  ``jax.random.choice`` and handed to `_nystrom_from_index`, which
  `nystrom_factors` also uses): the same ``n_iter`` and ``status``, the
  value at rtol 1e-12. The scalings carry the rounding of ``W^+`` times
  ``W``'s condition number, which grows fast for a Gaussian kernel's
  landmark block: at eps = 0.1, rank 24 (condition 7.6e3) they agree at
  rtol 1e-10; at eps = 2, rank 48 (condition 1.5e11, one singular value
  under ``pinv``'s cut at 1e-10 of the largest) at rtol 1e-6 (measured
  1.2e-7). The plan is held to the same tolerance times its largest entry
  (measured 2e-14 and 7e-9 of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers, and
# torch's default of one thread a core would put 48 threads on 8 cores
torch.set_num_threads(1)

from repro.core import baselines as jbaselines
from repro.core.api import Geometry as JGeometry
from repro.core.api import OTProblem as JOTProblem
from repro.core.api import UOTProblem as JUOTProblem
from repro.core.api import available_methods as javailable_methods
from repro.core.api import solve as jsolve
from repro_torch.core import baselines as tbaselines
from repro_torch.core.api import Geometry, OTProblem, UOTProblem, available_methods, solve

EPS = 0.1
LAM = 0.5
N = 96
RTOL = 1e-10


def _problems(kind, n=N, uniform=False, seed=3, eps=EPS):
    """(reference problem, port problem) on a dense squared-euclidean cost;
    UOT with masses 5 and 3; ``uniform`` gives every atom the same mass."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 3))
    if uniform:
        a = b = np.full(n, 1.0 / n)
    else:
        a, b = rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))
    jgeom, tgeom = JGeometry.from_points(jnp.asarray(x)), Geometry.from_points(x, device="cpu")
    if kind == "ot":
        return JOTProblem(jgeom, jnp.asarray(a), jnp.asarray(b), eps), OTProblem(tgeom, a, b, eps)
    a, b = 5 * a, 3 * b
    return (JUOTProblem(jgeom, jnp.asarray(a), jnp.asarray(b), eps, lam=LAM),
            UOTProblem(tgeom, a, b, eps, lam=LAM))


def _close(t, j, rtol=RTOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=1e-300)


def test_registry_is_the_reference_registry():
    assert available_methods() == javailable_methods()


def test_rho_matches_reference():
    rng = np.random.default_rng(0)
    x, y = rng.uniform(size=50), rng.uniform(size=50)
    x[:5], y[3:8] = 0.0, 0.0
    _close(tbaselines._rho(torch.tensor(x), torch.tensor(y)), jbaselines._rho(jnp.asarray(x), jnp.asarray(y)), 1e-14)


@pytest.mark.parametrize("kind", ["ot", "uot"], ids=["balanced", "fe<1"])
def test_greenkhorn_matches_reference(kind):
    jp, tp = _problems(kind)
    fe, n_updates = float(jp.fe), 5 * 2 * N
    res_j = jbaselines.greenkhorn(jp.kernel(), jp.a, jp.b, n_updates, fe=fe)
    res_t = tbaselines.greenkhorn(tp.kernel(), tp.a, tp.b, n_updates, fe=fe)
    assert int(res_t.n_iter) == n_updates and res_t.status is None
    for t, j in zip(res_t[:2], res_j[:2]):
        _close(t, j)
    np.testing.assert_allclose(float(res_t.err), float(res_j.err), rtol=RTOL)
    # the greedy updates moved every atom's scaling, and the error fell
    assert (res_t.u != 1).all() and (res_t.v != 1).all()


@pytest.mark.parametrize("kind", ["ot", "uot"])
def test_greenkhorn_solver_matches_reference(kind):
    jp, tp = _problems(kind, n=64)
    sol_j, sol_t = jsolve(jp, method="greenkhorn"), solve(tp, method="greenkhorn")
    assert sol_t.method == "greenkhorn" and int(sol_t.n_iter) == int(sol_j.n_iter) == 5 * 128
    assert sol_t.status is None and sol_j.status is None
    np.testing.assert_allclose(float(sol_t.value), float(sol_j.value), rtol=RTOL)
    _close(sol_t.plan(), sol_j.plan())
    sol_j, sol_t = jsolve(jp, method="greenkhorn", n_updates=37), solve(tp, method="greenkhorn", n_updates=37)
    assert int(sol_t.n_iter) == 37
    np.testing.assert_allclose(float(sol_t.value), float(sol_j.value), rtol=RTOL)


@pytest.mark.parametrize("kind", ["ot", "uot"])
@pytest.mark.parametrize("decimation", [3, 4])
def test_screenkhorn_lite_matches_reference_on_tied_marginals(kind, decimation):
    jp, tp = _problems(kind, uniform=True)
    res_j, rows_j, cols_j = jbaselines.screenkhorn_lite(jp.kernel(), jp.a, jp.b, decimation=decimation,
                                                        fe=jp.fe, renormalize=jp.is_balanced)
    res_t, rows_t, cols_t = tbaselines.screenkhorn_lite(tp.kernel(), tp.a, tp.b, decimation=decimation,
                                                        fe=tp.fe, renormalize=tp.is_balanced)
    # every mass ties: the reference's stable sort keeps the first atoms
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    np.testing.assert_array_equal(cols_t.numpy(), np.asarray(cols_j))
    np.testing.assert_array_equal(rows_t.numpy(), np.arange(N // decimation))
    assert int(res_t.n_iter) == int(res_j.n_iter) > 5 and int(res_t.status) == int(res_j.status)
    for t, j in zip(res_t[:2], res_j[:2]):
        _close(t, j)
    sol_j = jsolve(jp, method="screenkhorn_lite", decimation=decimation)
    sol_t = solve(tp, method="screenkhorn_lite", decimation=decimation)
    assert sol_t.status_label == sol_j.status_label and int(sol_t.n_iter) == int(sol_j.n_iter)
    np.testing.assert_allclose(float(sol_t.value), float(sol_j.value), rtol=RTOL)


def test_screenkhorn_lite_keeps_the_heaviest_atoms():
    _, tp = _problems("ot")
    res, rows, cols = tbaselines.screenkhorn_lite(tp.kernel(), tp.a, tp.b)
    assert rows.shape == (N // 3,)
    assert torch.equal(tp.a[rows], torch.sort(tp.a, descending=True).values[: N // 3])
    assert (res.u[rows] > 0).all()
    off = torch.ones(N, dtype=torch.bool)
    off[rows] = False
    assert (res.u[off] == 0).all()


@pytest.mark.parametrize("kind,eps,rank,rtol", [("ot", EPS, 24, RTOL), ("uot", EPS, 24, RTOL), ("ot", 2.0, 48, 1e-6)],
                         ids=["ot", "uot", "ot-cut"])
def test_nys_sink_on_reference_landmarks(kind, eps, rank, rtol, monkeypatch):
    jp, tp = _problems(kind, eps=eps)
    key = jax.random.PRNGKey(11)
    idx = np.asarray(jax.random.choice(key, N, shape=(rank,), replace=False))
    sol_j = jsolve(jp, method="nys_sink", key=key, rank=rank)
    # the port's own draw replaced by the reference's landmarks
    monkeypatch.setattr(tbaselines, "nystrom_factors",
                        lambda gen, K, r: tbaselines._nystrom_from_index(K, torch.tensor(idx)))
    sol_t = solve(tp, method="nys_sink", seed=0, rank=rank)
    assert sol_t.method == "nys_sink" and int(sol_t.n_iter) == int(sol_j.n_iter) > 3
    assert int(sol_t.status) == int(sol_j.status)
    np.testing.assert_allclose(float(sol_t.value), float(sol_j.value), rtol=1e-12)
    for t, j in zip(sol_t.result[:2], sol_j.result[:2]):
        _close(t, j, rtol)
    plan_j = np.asarray(sol_j.plan())
    np.testing.assert_allclose(sol_t.plan().numpy(), plan_j, rtol=0, atol=rtol * plan_j.max())


def test_nystrom_factors_draw_distinct_landmarks():
    _, tp = _problems("ot")
    K = tp.kernel()
    nk = tbaselines.nystrom_factors(torch.Generator().manual_seed(2), K, 20)
    again = tbaselines.nystrom_factors(torch.Generator().manual_seed(2), K, 20)
    assert nk.F.shape == (N, 20) and nk.G.shape == (20, N)
    assert torch.equal(nk.F, again.F)
    # G holds 20 distinct rows of K: the landmarks are drawn without replacement
    rows = {int(torch.nonzero((K == g).all(1))[0]) for g in nk.G}
    assert len(rows) == 20
    # on its own landmark columns the approximation is exact (W W^+ W = W)
    cols = sorted(rows)
    torch.testing.assert_close(nk.dense()[:, cols], K[:, cols], rtol=1e-6, atol=1e-9)
    assert (nk.matvec(torch.ones(N, dtype=K.dtype)) >= 0).all()
    sol = solve(tp, method="nys_sink", seed=5)
    assert np.isfinite(float(sol.value)) and sol.status_label is not None
