"""Port parity: the Sinkhorn loops and objectives, on the same inputs.

* Sparse loops run on the **reference's own sketch** (built by
  ``repro.core.api.solvers.build_mf_sketch`` / ``build_mf_log_sketch`` and
  carried across with `repro_torch.interop.sketch_from_numpy`): the same
  ``n_iter`` and ``status``, scalings/potentials and objective to rtol 1e-9.
* Dense ``dense``/``log`` solves on ``Geometry.from_points``: the same
  ``n_iter``/``status``, values to rtol 1e-10.

Both packages run float64; the tolerances allow for sums taken in another
order, amplified over a few hundred iterations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import Geometry as JGeometry
from repro.core.api import OTProblem as JOTProblem
from repro.core.api import PointCloudGeometry as JPointCloudGeometry
from repro.core.api import UOTProblem as JUOTProblem
from repro.core.api import solve as jsolve
from repro.core.api import solvers as jsolvers
from repro.core.spar_sink import coo_objective_ot_entries, coo_objective_uot_entries, s0
from repro.data.pointclouds import make_measures as j_make_measures
from repro_torch import interop
from repro_torch.core.api import Geometry, OTProblem, UOTProblem, solve
from repro_torch.core.api import solvers as tsolvers
from repro_torch.data.pointclouds import make_measures, make_uot_measures

EPS = 0.1
N = 256
TOL = 1e-9


def _measures(kind):
    if kind == "ot":
        return make_measures("C1", N, 4, seed=3)
    return make_uot_measures("C1", N, 4, seed=3)  # masses 5 and 3


def test_pointclouds_copy_matches_reference():
    for pattern in ("C1", "C2", "C3"):
        for t, j in zip(make_measures(pattern, 50, 3, seed=1), j_make_measures(pattern, 50, 3, seed=1)):
            np.testing.assert_array_equal(t, j)


def _problems(kind):
    a, b, x = _measures(kind)
    jgeom = JPointCloudGeometry(jnp.asarray(x))
    if kind == "ot":
        jp = JOTProblem(jgeom, jnp.asarray(a), jnp.asarray(b), EPS)
        tp = interop.problem_from_numpy(x, a, b, EPS, device="cpu")
    else:
        jp = JUOTProblem(jgeom, jnp.asarray(a), jnp.asarray(b), EPS, lam=0.5)
        tp = interop.problem_from_numpy(x, a, b, EPS, lam=0.5, device="cpu")
    return jp, tp


def _carry(sk, log: bool):
    arrays = dict(logvals=np.asarray(sk.logvals)) if log else dict(vals=np.asarray(sk.vals))
    return interop.sketch_from_numpy(
        np.asarray(sk.rows), np.asarray(sk.cols), np.asarray(sk.nnz), sk.n, sk.m,
        csort=np.asarray(sk.csort), overflowed=np.asarray(sk.overflowed),
        n_proposed=np.asarray(sk.n_proposed), n_accepted=np.asarray(sk.n_accepted),
        device="cpu", **arrays,
    )


def _same_result(res_t, res_j, rtol):
    assert int(res_t.n_iter) == int(res_j.n_iter)
    assert int(res_t.status) == int(res_j.status)
    np.testing.assert_allclose(res_t.u.numpy(), np.asarray(res_j.u), rtol=rtol)
    np.testing.assert_allclose(res_t.v.numpy(), np.asarray(res_j.v), rtol=rtol)


@pytest.mark.parametrize("kind", ["ot", "uot"])
@pytest.mark.parametrize("log", [False, True], ids=["scaling", "log"])
def test_sparse_loops_on_reference_sketch(kind, log):
    jp, tp = _problems(kind)
    key = jax.random.PRNGKey(4)
    s = 8 * s0(N)
    if log:
        jsk, jc = jsolvers.build_mf_log_sketch(jp, key, s)
        res_j = jsolvers._sparse_log_loop(jp, jsk, TOL, 5000)
        val_j = jsolvers._coo_log_value(jp, jsk, jc, res_j)
    else:
        jsk, jc = jsolvers.build_mf_sketch(jp, key, s)
        res_j = jsolvers._coo_scaling_loop(jp, jsk, TOL, 5000)
        if kind == "uot":
            val_j = coo_objective_uot_entries(jsk, jc, res_j, jp.a, jp.b, 0.5, EPS)
        else:
            val_j = coo_objective_ot_entries(jsk, jc, res_j, EPS)
    assert int(jsk.nnz) > 0 and not bool(jsk.overflowed)
    tsk = _carry(jsk, log)
    c_t = torch.tensor(np.asarray(jc))
    if log:
        res_t = tsolvers._sparse_log_loop(tp, tsk, TOL, 5000)
        val_t = tsolvers._coo_log_value(tp, tsk, c_t, res_t)
    else:
        res_t = tsolvers._coo_scaling_loop(tp, tsk, TOL, 5000)
        val_t = tsolvers._coo_value(tp, tsk, c_t, res_t)
    assert int(res_j.n_iter) > 10  # a real iteration, not an immediate exit
    _same_result(res_t, res_j, 1e-9)
    np.testing.assert_allclose(float(val_t), float(val_j), rtol=1e-9)


@pytest.mark.parametrize("kind", ["ot", "uot"])
@pytest.mark.parametrize("method", ["dense", "log"])
def test_dense_oracle_matches_reference(kind, method):
    rng = np.random.default_rng(11)
    n = 128
    x = rng.uniform(size=(n, 3))
    a, b = rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))
    if kind == "ot":
        jp = JOTProblem(JGeometry.from_points(jnp.asarray(x)), jnp.asarray(a), jnp.asarray(b), EPS)
        tp = OTProblem(Geometry.from_points(x, device="cpu"), a, b, EPS)
    else:
        jp = JUOTProblem(JGeometry.from_points(jnp.asarray(x)), jnp.asarray(5 * a),
                         jnp.asarray(3 * b), EPS, lam=0.5)
        tp = UOTProblem(Geometry.from_points(x, device="cpu"), 5 * a, 3 * b, EPS, lam=0.5)
    sol_j = jsolve(jp, method=method, tol=TOL, max_iter=5000)
    sol_t = solve(tp, method=method, tol=TOL, max_iter=5000)
    assert sol_t.domain == sol_j.domain
    _same_result(sol_t.result, sol_j.result, 1e-10)
    np.testing.assert_allclose(float(sol_t.value), float(sol_j.value), rtol=1e-10)
    for mt, mj in zip(sol_t.marginals(), sol_j.marginals()):
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-10)
