"""The port's quality certificates (``repro_torch.obs.certify``, the
``certify=`` option of the eleven methods) and the sketch solvers' traces,
against the reference on the same inputs.

* Every method, OT and UOT: the certificate of the reference's solve and
  the port's, at rtol 1e-10 (``spar_sink_log`` and the log-domain
  ``spar_sink_mf``: 1e-9, C-4; ``nys_sink``: 1e-9, its ``cost_scale`` is
  ``-eps log`` of the low-rank kernel's smallest positive entry, which
  carries the rounding of the landmark block's pseudo-inverse, condition
  7.6e3), with an absolute floor of 1e-12 x
  max(1, |value|) (at convergence the gap and the marginal errors are
  differences of O(value) quantities, so their rounding is absolute). This
  holds the port to the reference's values, not to the 3x tightness pin
  (C-3). The random methods run on the reference's own draw: its sketches
  (`interop.sketch_from_numpy`, `interop.block_ell_sketch_from_numpy`, its
  dense ``Kt``) and its Nystrom landmarks. For the methods that take
  ``trace=``, the same solve also holds the traces (rings at the same
  tolerances, the same matvec count) and the `SketchStats`.
* ``certify=False`` runs none of the certificate's ops (``expm1`` appears
  only in the UOT dual), ``certify=True`` does.
* The certificate functions alone: `importance_ess`, `sparse_certificate`
  without inclusion probabilities and on unsorted columns, an empty
  support, `dense_certificate` with dead atoms and blocked costs.
* The bound holds against the dense ``log`` oracle on the port's own draws
  (the configuration of the reference's validity test at eps = 0.1).
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
from torch.utils._python_dispatch import TorchDispatchMode

from repro import obs as jobs
from repro.core import sparsify as jsparsify
from repro.core.api import Geometry as JGeometry
from repro.core.api import OTProblem as JOTProblem
from repro.core.api import PointCloudGeometry as JPointCloudGeometry
from repro.core.api import UOTProblem as JUOTProblem
from repro.core.api import solve as jsolve
from repro.core.api import solvers as jsolvers
from repro.core.spar_sink import default_max_blocks as j_default_max_blocks
from repro_torch import interop, obs
from repro_torch.core import baselines as tbaselines
from repro_torch.core.api import Geometry, OTProblem, PointCloudGeometry, UOTProblem, available_methods, solve
from repro_torch.core.api import solvers as tsolvers
from repro_torch.core.spar_sink import s0

EPS = 0.1
LAM = 0.5
N = 96
TOL = 1e-9
MAX_ITER = 3000
BLOCK = 32


def _problems(kind):
    """(reference problem, port problem) on one point cloud (below
    ``dense_guard`` every method runs on it; its kernel is PSD, as Nys-Sink
    needs); UOT with masses 5 and 3."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(N, 3))
    a, b = rng.dirichlet(np.ones(N)), rng.dirichlet(np.ones(N))
    jgeom = JPointCloudGeometry(jnp.asarray(x))
    tgeom = PointCloudGeometry(x, device="cpu")
    if kind == "ot":
        return JOTProblem(jgeom, jnp.asarray(a), jnp.asarray(b), EPS), OTProblem(tgeom, a, b, EPS)
    return (JUOTProblem(jgeom, jnp.asarray(5 * a), jnp.asarray(3 * b), EPS, lam=LAM),
            UOTProblem(tgeom, 5 * a, 3 * b, EPS, lam=LAM))


def _carry(sk, log: bool):
    """The reference's sketch as the port's, on the CPU."""
    arrays = dict(logvals=np.asarray(sk.logvals)) if log else dict(vals=np.asarray(sk.vals))
    return interop.sketch_from_numpy(
        np.asarray(sk.rows), np.asarray(sk.cols), np.asarray(sk.nnz), sk.n, sk.m,
        csort=np.asarray(sk.csort), overflowed=np.asarray(sk.overflowed),
        n_proposed=np.asarray(sk.n_proposed), n_accepted=np.asarray(sk.n_accepted),
        device="cpu", **arrays,
    )


def _t(x):
    return torch.tensor(np.asarray(x))


#: every registered method: whether it takes trace=, and its rtol
METHODS = {
    "dense": (True, 1e-10), "log": (True, 1e-10), "spar_sink_coo": (True, 1e-10), "rand_sink": (True, 1e-10),
    "spar_sink_log": (True, 1e-9), "spar_sink_mf": (True, 1e-10), "spar_sink_mf_log": (True, 1e-9),
    "spar_sink_dense": (True, 1e-10), "spar_sink_block_ell": (True, 1e-10), "greenkhorn": (False, 1e-10),
    "nys_sink": (False, 1e-9), "screenkhorn_lite": (False, 1e-10),
}


def _solutions(method, kind, monkeypatch):
    """The reference's certified (and, where taken, traced) solve and the
    port's on the same inputs: the reference's draw for the random methods."""
    jp, tp = _problems(kind)
    traced = METHODS[method][0]
    opts = dict(certify=True, **({"trace": True} if traced else {}))
    key, s = jax.random.PRNGKey(7), 16 * s0(N)
    loop = dict(tol=TOL, max_iter=MAX_ITER)
    if method in ("dense", "log", "greenkhorn", "screenkhorn_lite"):
        loop = {} if method == "greenkhorn" else loop
        return jsolve(jp, method=method, **loop, **opts), solve(tp, method=method, **loop, **opts)
    if method == "nys_sink":
        # the landmarks of tests/test_torch_baselines.py (kernel condition 7.6e3)
        key, rank = jax.random.PRNGKey(11), 24
        idx = np.asarray(jax.random.choice(key, N, shape=(rank,), replace=False))
        monkeypatch.setattr(tbaselines, "nystrom_factors",
                            lambda gen, K, r: tbaselines._nystrom_from_index(K, torch.tensor(idx)))
        return (jsolve(jp, method=method, key=key, rank=rank, **loop, **opts),
                solve(tp, method=method, seed=0, rank=rank, **loop, **opts))
    if method == "spar_sink_mf_log":
        sol_j = jsolve(jp, method="spar_sink_mf", key=key, s=s, stabilize=True, **loop, **opts)
        jsk, jc = jsolvers.build_mf_log_sketch(jp, key, s)
        return sol_j, tsolvers._sparse_log_solution("spar_sink_mf", tp, _carry(jsk, True), _t(jc), **loop, **opts)
    if method == "spar_sink_block_ell":
        sol_j = jsolve(jp, method=method, key=key, s=s, block=BLOCK, **loop, **opts)
        tile_p = jsparsify.tile_probs_from_elem(jsolvers._resolve_probs(jp, None, 0.0), BLOCK)
        rows, cols = jsparsify.sparsify_block_ell_pair(key, jp.kernel(), tile_p, s, BLOCK,
                                                       j_default_max_blocks(N, s, BLOCK))
        sk = interop.block_ell_sketch_from_numpy(
            *(np.asarray(t) for t in (rows.vals, rows.col_idx, rows.nblocks)), N, N,
            vals_t=np.asarray(cols.vals), col_idx_t=np.asarray(cols.col_idx), nblocks_t=np.asarray(cols.nblocks),
            device="cpu",
        )
        return sol_j, tsolvers._block_ell_solution(tp, sk, TOL, MAX_ITER, **opts)
    sol_j = jsolve(jp, method=method, key=key, s=s, **loop, **opts)
    if method in ("spar_sink_coo", "rand_sink"):
        probs = jsparsify.uniform_prob_factors(N, N, jnp.float64) if method == "rand_sink" else None
        jsk = jsolvers.build_coo_sketch(jp, key, s, probs=probs)
        return sol_j, tsolvers._spar_sink_coo_on(tp, _carry(jsk, False), TOL, MAX_ITER, method=method, **opts)
    if method == "spar_sink_log":
        jsk, jc = jsolvers.build_coo_log_sketch(jp, key, s)
        return sol_j, tsolvers._sparse_log_solution(method, tp, _carry(jsk, True), _t(jc), **loop, **opts)
    if method == "spar_sink_mf":
        jsk, jc = jsolvers.build_mf_sketch(jp, key, s)
        return sol_j, tsolvers._scaling_sketch_solution(method, tp, _carry(jsk, False), _t(jc), **loop, **opts)
    # spar_sink_dense
    Kt = jsparsify.sparsify_dense(key, jp.kernel(), jsolvers._resolve_probs(jp, None, 0.0), s)
    return sol_j, tsolvers._spar_sink_dense_on(tp, _t(Kt), TOL, MAX_ITER, **opts)


def _same_certificate(ct, cj, rtol):
    floor = 1e-12 * max(1.0, abs(float(cj.value)))
    for field in cj._fields:
        t, j = float(getattr(ct, field)), float(getattr(cj, field))
        if math.isnan(j):
            assert math.isnan(t), field
        else:
            np.testing.assert_allclose(t, j, rtol=rtol, atol=floor, err_msg=field)
    np.testing.assert_allclose(float(ct.ci_width), float(cj.ci_width), rtol=rtol, atol=floor)


def _same_ring(t, j, rtol):
    """Traced records at ``rtol``, with an absolute floor of 1e-12 x the
    first (largest) record: late errors are differences of O(1) scalings."""
    assert t.shape == j.shape and t.size > 0
    np.testing.assert_allclose(t, j, rtol=rtol, atol=1e-12 * abs(j[0]))


@pytest.mark.parametrize("kind", ["ot", "uot"])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_certificate_matches_reference(method, kind, monkeypatch):
    sol_j, sol_t = _solutions(method, kind, monkeypatch)
    traced, rtol = METHODS[method]
    assert int(sol_t.n_iter) == int(sol_j.n_iter) > 3
    assert (sol_t.status is None) == (sol_j.status is None)
    if sol_j.status is not None:
        assert int(sol_t.status) == int(sol_j.status)
    np.testing.assert_allclose(float(sol_t.value), float(sol_j.value), rtol=rtol)
    ct, cj = sol_t.certificate, sol_j.certificate
    _same_certificate(ct, cj, rtol)
    assert float(ct.gap) >= 0.0 and float(ct.error_bound) >= float(ct.gap)
    sketched = method not in ("dense", "log", "greenkhorn", "nys_sink", "screenkhorn_lite",
                              "spar_sink_dense", "spar_sink_block_ell")
    assert math.isfinite(float(ct.ci_width)) == sketched and math.isfinite(float(ct.ess)) == sketched
    dt, dj = sol_t.diagnostics, sol_j.diagnostics
    assert dt.certificate is ct
    assert dt.summary()["certificate"]["error_bound"] == float(ct.error_bound)
    if not traced:
        assert dt.trace is None and dt.n_matvec == 0
        return
    assert dt.n_matvec == dj.n_matvec == 2 * int(sol_t.n_iter)
    assert dt.first_traced_iteration == dj.first_traced_iteration
    _same_ring(dt.iteration_errors(), dj.iteration_errors(), rtol)
    _same_ring(dt.marginal_errors(), dj.marginal_errors(), rtol)
    assert (dt.sketch is None) == (dj.sketch is None)
    if dj.sketch is not None:
        assert int(dt.sketch.nnz) == int(dj.sketch.nnz) and dt.sketch.cap == dj.sketch.cap
        np.testing.assert_allclose(float(dt.sketch.ess), float(dj.sketch.ess), rtol=1e-12)


def test_every_method_is_covered():
    assert {m.removesuffix("_log") if m == "spar_sink_mf_log" else m for m in METHODS} == set(available_methods())


# --------------------------------------------------------------------------
# certify=False runs none of the certificate's ops
# --------------------------------------------------------------------------


class _OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func._overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


#: each method's options for a quick solve on the port's own draw
QUICK = {
    "dense": {}, "log": {}, "greenkhorn": dict(n_updates=40), "screenkhorn_lite": {},
    "nys_sink": dict(seed=0), "spar_sink_coo": dict(seed=0, s=800.0), "spar_sink_log": dict(seed=0, s=800.0),
    "spar_sink_mf": dict(seed=0, s=800.0), "spar_sink_dense": dict(seed=0, s=800.0),
    "rand_sink": dict(seed=0, s=800.0), "spar_sink_block_ell": dict(seed=0, s=800.0, block=BLOCK),
}


@pytest.mark.parametrize("method", sorted(QUICK))
def test_certify_false_runs_no_certificate_op(method):
    """``expm1`` appears only in the certificate's UOT dual (the canary of
    the reference's test_certify_false_jaxpr_identical)."""
    _, tp = _problems("uot")
    with _OpNames() as off:
        sol = solve(tp, method=method, **QUICK[method])
    with _OpNames() as on:
        cert = solve(tp, method=method, certify=True, **QUICK[method])
    assert sol.certificate is None and "expm1" not in off.names
    assert cert.certificate is not None and "expm1" in on.names
    assert float(cert.value) == float(sol.value)


# --------------------------------------------------------------------------
# The certificate functions alone
# --------------------------------------------------------------------------


def test_importance_ess_matches_reference():
    rng = np.random.default_rng(0)
    w = rng.exponential(size=200)
    w[150:] = 0.0
    logw = np.where(w > 0, np.log(np.where(w > 0, w, 1.0)) - 700.0, -np.inf)  # exp() flushes to 0
    for x, log in ((w, False), (logw, True)):
        np.testing.assert_allclose(float(obs.importance_ess(torch.tensor(x), log_space=log)),
                                   float(jobs.importance_ess(jnp.asarray(x), log_space=log)), rtol=1e-12)
    assert float(obs.importance_ess(torch.tensor(logw), log_space=True)) > 1.0
    assert float(obs.importance_ess(torch.zeros(3, dtype=torch.float64))) == 0.0
    assert float(obs.importance_ess(torch.full((3,), -math.inf, dtype=torch.float64), log_space=True)) == 0.0


def _coo_inputs(k=300, n=40, m=30, seed=1):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, n, size=k))
    cols = rng.integers(0, m, size=k)  # unsorted
    t_e = rng.exponential(size=k) / k
    t_e[-20:] = 0.0  # padding
    c_e = rng.uniform(size=k)
    c_e[5] = np.inf  # a blocked pair
    f, g = rng.normal(size=n), rng.normal(size=m)
    f[2] = -np.inf  # a dead atom
    a, b = rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(m))
    return dict(t_e=t_e, c_e=c_e, rows=rows, cols=cols, n=n, m=m, a=a, b=b, f=f, g=g,
                value=np.float64(0.3), k_e=t_e * 1.1, p_e=rng.uniform(0.2, 1.0, size=k), ess=np.float64(50.0))


@pytest.mark.parametrize("lam", [math.inf, 0.5])
@pytest.mark.parametrize("sampled", [True, False])
def test_sparse_certificate_matches_reference(sampled, lam):
    """Unsorted columns (the function sorts them itself); without ``p_e``
    the CI is NaN and the bound carries no sampling term."""
    inputs = _coo_inputs()
    if not sampled:
        inputs = {k: v for k, v in inputs.items() if k not in ("p_e", "ess", "k_e")}
    kw = dict(eps=0.1, lam=lam)
    ints = ("n", "m")
    cj = jobs.sparse_certificate(**{k: v if k in ints else jnp.asarray(v) for k, v in inputs.items()}, **kw)
    ct = obs.sparse_certificate(**{k: v if k in ints else _t(v) for k, v in inputs.items()}, **kw)
    _same_certificate(ct, cj, 1e-12)
    assert math.isnan(float(ct.ci_low)) != sampled


def test_sparse_certificate_of_an_empty_support():
    empty = np.zeros(0)
    inputs = dict(t_e=empty, c_e=empty, rows=empty.astype(np.int64), cols=empty.astype(np.int64), n=3, m=2,
                  a=np.full(3, 1 / 3), b=np.full(2, 0.5), f=np.zeros(3), g=np.zeros(2), value=np.float64(0.0),
                  p_e=empty)
    ints = ("n", "m")
    cj = jobs.sparse_certificate(**{k: v if k in ints else jnp.asarray(v) for k, v in inputs.items()},
                                 eps=0.1, lam=math.inf)
    ct = obs.sparse_certificate(**{k: v if k in ints else _t(v) for k, v in inputs.items()}, eps=0.1, lam=math.inf)
    assert float(ct.cost_scale) == 0.0
    _same_certificate(ct, cj, 1e-12)


@pytest.mark.parametrize("lam", [math.inf, 0.5])
def test_dense_certificate_matches_reference(lam):
    rng = np.random.default_rng(2)
    n, m = 20, 15
    C = rng.uniform(size=(n, m))
    C[0, :4] = np.inf  # blocked pairs
    f, g = rng.normal(size=n) * 0.1, rng.normal(size=m) * 0.1
    f[3], g[1] = -np.inf, -np.inf  # dead atoms
    plan = np.where(np.isinf(C), 0.0, np.exp((np.where(np.isinf(f), -np.inf, f)[:, None] + g[None, :] - C) / 0.1))
    args = dict(plan=plan, cost=C, a=rng.dirichlet(np.ones(n)), b=rng.dirichlet(np.ones(m)), f=f, g=g,
                value=np.float64(0.2))
    cj = jobs.dense_certificate(**{k: jnp.asarray(v) for k, v in args.items()}, eps=0.1, lam=lam)
    ct = obs.dense_certificate(**{k: _t(v) for k, v in args.items()}, eps=0.1, lam=lam)
    _same_certificate(ct, cj, 1e-12)


# --------------------------------------------------------------------------
# Validity on the port's own draws
# --------------------------------------------------------------------------


def test_sparse_bound_holds_against_log_oracle():
    """The reference's validity configuration (gaussian 2-D clouds, raw
    squared-euclidean cost, s = n^2 / 4) at eps = 0.1, n = 128: the bound
    covers the true error of ``spar_sink_log`` on two of the port's draws."""
    n = 128
    rng = np.random.default_rng(7)
    x, y = rng.normal(size=(n, 2)), rng.normal(size=(n, 2))
    C = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    a, b = rng.random(n), rng.random(n)
    problem = OTProblem(Geometry(C, device="cpu"), a / a.sum(), b / b.sum(), 0.1)
    truth = float(solve(problem, method="log", tol=1e-9, max_iter=100_000).value)
    for seed in (3, 11):
        sol = solve(problem, method="spar_sink_log", seed=seed, s=0.25 * n * n, tol=1e-7, max_iter=20_000,
                    certify=True)
        cert = sol.certificate
        true_err = abs(float(sol.value) - truth)
        assert math.isfinite(float(cert.error_bound)) and float(cert.error_bound) >= true_err, (seed, true_err)
        assert float(cert.gap) >= 0.0 and float(cert.ess) > 1.0
