"""The port's observability layer (``repro_torch.obs``, the ``trace=`` and
``init=`` options of the loops and solvers) against the reference.

* Zero overhead: with ``trace=False`` and ``init=None`` each generic loop
  dispatches the same sequence of aten ops as a frozen copy of the loop as
  it was before telemetry (kept below; change the copies only with a
  deliberate loop change), with bitwise-equal results.
* On/off parity: traced and untraced solves are bitwise equal, for every
  method that takes ``trace=``.
* Trace contents on dense problems (the rings at rtol 1e-10, with an
  absolute floor of 1e-12 x the first record: an error near convergence is
  a difference of O(1) scalings, so its rounding is absolute), the
  matvec count and the ring wrap. The sketch solvers' traces, on the
  reference's own sketches, are in ``tests/test_torch_certify.py``.
* `sketch_diagnostics` on the reference's sketches: integers exact, float64
  fields at rtol 1e-12, the float32 fields at float32 rounding.
* ``init=`` warm starts with non-finite entries, on ``log``,
  ``spar_sink_log`` and ``spar_sink_mf(stabilize=True)`` (the last two on the
  reference's sketch; C-4 puts the sparse log loops' difference at rounding
  level, so rtol 1e-9), and the refusal without ``stabilize``.
* ``summary()`` key sets, and the `MetricsRegistry` counterparts of the
  reference's registry tests, with both registries' exports equal.
"""
import json
import math
import threading
from typing import Callable

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
from repro.core.api import Geometry as JGeometry
from repro.core.api import OTProblem as JOTProblem
from repro.core.api import PointCloudGeometry as JPointCloudGeometry
from repro.core.api import UOTProblem as JUOTProblem
from repro.core.api import solve as jsolve
from repro.core.api import solvers as jsolvers
from repro.core.sparsify import SparseKernelCOO as JSparseKernelCOO
from repro_torch import interop, obs
from repro_torch.core import sparsify
from repro_torch.core.api import Geometry, OTProblem, PointCloudGeometry, UOTProblem, solve
from repro_torch.core.api import solvers as tsolvers
from repro_torch.core.sinkhorn import (
    SinkhornResult,
    _dense_lse,
    _l1,
    _log_domain_status,
    _masked_log,
    _run,
    _safe_div,
    _status_code,
    generic_log_loop,
    generic_scaling_loop,
    generic_sparse_log_loop,
)
from repro_torch.core.spar_sink import s0

EPS = 0.5
LAM = 0.5


def _arrays(n=48, m=40, seed=0):
    """The reference's tests/test_obs.py problem: a random cost, positive
    marginals."""
    rng = np.random.default_rng(seed)
    C = rng.random((n, m))
    a = np.abs(rng.normal(size=n)) + 0.1
    b = np.abs(rng.normal(size=m)) + 0.1
    return C, a / a.sum(), b / b.sum()


def _problems(kind, eps=EPS, seed=0):
    """(reference problem, port problem) on the same dense cost; UOT with
    masses 5 and 3 and lam = 0.5."""
    C, a, b = _arrays(seed=seed)
    if kind == "ot":
        return (JOTProblem(JGeometry(jnp.asarray(C)), jnp.asarray(a), jnp.asarray(b), eps),
                OTProblem(Geometry(C, device="cpu"), a, b, eps))
    return (JUOTProblem(JGeometry(jnp.asarray(C)), jnp.asarray(5 * a), jnp.asarray(3 * b), eps, lam=LAM),
            UOTProblem(Geometry(C, device="cpu"), 5 * a, 3 * b, eps, lam=LAM))


def _clouds(kind, n=48, eps=EPS):
    """(reference problem, port problem) on point clouds (the matrix-free
    path's geometry; below ``dense_guard`` every method runs on it)."""
    rng = np.random.default_rng(4)
    x, y = rng.uniform(size=(n, 3)), rng.uniform(size=(n, 3))
    a, b = rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))
    jgeom = JPointCloudGeometry(jnp.asarray(x), jnp.asarray(y))
    tgeom = PointCloudGeometry(x, y, device="cpu")
    if kind == "ot":
        return JOTProblem(jgeom, jnp.asarray(a), jnp.asarray(b), eps), OTProblem(tgeom, a, b, eps)
    return (JUOTProblem(jgeom, jnp.asarray(5 * a), jnp.asarray(3 * b), eps, lam=LAM),
            UOTProblem(tgeom, 5 * a, 3 * b, eps, lam=LAM))


def _carry(sk, log: bool):
    """The reference's sketch as the port's, on the CPU."""
    arrays = dict(logvals=np.asarray(sk.logvals)) if log else dict(vals=np.asarray(sk.vals))
    return interop.sketch_from_numpy(
        np.asarray(sk.rows), np.asarray(sk.cols), np.asarray(sk.nnz), sk.n, sk.m,
        csort=np.asarray(sk.csort), overflowed=np.asarray(sk.overflowed),
        n_proposed=np.asarray(sk.n_proposed), n_accepted=np.asarray(sk.n_accepted),
        device="cpu", **arrays,
    )


def _same_ring(t, j, rtol=1e-10, scale=None):
    """Two traced records, at ``rtol`` with an absolute floor of 1e-12 x
    ``scale`` (default: the first record, the largest of a chronological
    trace): an error near convergence is a difference of O(1) quantities,
    so its rounding is absolute."""
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape and t.size > 0
    np.testing.assert_allclose(t, j, rtol=rtol, atol=1e-12 * abs(j[0] if scale is None else scale))


# --------------------------------------------------------------------------
# Zero overhead: frozen copies of the loops before telemetry
# --------------------------------------------------------------------------


def _frozen_scaling_loop(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    a: torch.Tensor,
    b: torch.Tensor,
    fe: float = 1.0,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    patience: int = 100,
) -> SinkhornResult:
    dev = a.device
    # finite "huge" sentinel: keeps the first check truthy while letting
    # isfinite(err) tell a diverged (+inf) error apart
    big = torch.tensor(torch.finfo(a.dtype).max, dtype=a.dtype, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state = dict(
        u=torch.ones_like(a), v=torch.ones_like(b), t=zero, err=big, best=big, since=zero
    )

    def cond(s):
        return (
            (s["err"] > tol) & torch.isfinite(s["err"])
            & (s["t"] < max_iter) & (s["since"] < patience)
        )

    def step(s):
        u, v = s["u"], s["v"]
        u_new = _safe_div(a, matvec(v)) ** fe
        KTu = rmatvec(u_new)
        v_new = _safe_div(b, KTu) ** fe
        err = _l1(u_new - u) + _l1(v_new - v)
        # stall metric (free): column-marginal violation before the v-update
        marg = _l1(v * KTu - b)
        improved = marg < s["best"] * (1.0 - 1e-4)
        new = dict(
            u=u_new, v=v_new, t=s["t"] + 1, err=err,
            best=torch.minimum(s["best"], marg),
            since=torch.where(improved, 0, s["since"] + 1).to(torch.int32),
        )
        return new, cond(new)

    s, _ = _run(state, cond(state), step, max_iter)
    u, v, err = s["u"], s["v"], s["err"]
    bad = ~(torch.isfinite(err) & torch.all(torch.isfinite(u)) & torch.all(torch.isfinite(v)))
    degenerate = (torch.max(u) <= 0.0) | (torch.max(v) <= 0.0)
    status = _status_code(bad, degenerate, err, tol, s["since"] >= patience)
    return SinkhornResult(u, v, s["t"], err, status)


def _frozen_log_loop(
    lse_row: Callable[[torch.Tensor], torch.Tensor],
    lse_col: Callable[[torch.Tensor], torch.Tensor],
    loga: torch.Tensor,
    logb: torch.Tensor,
    eps: float,
    fe: float = 1.0,
    *,
    tol: float = 1e-9,
    max_iter: int = 1000,
) -> SinkhornResult:
    dev = loga.device
    neg_inf_a = torch.isneginf(loga)
    neg_inf_b = torch.isneginf(logb)
    state = dict(
        f=torch.zeros_like(loga), g=torch.zeros_like(logb),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        err=torch.tensor(math.inf, dtype=loga.dtype, device=dev),
    )

    def cond(s):
        return (s["err"] > tol) & (s["t"] < max_iter)

    def step(s):
        f_new = fe * eps * (loga - lse_row(s["g"]))
        f_new = torch.where(neg_inf_a, -math.inf, f_new)
        g_new = fe * eps * (logb - lse_col(f_new))
        g_new = torch.where(neg_inf_b, -math.inf, g_new)
        df = torch.where(neg_inf_a, 0.0, torch.abs(f_new - s["f"]))
        dg = torch.where(neg_inf_b, 0.0, torch.abs(g_new - s["g"]))
        new = dict(f=f_new, g=g_new, t=s["t"] + 1, err=torch.max(df) + torch.max(dg))
        return new, cond(new)

    s, _ = _run(state, cond(state), step, max_iter)
    f, g, err = s["f"], s["g"], s["err"]
    return SinkhornResult(f, g, s["t"], err, _log_domain_status(f, g, err, tol))


def _frozen_sparse_log_loop(
    lse_row: Callable[[torch.Tensor], torch.Tensor],
    lse_col: Callable[[torch.Tensor], torch.Tensor],
    loga: torch.Tensor,
    logb: torch.Tensor,
    eps: float,
    fe: float = 1.0,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    patience: int = 100,
) -> SinkhornResult:
    dev = loga.device
    neg_inf_a = torch.isneginf(loga)
    neg_inf_b = torch.isneginf(logb)
    big = torch.tensor(torch.finfo(loga.dtype).max, dtype=loga.dtype, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    # dead atoms start pinned, so their first 0 -> -inf jump is no error
    state = dict(
        f=torch.where(neg_inf_a, -math.inf, torch.zeros_like(loga)),
        g=torch.where(neg_inf_b, -math.inf, torch.zeros_like(logb)),
        t=zero, err=big, best=big, since=zero,
    )
    b_lin = torch.exp(logb)

    def cond(s):
        return (s["err"] > tol) & (s["t"] < max_iter) & (s["since"] < patience)

    def step(s):
        f, g = s["f"], s["g"]
        lr = lse_row(g)
        f_new = fe * eps * (loga - lr)
        f_new = torch.where(neg_inf_a | torch.isneginf(lr), -math.inf, f_new)
        lc = lse_col(f_new)
        g_new = fe * eps * (logb - lc)
        g_new = torch.where(neg_inf_b | torch.isneginf(lc), -math.inf, g_new)
        df = torch.where(torch.isneginf(f_new) & torch.isneginf(f), 0.0, torch.abs(f_new - f))
        dg = torch.where(torch.isneginf(g_new) & torch.isneginf(g), 0.0, torch.abs(g_new - g))
        # stall metric (free): column marginal of the pre-update plan
        col_marg = torch.where(
            torch.isneginf(g) | torch.isneginf(lc), 0.0, torch.exp(g / eps + lc)
        )
        marg = torch.sum(torch.abs(col_marg - b_lin))
        improved = marg < s["best"] * (1.0 - 1e-4)
        new = dict(
            f=f_new, g=g_new, t=s["t"] + 1, err=torch.max(df) + torch.max(dg),
            best=torch.minimum(s["best"], marg),
            since=torch.where(improved, 0, s["since"] + 1).to(torch.int32),
        )
        return new, cond(new)

    s, _ = _run(state, cond(state), step, max_iter)
    f, g, err = s["f"], s["g"], s["err"]
    status = _log_domain_status(f, g, err, tol, s["since"] >= patience)
    return SinkhornResult(f, g, s["t"], err, status)


class _AtenOps(TorchDispatchMode):
    """Records the name of every aten op dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _loop_case(which):
    """``(current loop, frozen loop, args, kwargs)`` on a UOT exponent, with
    a dead atom (zero mass) on each side."""
    C, a, b = _arrays()
    a[3], b[5] = 0.0, 0.0
    a, b = torch.tensor(a), torch.tensor(b)
    C = torch.tensor(C)
    fe, eps = 0.8, EPS
    if which == "scaling":
        K = torch.exp(-C / eps)
        args = (lambda v: K @ v, lambda u: K.T @ u, a, b, fe)
        return generic_scaling_loop, _frozen_scaling_loop, args, dict(tol=1e-9, max_iter=300)
    if which == "log":
        args = (*_dense_lse(-C / eps, eps), _masked_log(a), _masked_log(b), eps, fe)
        return generic_log_loop, _frozen_log_loop, args, dict(tol=1e-9, max_iter=300)
    sk, _ = sparsify.sparsify_coo_log(torch.Generator().manual_seed(0), C, sparsify.ot_sampling_probs(a, b),
                                      eps, 600.0, 900)
    row_off, layout = sparsify.row_offsets(sk), sparsify.col_layout(sk)
    args = (lambda g: sparsify.coo_lse_row(sk, g / eps, row_off), lambda f: sparsify.coo_lse_col(sk, f / eps, layout),
            _masked_log(a), _masked_log(b), eps, fe)
    return generic_sparse_log_loop, _frozen_sparse_log_loop, args, dict(tol=1e-9, max_iter=300)


@pytest.mark.parametrize("which", ["scaling", "log", "sparse_log"])
def test_untraced_loop_dispatches_the_pre_telemetry_ops(which):
    loop, frozen, args, kwargs = _loop_case(which)
    with _AtenOps() as before:
        old = frozen(*args, **kwargs)
    extra = dict(trace=False) if which == "scaling" else dict(trace=False, init=None)
    with _AtenOps() as now:
        new = loop(*args, **kwargs, **extra)
    assert len(before.ops) > 100 and now.ops == before.ops
    assert new.trace is None and int(new.n_iter) == int(old.n_iter) > 10
    for x, y in zip(new[:5], old):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# Trace correctness
# --------------------------------------------------------------------------

#: every method that takes trace=, with the options it needs
TRACED = {
    "dense": {}, "log": {},
    "spar_sink_coo": dict(seed=0, s=600.0), "spar_sink_log": dict(seed=0, s=600.0),
    "spar_sink_mf": dict(seed=0, s=600.0), "spar_sink_dense": dict(seed=0, s=600.0),
    "rand_sink": dict(seed=0, s=600.0), "spar_sink_block_ell": dict(seed=0, s=600.0, block=16),
}


@pytest.mark.parametrize("method", sorted(TRACED))
def test_trace_on_off_bitwise_parity(method):
    _, tp = _clouds("uot")
    off = solve(tp, method=method, **TRACED[method])
    on = solve(tp, method=method, trace=True, **TRACED[method])
    for x, y in zip(off.result[:5], on.result[:5]):
        assert torch.equal(x, y)
    assert float(off.value) == float(on.value)
    assert off.diagnostics is None and off.result.trace is None
    d = on.diagnostics
    assert d is not None and d.n_matvec == 2 * int(on.n_iter) > 0
    assert d.iteration_errors()[-1] == float(on.err)
    assert (d.sketch is not None) == (method in ("spar_sink_coo", "spar_sink_log", "spar_sink_mf", "rand_sink"))


@pytest.mark.parametrize("kind", ["ot", "uot"])
@pytest.mark.parametrize("method", ["dense", "log"])
def test_dense_trace_contents_match_reference(method, kind):
    jp, tp = _problems(kind)
    sol_j = jsolve(jp, method=method, trace=True, tol=1e-9, max_iter=2000)
    sol_t = solve(tp, method=method, trace=True, tol=1e-9, max_iter=2000)
    dj, dt = sol_j.diagnostics, sol_t.diagnostics
    n_iter = int(sol_t.n_iter)
    assert n_iter == int(sol_j.n_iter) and 5 < n_iter < obs.DEFAULT_TRACE_LEN
    assert dt.n_matvec == dj.n_matvec == 2 * n_iter
    assert dt.first_traced_iteration == dj.first_traced_iteration == 0
    _same_ring(dt.iteration_errors(), dj.iteration_errors())
    _same_ring(dt.marginal_errors(), dj.marginal_errors())
    assert dt.iteration_errors()[-1] == float(sol_t.err)
    # untouched slots stay NaN
    assert torch.isnan(dt.trace.err[n_iter:]).all() and torch.isnan(dt.trace.marg[n_iter:]).all()


def test_trace_ring_wraps_to_last_records():
    jp, tp = _problems("ot")
    L = 3
    sol = solve(tp, method="dense", trace=L, tol=1e-12, max_iter=50)
    d = sol.diagnostics
    n_iter = int(sol.n_iter)
    assert n_iter > L and d.trace.trace_len == L
    errs, _, first = obs.trim_trace(d.trace, n_iter)
    assert len(errs) == L and first == n_iter - L == d.first_traced_iteration
    assert errs[-1] == float(sol.err)
    full = solve(tp, method="dense", trace=True, tol=1e-12, max_iter=50).diagnostics
    np.testing.assert_array_equal(errs, obs.trim_trace(full.trace, n_iter)[0][-L:])
    # the reference's ring holds the same records in the same slots
    ring_j = jsolve(jp, method="dense", trace=L, tol=1e-12, max_iter=50).diagnostics.trace
    _same_ring(d.trace.err.numpy(), np.asarray(ring_j.err), scale=full.iteration_errors()[0])
    _same_ring(d.trace.marg.numpy(), np.asarray(ring_j.marg), scale=full.marginal_errors()[0])
    with pytest.raises(ValueError, match="one element's trace"):
        obs.trim_trace(obs.empty_trace(4, torch.float64, batch=2, device="cpu"), 3)


def test_batched_record_iteration_matches_reference():
    """The batched form (for the batched engine): frozen elements keep their
    records and counter."""
    L, B = 4, 3
    tr_j = jobs.empty_trace(L, jnp.float64, batch=B)
    tr_t = obs.empty_trace(L, torch.float64, batch=B, device="cpu")
    rng = np.random.default_rng(1)
    for step in range(6):
        t = np.array([step, step, min(step, 2)], np.int32)
        err, marg = rng.random(B), rng.random(B)
        active = np.array([True, step < 4, step < 2])
        tr_j = jobs.record_iteration(tr_j, jnp.asarray(t), jnp.asarray(err), jnp.asarray(marg),
                                     active=jnp.asarray(active))
        tr_t = obs.record_iteration(tr_t, torch.tensor(t), torch.tensor(err), torch.tensor(marg),
                                    active=torch.tensor(active))
    for x, y in zip(tr_t, tr_j):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# --------------------------------------------------------------------------
# Sketch diagnostics
# --------------------------------------------------------------------------


def _reference_sketch(which):
    """(reference sketch, log?) of each sketch builder, OT and UOT."""
    kind = "uot" if which.endswith("uot") else "ot"
    jp, _ = _clouds(kind, eps=0.1)
    key, s = jax.random.PRNGKey(2), 16 * s0(48)
    if which.startswith("coo_log"):
        return jsolvers.build_coo_log_sketch(jp, key, s)[0], True
    if which.startswith("coo"):
        return jsolvers.build_coo_sketch(jp, key, s), False
    if which.startswith("mf_log"):
        return jsolvers.build_mf_log_sketch(jp, key, s)[0], True
    return jsolvers.build_mf_sketch(jp, key, s)[0], False


@pytest.mark.parametrize("which", ["coo", "coo_log", "mf", "mf_log", "mf_uot", "mf_log_uot", "coo_log_uot"])
def test_sketch_diagnostics_match_reference(which):
    jsk, log = _reference_sketch(which)
    st_j = jobs.sketch_diagnostics(jsk)
    st_t = obs.sketch_diagnostics(_carry(jsk, log))
    assert int(st_t.nnz) == int(st_j.nnz) > 0 and st_t.cap == st_j.cap
    assert bool(st_t.overflowed) == bool(st_j.overflowed)
    for field in ("fill", "acceptance_rate", "dup_merge_rate"):
        t, j = getattr(st_t, field), getattr(st_j, field)
        assert t.dtype == torch.float32 and j.dtype == jnp.float32
        np.testing.assert_allclose(float(t), float(j), rtol=2.0 ** -23)
    for field in ("ess", "ess_ratio"):
        np.testing.assert_allclose(float(getattr(st_t, field)), float(getattr(st_j, field)), rtol=1e-12)
    if which in ("mf_uot", "mf_log_uot"):  # the thinned sampler rejects proposals
        assert float(st_t.acceptance_rate) < 1.0


def test_sketch_diagnostics_direct_values():
    vals = [2.0, 2.0, 2.0, 2.0, 0.0]  # equal weights: ESS = nnz
    rows, cols = [0, 0, 1, 2, 2], [0, 1, 0, 1, 0]
    sk = sparsify.SparseKernelCOO(
        torch.tensor(rows), torch.tensor(cols), torch.tensor(vals, dtype=torch.float64), torch.tensor(4), 3, 2,
        overflowed=torch.tensor(False), n_proposed=torch.tensor(8), n_accepted=torch.tensor(5),
    )
    st = obs.sketch_diagnostics(sk)
    assert int(st.nnz) == 4 and st.cap == 5
    assert float(st.fill) == pytest.approx(4 / 5)
    assert float(st.ess) == pytest.approx(4.0) and float(st.ess_ratio) == pytest.approx(1.0)
    assert float(st.acceptance_rate) == pytest.approx(1.0)  # 5 of min(8, cap=5)
    assert float(st.dup_merge_rate) == pytest.approx(1.0 - 4 / 5)
    st_j = jobs.sketch_diagnostics(JSparseKernelCOO(
        jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32), jnp.asarray(vals), jnp.asarray(4, jnp.int32),
        3, 2, overflowed=jnp.asarray(False), n_proposed=jnp.asarray(8, jnp.int32),
        n_accepted=jnp.asarray(5, jnp.int32)))
    for field in ("fill", "ess", "ess_ratio", "acceptance_rate", "dup_merge_rate"):
        assert float(getattr(st, field)) == float(getattr(st_j, field)), field
    # a hand-built sketch without draw counts reports neither rate
    bare = obs.sketch_diagnostics(sk._replace(n_proposed=None, n_accepted=None))
    assert bare.acceptance_rate is None and bare.dup_merge_rate is None


# --------------------------------------------------------------------------
# init=: warm starts
# --------------------------------------------------------------------------


def _warm(f, g):
    """Potentials of an earlier solve with non-finite entries planted (they
    must fall back to 0, and dead atoms be pinned again)."""
    f, g = np.array(f), np.array(g)
    f[0], f[1], g[2] = -np.inf, np.nan, np.inf
    return f, g


@pytest.mark.parametrize("kind", ["ot", "uot"])
@pytest.mark.parametrize("method", ["log", "spar_sink_log", "spar_sink_mf"])
def test_init_warm_start_matches_reference(method, kind):
    jp, tp = _clouds(kind, eps=0.1)
    key, s = jax.random.PRNGKey(5), 16 * s0(48)
    ropts = dict(key=key, s=s) if method != "log" else {}
    if method == "spar_sink_mf":
        ropts["stabilize"] = True
    cold = jsolve(jp, method=method, tol=1e-3, max_iter=3000, **ropts)
    f0, g0 = _warm(*cold.potentials)
    warm_j = jsolve(jp, method=method, tol=1e-10, max_iter=3000, init=(jnp.asarray(f0), jnp.asarray(g0)), **ropts)
    init = (torch.tensor(f0), torch.tensor(g0))
    if method == "log":
        warm_t = solve(tp, method="log", tol=1e-10, max_iter=3000, init=init)
        rtol = 1e-10
    else:
        if method == "spar_sink_log":
            jsk, jc = jsolvers.build_coo_log_sketch(jp, key, s)
        else:
            jsk, jc = jsolvers.build_mf_log_sketch(jp, key, s)
        warm_t = tsolvers._sparse_log_solution(method, tp, _carry(jsk, True), torch.tensor(np.asarray(jc)),
                                               1e-10, 3000, init=init)
        rtol = 1e-9
    full = jsolve(jp, method=method, tol=1e-10, max_iter=3000, **ropts)
    assert int(warm_t.n_iter) == int(warm_j.n_iter) and int(warm_t.status) == int(warm_j.status)
    assert int(warm_j.n_iter) < int(full.n_iter)  # the warm start saved iterations
    for t, j in zip(warm_t.potentials, warm_j.potentials):
        j = np.asarray(j)
        assert np.array_equal(np.isfinite(t.numpy()), np.isfinite(j))
        np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=0)
    np.testing.assert_allclose(float(warm_t.value), float(warm_j.value), rtol=rtol)


def test_init_requires_stabilize_as_reference():
    jp, tp = _clouds("ot", eps=0.1)
    init = (np.zeros(48), np.zeros(48))
    with pytest.raises(ValueError) as ej:
        jsolve(jp, method="spar_sink_mf", key=jax.random.PRNGKey(0), s=100.0, init=tuple(map(jnp.asarray, init)))
    with pytest.raises(ValueError) as et:
        solve(tp, method="spar_sink_mf", seed=0, s=100.0, init=tuple(map(torch.tensor, init)))
    assert str(et.value) == str(ej.value)


# --------------------------------------------------------------------------
# summary() keys
# --------------------------------------------------------------------------


def _keys(d: dict) -> dict:
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


@pytest.mark.parametrize("method", ["spar_sink_coo", "spar_sink_mf", "dense"])
def test_summary_keys_match_reference(method):
    jp, tp = _clouds("uot", eps=0.1)
    opts = dict(trace=True, certify=True)
    if method != "dense":
        s = 16 * s0(48)
        sol_j = jsolve(jp, method=method, key=jax.random.PRNGKey(0), s=s, **opts)
        sol_t = solve(tp, method=method, seed=0, s=s, **opts)
    else:
        sol_j, sol_t = jsolve(jp, method=method, **opts), solve(tp, method=method, **opts)
    sum_t, sum_j = sol_t.diagnostics.summary(), sol_j.diagnostics.summary()
    assert _keys(sum_t) == _keys(sum_j) and "certificate" in sum_t
    leaves = [v for d in (sum_t, sum_t["sketch"] if "sketch" in sum_t else {}, sum_t["certificate"])
              for v in d.values() if not isinstance(v, dict)]
    assert all(type(v) in (int, float, bool) for v in leaves)  # JSON-friendly host values
    json.dumps(sum_t)
    assert set(sol_t.certificate.summary()) == set(sol_j.certificate.summary())


# --------------------------------------------------------------------------
# MetricsRegistry: the reference's registry tests, against both registries
# --------------------------------------------------------------------------


def _both(fill):
    """``fill`` applied to a reference and a port registry; returns the
    port's, after checking that both export the same text."""
    reg_j, reg_t = jobs.MetricsRegistry(), obs.MetricsRegistry()
    fill(reg_j)
    fill(reg_t)
    for fmt in ("json", "prometheus"):
        assert obs.export(fmt, reg_t) == jobs.export(fmt, reg_j)
    return reg_t


def test_registry_counter_gauge_histogram():
    def fill(reg):
        reg.counter("c")
        reg.counter("c", 2.5)
        reg.gauge("g", 7.0)
        for v in range(1, 101):
            reg.observe("h", float(v))

    reg = _both(fill)
    assert reg.get_counter("c") == 3.5 and reg.get_gauge("g") == 7.0
    h = reg.get_histogram("h")
    assert h["count"] == 100 and h["sum"] == pytest.approx(5050.0) and h["mean"] == pytest.approx(50.5)
    assert h["p50"] == pytest.approx(50.5) and h["p95"] == pytest.approx(95.05) and h["p99"] == pytest.approx(99.01)
    assert reg.get_counter("nope") == 0.0 and reg.get_histogram("nope")["count"] == 0


def test_registry_histogram_window_bounded():
    n = obs.HISTOGRAM_WINDOW + 500
    reg = _both(lambda r: [r.observe("h", float(v)) for v in range(n)])
    h = reg.get_histogram("h")
    assert h["count"] == n and h["sum"] == pytest.approx(n * (n - 1) / 2)
    assert h["p50"] >= 500.0  # from the last HISTOGRAM_WINDOW samples only


def test_registry_reset_prefix_and_locked():
    def fill(reg):
        reg.counter("serve.requests", 5)
        reg.counter("executor.cache_hit", 2)
        reg.observe("serve.latency_seconds", 0.1)
        with reg.locked():
            reg.reset("serve.")
            assert reg.get_counter("serve.requests") == 0.0

    reg = _both(fill)
    assert reg.get_counter("executor.cache_hit") == 2.0
    assert reg.get_histogram("serve.latency_seconds")["count"] == 0


def test_registry_thread_safety():
    reg = obs.MetricsRegistry()

    def work(i):
        for j in range(1000):
            reg.counter("c")
            reg.observe("h", 0.001 if (i + j) % 2 else 0.3)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert reg.get_counter("c") == 8000.0 and reg.get_histogram("h")["count"] == 8000
    buckets = dict(reg.snapshot(include_buckets=True)["histograms"]["h"]["buckets"])
    assert buckets[0.001] == 4000 and buckets[0.5] == 8000
    cum = [c for _, c in sorted(buckets.items())]
    assert cum == sorted(cum)


def test_export_json_and_prometheus():
    def fill(reg):
        reg.counter("executor.cache_hit", 3)
        reg.gauge("serve.queue_depth", 2)
        reg.observe("serve.latency_seconds", 0.25)

    reg = _both(fill)
    by_name = {r["metric"]: r for r in json.loads(obs.export("json", reg))}
    assert by_name["executor.cache_hit"] == {"metric": "executor.cache_hit", "type": "counter", "value": 3.0}
    assert by_name["serve.latency_seconds"]["p99"] == pytest.approx(0.25)
    assert "buckets" not in by_name["serve.latency_seconds"]
    text = obs.export("prometheus", reg)
    for line in ("# TYPE executor_cache_hit counter", "# TYPE serve_latency_seconds histogram",
                 'serve_latency_seconds_bucket{le="0.25"} 1', 'serve_latency_seconds_bucket{le="0.1"} 0',
                 'serve_latency_seconds_bucket{le="+Inf"} 1', 'serve_latency_seconds_quantile{quantile="0.99"} 0.25',
                 "serve_latency_seconds_count 1"):
        assert line in text
    with pytest.raises(ValueError):
        obs.export("xml", reg)
    assert obs.default_registry is not jobs.default_registry
