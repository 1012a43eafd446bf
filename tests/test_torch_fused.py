"""Port parity: the streaming Sinkhorn reductions ``online_matvec`` /
``online_lse`` and the O(nd)-memory ``fused_sinkhorn_solve``, held against
the JAX package (Pallas kernels in interpret mode) on the same numpy inputs.

On CPU tensors the port's wrappers run their plain versions. Tolerances:
the reference kernel tests' own, rtol 2e-4 / atol 2e-5 (matvec) and
rtol 2e-4 / atol 5e-4 (LSE), for two float32 computations that sum in
different orders; the fused solves as stated at each test.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.kernels.fused_sinkhorn import online_lse_call as j_online_lse_call
from repro_torch.core.geometry import gibbs_kernel, squared_euclidean_cost, wfr_cost
from repro_torch.core.sinkhorn import CHECK_EVERY, sinkhorn, sinkhorn_uot
from repro_torch.kernels import library, ops, ref
from repro_torch.kernels import fused_sinkhorn_solve, online_lse, online_matvec

SHAPES = [(64, 64, 2), (256, 128, 5), (300, 257, 3), (512, 512, 50), (100, 700, 8)]
COSTS = ["sqeuclidean", "wfr"]
MATVEC_TOL = dict(rtol=2e-4, atol=2e-5)
LSE_TOL = dict(rtol=2e-4, atol=5e-4)
NEG_INF = -1e30


def _inputs(n, m, d, seed, weights="uniform"):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    y = rng.uniform(size=(m, d)).astype(np.float32)
    w = rng.uniform(size=m) if weights == "uniform" else 0.1 * rng.standard_normal(m)
    return x, y, w.astype(np.float32)


def _both(fn_t, fn_j, *arrays, **kw):
    out_t = fn_t(*(torch.as_tensor(a) for a in arrays), **kw)
    out_j = fn_j(*(jnp.asarray(a) for a in arrays), interpret=True, **kw)
    return out_t, np.asarray(out_j)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cost", COSTS)
def test_online_matvec_matches_reference(shape, cost):
    x, y, v = _inputs(*shape, seed=sum(shape))
    out_t, out_j = _both(online_matvec, jk.online_matvec, x, y, v, eps=0.1, cost=cost, eta=0.3)
    assert out_t.dtype == torch.float32 and out_t.shape == (shape[0],)
    np.testing.assert_allclose(out_t.numpy(), out_j, **MATVEC_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cost", COSTS)
def test_online_lse_matches_reference(shape, cost):
    x, y, g = _inputs(*shape, seed=7 * sum(shape), weights="normal")
    out_t, out_j = _both(online_lse, jk.online_lse, x, y, g, eps=0.05, cost=cost, eta=0.3)
    assert out_t.dtype == torch.float32 and out_t.shape == (shape[0],)
    np.testing.assert_allclose(out_t.numpy(), out_j, **LSE_TOL)


def test_online_lse_fully_blocked_row_and_neg_inf_g_match_raw_kernel():
    """The raw Pallas call's own case (`test_online_lse_call_wfr_fully_
    blocked_row_stays_neg_inf`): a point out of WFR range of every target
    gives the -1e30 sentinel, not NaN; so do -inf entries of g (dead atoms),
    which carry no mass. Raw-call shapes: n = 256, m = 512, d = 128."""
    rng = np.random.default_rng(1)
    n, m, d = 256, 512, 128
    y = rng.uniform(0.0, 0.05, size=(m, d)).astype(np.float32)
    x = rng.uniform(0.0, 0.05, size=(n, d)).astype(np.float32)
    x[0] = 0.0
    x[0, 0] = 100.0  # row 0 far from every target
    g = np.zeros(m, np.float32)
    g[::3] = -np.inf
    out_t = online_lse(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(g),
                       eps=0.1, cost="wfr", eta=0.3).numpy()
    out_j = np.asarray(j_online_lse_call(jnp.asarray(x), jnp.asarray(y), jnp.asarray(g)[:, None],
                                         eps=0.1, cost="wfr", eta=0.3, interpret=True))[:, 0]
    for out in (out_t, out_j):
        assert not np.isnan(out).any()
        assert out[0] <= NEG_INF / 2
        assert np.all(np.isfinite(out[1:])) and np.all(out[1:] > NEG_INF / 2)
    np.testing.assert_allclose(out_t[1:], out_j[1:], **LSE_TOL)
    # the -inf entries weigh nothing: dropping those columns changes nothing
    keep = np.isfinite(g)
    out_kept = online_lse(torch.as_tensor(x), torch.as_tensor(y[keep]), torch.as_tensor(g[keep]),
                          eps=0.1, cost="wfr", eta=0.3).numpy()
    np.testing.assert_allclose(out_t[1:], out_kept[1:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", [online_matvec, online_lse])
def test_wrappers_cast_float64_to_float32(fn):
    """As the JAX wrappers do: float64 points and weights are cast to float32
    first, so the result is bitwise that of the float32 inputs, and within
    the reference dtype test's rtol 2e-4 / atol 1e-5 of the JAX wrapper."""
    x, y, w = _inputs(130, 90, 4, seed=0)
    x64, y64, w64 = (torch.as_tensor(a.astype(np.float64)) for a in (x, y, w))
    out64 = fn(x64, y64, w64, eps=0.2)
    out32 = fn(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(w), eps=0.2)
    assert out64.dtype == torch.float32
    torch.testing.assert_close(out64, out32, rtol=0, atol=0)
    j_fn = getattr(jk, fn.__name__)
    out_j = j_fn(*(jnp.asarray(a, jnp.float64) for a in (x, y, w)), eps=0.2, interpret=True)
    np.testing.assert_allclose(out64.numpy(), np.asarray(out_j), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("cost", COSTS)
def test_plain_versions_in_row_blocks_equal_unblocked(cost):
    """The plain versions build K a block of rows at a time (so that they
    run at n = m = 2^17 on the card); the blocks change the summation order
    of nothing but the matrix products, so 7-row blocks agree with one block
    to float32 rounding (rtol 1e-6)."""
    x, y, w = _inputs(100, 80, 3, seed=3)
    x, y, w = torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(w)
    for fn in (ref.online_matvec_ref, ref.online_lse_ref):
        whole = fn(x, y, w, eps=0.1, cost=cost, eta=0.3, block_rows=100)
        blocks = fn(x, y, w, eps=0.1, cost=cost, eta=0.3, block_rows=7)
        torch.testing.assert_close(blocks, whole, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(fn(x, y, w, eps=0.1, cost=cost, eta=0.3), whole, rtol=1e-6, atol=1e-7)
    # no columns: no mass (0 for the matvec, the sentinel for the LSE)
    empty = torch.zeros((0, 3))
    assert torch.equal(ref.online_matvec_ref(x, empty, torch.zeros(0), eps=0.1), torch.zeros(100))
    assert torch.equal(ref.online_lse_ref(x, empty, torch.zeros(0), eps=0.1), torch.full((100,), NEG_INF))


def test_wrapper_errors():
    x, y, w = (torch.as_tensor(a) for a in _inputs(20, 10, 3, seed=4))
    for fn in (online_matvec, online_lse):
        with pytest.raises(ValueError, match="unknown cost"):
            fn(x, y, w, eps=0.1, cost="l1")
        with pytest.raises(ValueError, match=r"\(n, d\)"):
            fn(x, y[:, :2], w, eps=0.1)
        with pytest.raises(ValueError, match=r"must be \(m,\)"):
            fn(x, y, w[:5], eps=0.1)
        with pytest.raises(TypeError, match="floating point"):
            fn(x.to(torch.int64), y, w, eps=0.1)
        with pytest.raises(TypeError, match="floating point"):
            fn(x, y, w.to(torch.int64), eps=0.1)
        with pytest.raises(ValueError, match="one device"):
            fn(x, y, w.to("meta"), eps=0.1)
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fn(x.to("meta"), y.to("meta"), w.to("meta"), eps=0.1)
    assert all(count == 0 for count in ops.LAUNCHES.values())  # CPU: no kernel launched


def _fused_case(kind):
    """The two cases of tests/test_kernels.py: OT sqeuclidean n = 200 and
    UOT WFR n = 150 (masses 5/3, lam 0.5, eta 0.4), float32 throughout."""
    if kind == "ot":
        rng = np.random.default_rng(0)
        n = 200
        x = rng.uniform(size=(n, 4)).astype(np.float32)
        a = rng.dirichlet(np.ones(n)).astype(np.float32)
        b = rng.dirichlet(np.ones(n)).astype(np.float32)
        return x, a, b, dict(eps=0.1), None
    rng = np.random.default_rng(2)
    n = 150
    x = rng.uniform(size=(n, 2)).astype(np.float32)
    a = (5 * rng.dirichlet(np.ones(n))).astype(np.float32)
    b = (3 * rng.dirichlet(np.ones(n))).astype(np.float32)
    eps, lam = 0.1, 0.5
    return x, a, b, dict(eps=eps, fe=lam / (lam + eps), cost="wfr", eta=0.4), lam


@pytest.mark.parametrize("kind", ["ot", "uot"])
def test_fused_solve_matches_reference(kind):
    """Same status as the JAX solve; n_iter within 5: the two float32
    mat-vecs sum in different orders, and tol = 1e-7 lies at the float32
    noise floor of err = |du|_1 + |dv|_1 for these 150-200 atoms, where the
    two error sequences (equal to a few per cent down to 1e-6) jitter
    around 1e-7 for a few iterations (53 against 57 for UOT). u and v
    agree to rtol 1e-3 (float32 fixed points, some 1e3 times machine
    epsilon); against the port's own dense `sinkhorn`/`sinkhorn_uot` on the
    float32 Gibbs kernel, the reference test's rtol 5e-3."""
    x, a, b, opts, lam = _fused_case(kind)
    kw = dict(tol=1e-7, max_iter=5000, **opts)
    res_t = fused_sinkhorn_solve(*(torch.as_tensor(t) for t in (x, x, a, b)), **kw)
    res_j = jk.fused_sinkhorn_solve(*(jnp.asarray(t) for t in (x, x, a, b)), interpret=True, **kw)
    assert int(res_t.status) == int(res_j.status)
    assert abs(int(res_t.n_iter) - int(res_j.n_iter)) <= 5, (int(res_t.n_iter), int(res_j.n_iter))
    assert res_t.u.dtype == torch.float32
    np.testing.assert_allclose(res_t.u.numpy(), np.asarray(res_j.u), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(res_t.v.numpy(), np.asarray(res_j.v), rtol=1e-3, atol=1e-6)
    xt = torch.as_tensor(x)
    if lam is None:
        K = gibbs_kernel(squared_euclidean_cost(xt), opts["eps"])
        res_d = sinkhorn(K, torch.as_tensor(a), torch.as_tensor(b), tol=1e-7, max_iter=5000)
    else:
        K = gibbs_kernel(wfr_cost(xt, eta=opts["eta"]), opts["eps"])
        res_d = sinkhorn_uot(K, torch.as_tensor(a), torch.as_tensor(b), lam, opts["eps"],
                             tol=1e-7, max_iter=5000)
    torch.testing.assert_close(res_t.u, res_d.u, rtol=5e-3, atol=1e-6)
    torch.testing.assert_close(res_t.v, res_d.v, rtol=5e-3, atol=1e-5)


def test_fused_solve_runs_two_matvecs_per_executed_iteration(monkeypatch):
    """`chip_smoke.py` counts the kernel launches of a fused solve as
    2 * min(max_iter, CHECK_EVERY * ceil(n_iter / CHECK_EVERY)): the loop
    reads its `active` flag every CHECK_EVERY iterations, and frozen
    iterations still run their two mat-vecs. Counted here on the plain
    version, which the CPU runs in the kernel's place."""
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return ref.online_matvec_ref(*args, **kw)

    monkeypatch.setattr(ops, "online_matvec_ref", counted)
    x, a, b, opts, _ = _fused_case("ot")
    args = [torch.as_tensor(t, dtype=torch.float64) for t in (x, x, a, b)]
    for max_iter in (5000, 40, 0):
        calls.clear()
        res = fused_sinkhorn_solve(*args, tol=1e-7, max_iter=max_iter, **opts)
        n_iter = int(res.n_iter)
        assert res.u.dtype == torch.float64  # the loop runs in the histograms' dtype
        assert len(calls) == 2 * min(max_iter, CHECK_EVERY * math.ceil(n_iter / CHECK_EVERY))


def test_exports_follow_the_reference():
    import repro_torch.kernels as tk

    assert set(tk.__all__) <= set(jk.__all__)
    assert set(tk.__all__) == {"batched_block_ell_matvec", "block_ell_matvec", "fused_sinkhorn_solve",
                               "gathered_kernel", "online_lse", "online_matvec"}


def test_library_signatures_match_the_cuda_sources():
    """No nvcc here: hold the ctypes declarations against the C launch
    functions that the sources export (name and number of arguments)."""
    declared = {}
    for src in sorted(library.CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(r"\bint (\w+)_launch\(([^)]*)\)", text):
            declared[name] = len(params.split(","))
        assert "--use_fast_math" not in text
    assert declared == {name: len(args) for name, args in library.SIGNATURES.items()}
    assert set(library.LAUNCHES) == set(library.SIGNATURES)
    assert "cuda_error_string" in (library.CSRC / "errors.cu").read_text()
    assert "--use_fast_math" not in library.NVCC_FLAGS
