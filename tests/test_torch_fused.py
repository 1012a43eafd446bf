"""Port parity: the streaming Sinkhorn reductions ``online_matvec`` /
``online_lse`` and the O(nd)-memory ``fused_sinkhorn_solve``, held against
the JAX package (Pallas kernels in interpret mode) on the same numpy inputs.

On CPU tensors the port's wrappers run their plain versions; the CUDA
kernels' arithmetic is emulated in float32 and held against those plain
versions (the end of the file). Tolerances:
the reference kernel tests' own, rtol 2e-4 / atol 2e-5 (matvec) and
rtol 2e-4 / atol 5e-4 (LSE), for two float32 computations that sum in
different orders; the fused solves as stated at each test.
"""
import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers, and
# torch's default of one thread a core would put 48 threads on 8 cores
torch.set_num_threads(1)

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
NEG_INF32 = float(np.float32(NEG_INF))


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


def _ctype(param: str):
    """The ctypes type that passes one C parameter: a pointer as c_void_p
    (never cut to 32 bits), int64_t, int, float and double as themselves."""
    if "*" in param:
        return ctypes.c_void_p
    return {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "float": ctypes.c_float,
            "double": ctypes.c_double}[param.split()[0]]


def test_library_signatures_match_the_cuda_sources():
    """No nvcc here: hold the ctypes declarations against the C launch
    functions that the sources export: name, number and type of every
    argument (the block-ELL pair with the f64 switch and K~^T u's column
    lists, and K~ v's valid counts; the chunked LRU forward and backward
    with their chunk and scratch), and the chunk rule the LRU launchers ask
    the library for."""
    declared = {}
    for src in sorted(library.CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(r"\bint (\w+)_launch\(([^)]*)\)", text):
            declared[name] = tuple(_ctype(param) for param in params.split(","))
        assert "--use_fast_math" not in text
    assert declared == {name: tuple(args) for name, args in library.SIGNATURES.items()}
    assert {"block_ell_matvec", "block_ell_rmatvec", "lru_scan_fwd"} <= set(declared)
    assert set(library.LAUNCHES) == set(library.SIGNATURES)
    assert "int64_t lru_scan_chunk(int64_t batch, int64_t seq, int64_t width)" in (
        library.CSRC / "lru_scan.cu").read_text()
    assert "cuda_error_string" in (library.CSRC / "errors.cu").read_text()
    assert "--use_fast_math" not in library.NVCC_FLAGS


# --- the CUDA kernels' arithmetic, emulated in float32 torch -----------------
# The kernels cannot run here, so their arithmetic is written out below and
# held against the plain versions: the pre-scaled base-2 exponent with its
# clamp, ex2.approx.ftz (exp2 with results below 2^-126 flushed to 0), the
# LSE's running max over chunks of 8 columns, and the combination of P column
# slices' partials in slice order. The emulation uses 32-column tiles so that
# the test shapes split into several slices, among them an empty one.

LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
F32_NEG_INF = torch.tensor(NEG_INF, dtype=torch.float32)
EMU_TILE, EMU_CHUNK = 32, 8
EPS_GRID = [0.1, 0.01, 1e-3]


def _ex2(t):
    e = torch.exp2(t)
    return torch.where(e < 2.0 ** -126, 0.0, e)


def _kernel_exponents(x, y, eps, cost, eta, form="differences", base=None):
    """Every pair's base_j + t with t = -C/eps log2(e) <= 0 as the kernels
    form it (base: g'_j for the LSE, 0 for the matvec), and the WFR blocked
    mask (None for sqeuclidean). ``form="expansion"`` is the alternative the
    kernels do not take: -s|x|^2 - s|y|^2 + 2s<x, y>, clamped at 0."""
    s = _scale(eps)
    base = torch.zeros(y.shape[0]) if base is None else base
    if cost == "sqeuclidean" and form == "differences":
        r = torch.sqrt(s)
        xs, ys = r * x, r * y
        t = base[None, :].expand(x.shape[0], -1)
        for k in range(x.shape[1]):
            diff = xs[:, k:k + 1] - ys[None, :, k]
            t = t - diff * diff
        return t, None
    xx, yy = torch.sum(x * x, dim=1), torch.sum(y * y, dim=1)
    if cost == "sqeuclidean":
        t = (-s * xx)[:, None] + (-s * yy)[None, :] + x @ ((2.0 * s) * y).T
        return torch.clamp_max(t, 0.0) + base[None, :], None
    sq = torch.clamp_min(xx[:, None] + yy[None, :] - 2.0 * (x @ y.T), 0.0)
    c, blocked = ref._cost_from_sq(sq, cost, eta)
    return c * -s + base[None, :], blocked


def _scale(eps):
    return torch.tensor(LOG2E / np.float32(eps))  # s = kLog2e / eps, in float32


def _slices(m, p):
    """Column ranges of p slices of whole EMU_TILE tiles, as the launcher cuts them."""
    width = -(-(-(-m // EMU_TILE)) // p) * EMU_TILE
    return [range(min(q * width, m), min((q + 1) * width, m)) for q in range(p)]


def _emulated_matvec(x, y, v, *, eps, cost="sqeuclidean", eta=1.0, slices=1, form="differences"):
    t, blocked = _kernel_exponents(x, y, eps, cost, eta, form)
    e = _ex2(t)
    if blocked is not None:
        e = torch.where(blocked, 0.0, e)
    out = torch.zeros(x.shape[0])
    for cols in _slices(y.shape[0], slices):
        part = torch.zeros(x.shape[0])
        for j0 in range(cols.start, cols.stop, EMU_TILE):  # tile sums, added in order
            j1 = min(j0 + EMU_TILE, cols.stop)
            part = part + e[:, j0:j1] @ v[j0:j1]
        out = out + part
    return out


def _lse_result(mx, total):
    return torch.where(mx > F32_NEG_INF, LN2 * (mx + torch.log2(total)), F32_NEG_INF)


def _emulated_lse(x, y, g, *, eps, cost="sqeuclidean", eta=1.0, slices=1):
    gs = torch.clamp_min(_scale(eps) * g, F32_NEG_INF)  # g'_j, the chains' start
    z, blocked = _kernel_exponents(x, y, eps, cost, eta, base=gs)
    if blocked is not None:
        z = torch.where(blocked, F32_NEG_INF, z)
    parts = []
    for cols in _slices(y.shape[0], slices):
        zs = z[:, cols.start:cols.stop]
        pad = -zs.shape[1] % EMU_CHUNK  # the ragged end's neutral columns
        zs = torch.cat([zs, F32_NEG_INF.expand(zs.shape[0], pad)], dim=1)
        mx, total = F32_NEG_INF.expand(x.shape[0]), torch.zeros(x.shape[0])
        for c0 in range(0, zs.shape[1], EMU_CHUNK):
            # the lazy max: the chunk against the max as it stands, unless its
            # sum passes 2^64; then the max rises to the chunk's
            chunk = zs[:, c0:c0 + EMU_CHUNK]
            add = _ex2(chunk - mx[:, None]).sum(dim=1)
            nm = torch.maximum(mx, chunk.amax(dim=1))
            exact = total * _ex2(mx - nm) + _ex2(chunk - nm[:, None]).sum(dim=1)
            lazy = add <= 2.0 ** 64
            total = torch.where(lazy, total + add, exact)
            mx = torch.where(lazy, mx, nm)
        parts.append((mx, total))
    if len(parts) == 1:
        return _lse_result(*parts[0])
    mx = F32_NEG_INF.expand(x.shape[0])
    for pm, _ in parts:
        mx = torch.maximum(mx, pm)
    total = torch.zeros(x.shape[0])
    for pm, ps in parts:
        total = total + ps * _ex2(pm - mx)
    return _lse_result(mx, total)


@pytest.mark.parametrize("eps", EPS_GRID)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cost", COSTS)
def test_kernel_arithmetic_matvec_matches_plain_version(cost, shape, eps):
    """The matvec kernel's arithmetic (one slice, and three over the
    columns) against `online_matvec_ref`, at its tolerance."""
    x, y, v = (torch.as_tensor(a) for a in _inputs(*shape, seed=sum(shape)))
    want = ref.online_matvec_ref(x, y, v, eps=eps, cost=cost, eta=0.3)
    for slices in (1, 3):
        got = _emulated_matvec(x, y, v, eps=eps, cost=cost, eta=0.3, slices=slices)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **MATVEC_TOL)


@pytest.mark.parametrize("eps", EPS_GRID)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cost", COSTS)
def test_kernel_arithmetic_lse_matches_plain_version(cost, shape, eps):
    """The LSE kernel's arithmetic in log2 units (one slice, and three)
    against `online_lse_ref`, at its tolerance."""
    x, y, g = (torch.as_tensor(a) for a in _inputs(*shape, seed=7 * sum(shape), weights="normal"))
    want = ref.online_lse_ref(x, y, g, eps=eps, cost=cost, eta=0.3)
    for slices in (1, 3):
        got = _emulated_lse(x, y, g, eps=eps, cost=cost, eta=0.3, slices=slices)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LSE_TOL)


def _blocked_case():
    """WFR at eta = 0.2 (blocked beyond 0.2 pi): 96 targets, the first 32
    (slice 0 of three) far from every source, and source 0 far from every
    target (a fully blocked row)."""
    rng = np.random.default_rng(5)
    y = rng.uniform(0.0, 0.1, size=(96, 3)).astype(np.float32)
    y[:32, 0] += 5.0
    x = rng.uniform(0.0, 0.1, size=(40, 3)).astype(np.float32)
    x[0, 1] += 10.0
    return x, y


def test_kernel_slice_combine_with_blocked_slice_and_blocked_row():
    """Slice 0 has only blocked pairs (its partials are 0, and max -1e30
    with a sum of 32), row 0 only blocked pairs: the combined results match
    the plain versions, and row 0 is exactly 0 and -1e30."""
    x, y = (torch.as_tensor(a) for a in _blocked_case())
    rng = np.random.default_rng(6)
    v = torch.as_tensor(rng.uniform(size=96).astype(np.float32))
    g = torch.as_tensor((0.1 * rng.standard_normal(96)).astype(np.float32))
    for eps in EPS_GRID:
        kw = dict(eps=eps, cost="wfr", eta=0.2)
        got_mv = _emulated_matvec(x, y, v, slices=3, **kw)
        got_lse = _emulated_lse(x, y, g, slices=3, **kw)
        assert float(got_mv[0]) == 0.0 and float(got_lse[0]) == NEG_INF32
        np.testing.assert_allclose(got_mv.numpy(), ref.online_matvec_ref(x, y, v, **kw).numpy(),
                                   **MATVEC_TOL)
        np.testing.assert_allclose(got_lse.numpy(), ref.online_lse_ref(x, y, g, **kw).numpy(), **LSE_TOL)
        # slice 0 alone: the plain versions see no mass there either
        alone = _emulated_lse(x, y[:32], g[:32], **kw)
        assert torch.equal(alone, F32_NEG_INF.expand(40))
        assert torch.equal(_emulated_matvec(x, y[:32], v[:32], **kw), torch.zeros(40))


@pytest.mark.parametrize("cost", COSTS)
def test_kernel_lse_arithmetic_with_all_neg_inf_g_gives_the_sentinel(cost):
    """g = -inf everywhere (every atom dead): every row at exactly -1e30, as
    the plain version gives, with one slice and with three."""
    x, y, _ = (torch.as_tensor(a) for a in _inputs(50, 100, 4, seed=8))
    g = torch.full((100,), -torch.inf)
    want = ref.online_lse_ref(x, y, g, eps=0.1, cost=cost, eta=0.3)
    assert torch.equal(want, F32_NEG_INF.expand(50))
    for slices in (1, 3):
        assert torch.equal(_emulated_lse(x, y, g, eps=0.1, cost=cost, eta=0.3, slices=slices), want)


def test_kernel_constants_follow_the_source():
    """The rows a thread and the slice limit that the Python side states are
    the CUDA source's; --use_fast_math stays out, and the approximate
    exponential is chosen at its call site."""
    from repro_torch.kernels import fused_sinkhorn

    text = (library.CSRC / "fused_sinkhorn.cu").read_text()
    assert f"constexpr int kRows = {fused_sinkhorn.ROWS_PER_THREAD};" in text
    assert f"constexpr int kMaxSlices = {fused_sinkhorn.MAX_SLICES};" in text
    assert "ex2.approx.ftz.f32" in text
    assert "expf(" not in text


def test_kernel_exponent_by_differences_is_accurate_at_small_eps():
    """Why the kernels form t from differences, not from the expansion
    -s|x|^2 - s|y|^2 + 2s<x, y> (3 instructions a pair fewer at d = 5): the
    expansion rounds relative to s(|x|^2 + |y|^2), not to |t|. At eps = 1e-3
    on the (300, 257, 3) test shape its matvec is some 0.9 of MATVEC_TOL
    from the exact (float64) value, and beyond MATVEC_TOL from the float32
    plain version; the differences stay within 5 % of MATVEC_TOL of the
    exact value at every eps of the grid."""
    x, y, v = (torch.as_tensor(a) for a in _inputs(300, 257, 3, seed=560))
    xd, yd, vd = x.double(), y.double(), v.double()
    share = {}
    for eps in EPS_GRID:
        exact = torch.exp(-torch.cdist(xd, yd) ** 2 / eps) @ vd
        tol = MATVEC_TOL["atol"] + MATVEC_TOL["rtol"] * exact.abs()
        for form in ("differences", "expansion"):
            got = _emulated_matvec(x, y, v, eps=eps, slices=3, form=form).double()
            share[form, eps] = float(((got - exact).abs() / tol).max())
    print({f"{form} eps={eps}": round(val, 4) for (form, eps), val in share.items()})
    assert all(share["differences", eps] < 0.05 for eps in EPS_GRID)
    assert share["expansion", 1e-3] > 10 * share["differences", 1e-3]
    plain = ref.online_matvec_ref(x, y, v, eps=1e-3)
    expansion = _emulated_matvec(x, y, v, eps=1e-3, slices=3, form="expansion")
    assert not torch.allclose(expansion, plain, **MATVEC_TOL)
