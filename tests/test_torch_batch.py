"""The batched engine (`repro_torch.batch`) against the reference and itself.

* Against ``repro.batch`` (the same numpy inputs through both packages):
  `BatchedProblem` padding, buckets and grouping exactly; batched ``dense``
  and ``log`` against the reference's `BucketedExecutor` at rtol 1e-10
  with its ``n_iter`` and ``status``; the three sketch methods on the
  reference's own `BatchedSketch` arrays (its ``build_batched_*``) at rtol
  1e-10, with its ``n_iter`` and ``status``; the executor's metric names.
* Within the port: the sketch methods' batched solves bitwise their
  per-problem ``solve(seed=)`` (u, v, iterations, status, value, nnz and
  plan entries; traces and certificates too); ``dense``/``log`` at 1e-13
  of the largest entry (their batched products and logsumexps reduce over
  the padded bucket, the per-problem ones over the true support); the flat
  segment reductions bitwise per element; the cache (``compile_count``,
  LRU eviction); the error paths of the reference's executor test; the
  per-problem log-domain sketch solvers on `sparse_log_potentials` at B = 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers
torch.set_num_threads(1)

from repro.batch import BatchedProblem as JBatchedProblem
from repro.batch import BucketedExecutor as JBucketedExecutor
from repro.batch import build_batched_log_sketch as j_build_log
from repro.batch import build_batched_mf_log_sketch as j_build_mf_log
from repro.batch import build_batched_mf_sketch as j_build_mf
from repro.batch import build_batched_sketch as j_build_coo
from repro.batch import bucket_shape as j_bucket_shape
from repro.batch import get_batched_solver as j_get_batched_solver
from repro.batch import group_by_bucket as j_group_by_bucket
from repro.core import Geometry as JGeometry
from repro.core import OTProblem as JOTProblem
from repro.core import PointCloudGeometry as JPointCloudGeometry
from repro.core import UOTProblem as JUOTProblem
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro_torch import Geometry, OTProblem, PointCloudGeometry, SparsePlan, UOTProblem, s0, solve
from repro_torch import batch as tb
from repro_torch.batch import (
    BatchedProblem,
    BatchedSketch,
    BucketedExecutor,
    batchable_methods,
    batched_coo_sketch,
    build_batched_mf_sketch,
    bucket_shape,
    get_batched_solver,
    group_by_bucket,
)
from repro_torch.core import sparsify
from repro_torch.kernels import ops
from repro_torch.obs.metrics import MetricsRegistry

EPS = 0.1
SIZES = (40, 64, 100, 128)  # -> buckets (64, 64) and (128, 128), as the reference's test
RTOL = 1e-10  # against the reference
DENSE_RTOL = 1e-13  # batched dense/log against per-problem, of the largest entry
TRACE_RTOL = 1e-13  # batched traces (sums over the padded bucket) against per-problem ones
REFERENCE_NAMES = [
    "BatchedProblem", "BatchedResult", "BatchedSketch", "BucketedExecutor", "batchable_methods",
    "batched_coo_sketch", "batched_log_loop", "batched_scaling_loop", "batched_sparse_log_loop", "bucket_shape",
    "build_batched_log_sketch", "build_batched_mf_log_sketch", "build_batched_mf_sketch", "build_batched_sketch",
    "get_batched_solver", "group_by_bucket", "register_batched_solver", "sparse_log_potentials",
]


def _data(B, sizes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(B):
        n = int(sizes[i % len(sizes)])
        out.append((rng.uniform(size=(n, 3)), rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n)), bool(i % 2)))
    return out


def _port(data, point_cloud=False, lams=None):
    """The port's problems; ``lams`` gives each UOT element its own lam."""
    out = []
    for i, (x, a, b, uot) in enumerate(data):
        g = PointCloudGeometry(x, device="cpu") if point_cloud else Geometry.from_points(x, normalize=True, device="cpu")
        lam = 0.5 if lams is None else lams[i]
        out.append(UOTProblem(g, a * 5.0, b * 3.0, EPS, lam=lam) if uot else OTProblem(g, a, b, EPS))
    return out


#: one lam a UOT element, one of them EPS (exponent 0.5, the special path of
#: ``x ** 0.5``), the others each an exponent of its own
DISTINCT_LAMS = [None, EPS, None, 0.3, None, 0.7, None, 2.0]


def _ref(data, point_cloud=False):
    out = []
    for x, a, b, uot in data:
        xj = jnp.asarray(x)
        g = JPointCloudGeometry(xj) if point_cloud else JGeometry.from_points(xj, normalize=True)
        aj, bj = jnp.asarray(a), jnp.asarray(b)
        out.append(JUOTProblem(g, aj * 5.0, bj * 3.0, EPS, lam=0.5) if uot else JOTProblem(g, aj, bj, EPS))
    return out


@pytest.fixture(scope="module")
def mixed():
    data = _data(8, SIZES, 0)
    return data, _port(data), _ref(data)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(x, y, rtol=RTOL, what=""):
    x, y = _np(x), _np(y)
    assert x.shape == y.shape, what
    fin = np.isfinite(y)
    assert np.array_equal(fin, np.isfinite(x)), what
    np.testing.assert_allclose(x[fin], y[fin], rtol=rtol, atol=rtol * max(1.0, float(np.abs(y[fin]).max(initial=0))),
                               err_msg=what)


# --------------------------------------------------------------------------
# Problems and buckets, exactly as the reference
# --------------------------------------------------------------------------


def test_batch_exports_the_reference_names():
    assert sorted(tb.__all__) == sorted(REFERENCE_NAMES)
    assert all(hasattr(tb, name) for name in REFERENCE_NAMES)
    assert batchable_methods() == ["dense", "log", "spar_sink_coo", "spar_sink_log", "spar_sink_mf"]


@pytest.mark.parametrize("shape", [(40, 40), (64, 100), (129, 5), (1, 1), (64, 64), (300, 70)])
def test_bucket_shape_matches_reference(shape):
    assert bucket_shape(*shape) == j_bucket_shape(*shape)
    assert bucket_shape(*shape, min_size=16) == j_bucket_shape(*shape, min_size=16)


def test_grouping_and_padding_match_reference(mixed):
    _, tp, jp = mixed
    assert group_by_bucket(tp) == j_group_by_bucket(jp)
    for bucket in (None, (128, 128), (256, 128)):
        bp, jbp = BatchedProblem.from_problems(tp, bucket=bucket), JBatchedProblem.from_problems(jp, bucket=bucket)
        assert bp.shape == jbp.shape
        for field in ("cost", "a", "b", "eps", "lam", "n_sizes", "m_sizes"):
            np.testing.assert_array_equal(_np(getattr(bp, field)), _np(getattr(jbp, field)), err_msg=field)
        for view in ("is_balanced", "fe"):
            np.testing.assert_array_equal(_np(getattr(bp, view)), _np(getattr(jbp, view)), err_msg=view)
        for view in ("row_mask", "col_mask", "log_kernel"):
            np.testing.assert_array_equal(_np(getattr(bp, view)()), _np(getattr(jbp, view)()), err_msg=view)
        # exp(-C/eps): torch's exp and XLA's differ in the last bit
        _close(bp.kernel(), jbp.kernel(), 1e-15, "kernel")
    bp = BatchedProblem.from_problems(tp, materialize_cost=False)
    assert bp.cost is None and repr(bp) == "BatchedProblem(B=8, bucket=128x128)"
    with pytest.raises(ValueError, match="bucket too small"):
        BatchedProblem.from_problems(tp, bucket=(64, 64))
    with pytest.raises(ValueError, match="empty batch"):
        BatchedProblem.from_problems([])


# --------------------------------------------------------------------------
# Batched solves against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["dense", "log"])
def test_executor_dense_log_match_reference(mixed, method):
    _, tp, jp = mixed
    sols = BucketedExecutor(metrics=MetricsRegistry()).solve_batch(tp, method=method, tol=1e-9, max_iter=5000)
    jsols = JBucketedExecutor(metrics=JMetricsRegistry()).solve_batch(jp, method=method, tol=1e-9, max_iter=5000)
    for sol, jsol in zip(sols, jsols):
        assert int(sol.n_iter) == int(jsol.result.n_iter)
        assert int(sol.status) == int(jsol.result.status)
        _close(sol.result.u, jsol.result.u, what="u")
        _close(sol.result.v, jsol.result.v, what="v")
        _close(sol.value, jsol.value, what="value")
        _close(sol.plan(), jsol.plan(), what="plan")


_SKETCH_CASES = {
    "spar_sink_coo": (j_build_coo, False, {}),
    "spar_sink_log": (j_build_log, False, {}),
    "spar_sink_mf": (j_build_mf, True, {}),
    "spar_sink_mf-log": (j_build_mf_log, True, {"stabilize": True}),
}


def _sketch_from_reference(jsk):
    def t(x, dtype=None):
        return None if x is None else torch.as_tensor(np.array(x), dtype=dtype)

    return BatchedSketch(
        rows=t(jsk.rows, torch.int64), cols=t(jsk.cols, torch.int64), vals=t(jsk.vals), nnz=t(jsk.nnz, torch.int64),
        csort=t(jsk.csort, torch.int64), overflowed=t(jsk.overflowed), cost_e=t(jsk.cost_e),
    )


@pytest.mark.parametrize("case", list(_SKETCH_CASES))
@pytest.mark.parametrize("certify", [False, True], ids=["plain", "certified"])
def test_sketch_solvers_on_reference_sketch(case, certify):
    """The reference's batched sketch (one bucket, padded and unpadded
    elements, OT and UOT) through both packages' batched solvers."""
    build, point_cloud, extra = _SKETCH_CASES[case]
    method = case.split("-")[0]
    data = _data(4, (40, 64), 3)
    tp, jp = _port(data, point_cloud), _ref(data, point_cloud)
    s = 8 * s0(64)
    jsk = build(jp, [jax.random.PRNGKey(20 + i) for i in range(4)], s)
    jbp = JBatchedProblem.from_problems(jp, bucket=(64, 64), materialize_cost=not point_cloud)
    bp = BatchedProblem.from_problems(tp, bucket=(64, 64), materialize_cost=not point_cloud)
    opts = dict(tol=1e-9, max_iter=3000, certify=certify, **extra)
    jres = j_get_batched_solver(method)(jbp, jsk, **opts)
    res = get_batched_solver(method)(bp, _sketch_from_reference(jsk), **opts)
    np.testing.assert_array_equal(_np(res.n_iter), _np(jres.n_iter))
    np.testing.assert_array_equal(_np(res.status), _np(jres.status))
    for field in ("u", "v", "value"):
        _close(getattr(res, field), getattr(jres, field), what=field)
    if certify:
        for field in res.certificate._fields:
            _close(getattr(res.certificate, field), getattr(jres.certificate, field), rtol=1e-9, what=field)


def test_executor_metric_names_match_reference(mixed):
    _, tp, jp = mixed
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    for _ in range(2):
        BucketedExecutor(metrics=reg).solve_batch(tp, method="dense", max_iter=300)
        JBucketedExecutor(metrics=jreg).solve_batch(jp, method="dense", max_iter=300)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    # the port drops the reference's executor.retrace, which counts exactly
    # the calls that executor.cache_miss counts
    assert jsnap["counters"].pop("executor.retrace") == jsnap["counters"]["executor.cache_miss"]
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(snap[kind]) == sorted(jsnap[kind]), kind
    assert snap["counters"] == jsnap["counters"]
    assert snap["gauges"] == jsnap["gauges"]
    for name in ("executor.bucket_occupancy", "executor.padding_waste"):
        assert snap["histograms"][name] == jsnap["histograms"][name]
    assert snap["histograms"]["executor.dispatch_seconds"]["count"] == 4


# --------------------------------------------------------------------------
# Batched against per-problem, within the port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method,opts,lams", [
    ("spar_sink_coo", {}, None), ("spar_sink_log", {}, None), ("spar_sink_mf", {}, None),
    ("spar_sink_mf", {"stabilize": True}, None), ("spar_sink_coo", {}, DISTINCT_LAMS),
    ("spar_sink_mf", {}, DISTINCT_LAMS),
], ids=["coo", "log", "mf", "mf-log", "coo-lams", "mf-lams"])
def test_sketch_batch_bitwise_per_problem(method, opts, lams):
    """Same seeds => bitwise u, v, iterations, status, value, nnz, plan
    entries, traces and certificates against per-problem ``solve``; with
    ``lams``, the UOT elements of one batch each raise the scaling update
    to an exponent of their own."""
    data = _data(8, SIZES, 1)
    tp = _port(data, point_cloud=method == "spar_sink_mf", lams=lams)
    s = 8 * s0(128)
    kw = dict(s=s, tol=1e-9, max_iter=3000, trace=True, certify=True, **opts)
    sols = BucketedExecutor(metrics=MetricsRegistry()).solve_batch(tp, method=method, seeds=range(100, 108), **kw)
    for i, (p, sol) in enumerate(zip(tp, sols)):
        ref = solve(p, method=method, seed=100 + i, **kw)
        for x, y in ((sol.result.u, ref.result.u), (sol.result.v, ref.result.v), (sol.value, ref.value),
                     (sol.n_iter, ref.n_iter), (sol.status, ref.status), (sol.nnz, ref.nnz),
                     (sol.overflowed, ref.overflowed)):
            assert torch.equal(x, y), p.shape
        assert sol.domain == ref.domain and sol.method == method and sol.problem is p
        plan, rplan = sol.plan(), ref.plan()
        assert isinstance(plan, SparsePlan) and (plan.n, plan.m) == p.shape
        for field in ("rows", "cols", "vals", "nnz"):
            assert torch.equal(getattr(plan, field), getattr(rplan, field)), field
        # the trace's error and marginal violation are sums over the padded
        # bucket here, over the true support there: equal up to rounding
        for x, y in zip(sol.result.trace, ref.result.trace):
            _close(x, y, TRACE_RTOL)
        for field in sol.certificate._fields:
            x, y = getattr(sol.certificate, field), getattr(ref.certificate, field)
            assert torch.equal(x.nan_to_num(), y.nan_to_num()), field


@pytest.mark.parametrize("method", ["dense", "log"])
def test_dense_log_batch_per_problem(method):
    data = _data(8, SIZES, 2)
    tp = _port(data)
    sols = BucketedExecutor(metrics=MetricsRegistry()).solve_batch(tp, method=method, tol=1e-9, max_iter=5000,
                                                                    certify=True)
    for p, sol in zip(tp, sols):
        ref = solve(p, method=method, tol=1e-9, max_iter=5000, certify=True)
        assert (int(sol.n_iter), sol.status_label) == (int(ref.n_iter), ref.status_label)
        _close(sol.result.u, ref.result.u, DENSE_RTOL)
        _close(sol.result.v, ref.result.v, DENSE_RTOL)
        _close(sol.value, ref.value, DENSE_RTOL)
        _close(sol.certificate.gap, ref.certificate.gap, 1e-9)
        assert sol.domain == ref.domain and sol.plan().shape == p.shape


def test_padded_rows_carry_zero_mass(mixed):
    _, tp, _ = mixed
    bp = BatchedProblem.from_problems(tp, bucket=(128, 128))
    rm, cm = bp.row_mask(), bp.col_mask()
    br = get_batched_solver("dense")(bp, None, tol=1e-9, max_iter=5000)
    assert bool(torch.all(torch.where(rm, br.u, 1.0) > 0))
    assert bool(torch.all(torch.where(rm, 0.0, br.u) == 0.0))
    assert bool(torch.all(torch.where(cm, 0.0, br.v) == 0.0))
    T = br.u[:, :, None] * bp.kernel() * br.v[:, None, :]
    assert float(torch.where(rm[:, :, None] & cm[:, None, :], 0.0, T).abs().max()) == 0.0
    br = get_batched_solver("log")(bp, None, tol=1e-9, max_iter=5000)
    assert bool(torch.all(torch.isneginf(torch.where(rm, -torch.inf, br.u))))
    assert bool(torch.all(torch.isneginf(torch.where(cm, -torch.inf, br.v))))


@pytest.mark.parametrize("log_space", [False, True], ids=["sum", "logsumexp"])
def test_flat_segment_reductions_bitwise_per_element(log_space):
    """B disjoint element layouts in one flat reduction give each element's
    own `coo_matvec` / `coo_lse_row` (and transposes) bit for bit."""
    data = _data(4, (40, 64, 100, 128), 4)
    tp = _port(data, point_cloud=True)
    s = 8 * s0(128)
    gens = [torch.Generator().manual_seed(i) for i in range(4)]
    if log_space:
        sk = tb.build_batched_mf_log_sketch(tp, gens, s)
    else:
        sk = build_batched_mf_sketch(tp, gens, s)
    assert sk.cap % tb.solvers.SLOT_ALIGN == 0
    gen = torch.Generator().manual_seed(9)
    v, u = torch.rand((4, 128), dtype=torch.float64, generator=gen), torch.rand((4, 128), dtype=torch.float64,
                                                                                generator=gen)
    cs = sk.cols.gather(1, sk.csort)
    if log_space:
        row = ops.batched_coo_logsumexp(sk.rows, sk.vals + v.gather(1, sk.cols), n=128, indices_are_sorted=True)
        col = ops.batched_coo_logsumexp(cs, (sk.vals + u.gather(1, sk.rows)).gather(1, sk.csort), n=128)
    else:
        row = ops.batched_coo_matvec(sk.rows, sk.vals, v.gather(1, sk.cols), n=128, indices_are_sorted=True)
        col = ops.batched_coo_rmatvec(cs, sk.vals.gather(1, sk.csort), u.gather(1, sk.rows).gather(1, sk.csort), m=128)
    for j, p in enumerate(tp):
        n, m = p.shape
        c = sk.element_cap(j)
        cls = sparsify.LogSparseKernelCOO if log_space else sparsify.SparseKernelCOO
        e = cls(sk.rows[j, :c], sk.cols[j, :c], sk.vals[j, :c], sk.nnz[j], n, m, csort=sk.csort[j, :c])
        if log_space:
            r, cc = sparsify.coo_lse_row(e, v[j, :m]), sparsify.coo_lse_col(e, u[j, :n])
            empty = -torch.inf
        else:
            r, cc = sparsify.coo_matvec(e, v[j, :m]), sparsify.coo_rmatvec(e, u[j, :n])
            empty = 0.0
        assert torch.equal(row[j, :n], r) and torch.equal(col[j, :m], cc)
        assert bool(torch.all(row[j, n:] == empty)) and bool(torch.all(col[j, m:] == empty))


def test_in_bucket_sketch_bitwise_for_exact_fit():
    """`batched_coo_sketch` (drawn at the bucket shape) keeps the
    per-problem draw when the problems fill the bucket."""
    tp = _port(_data(4, (64,), 3))
    s = 8 * s0(64)
    bp = BatchedProblem.from_problems(tp, bucket=(64, 64))
    sk = batched_coo_sketch(bp, [torch.Generator().manual_seed(i) for i in range(4)], s)
    from repro_torch.core.api import build_coo_sketch

    for j, p in enumerate(tp):
        ref = build_coo_sketch(p, torch.Generator().manual_seed(j), s, cap=sk.element_cap(j))
        c = sk.element_cap(j)
        assert torch.equal(sk.rows[j, :c], ref.rows) and torch.equal(sk.cols[j, :c], ref.cols)
        assert int(sk.nnz[j]) == int(ref.nnz)
        np.testing.assert_allclose(sk.vals[j, :c].numpy(), ref.vals.numpy(), rtol=1e-12)


# --------------------------------------------------------------------------
# The cache and the error paths
# --------------------------------------------------------------------------


def test_cache_no_refill_on_same_bucket(mixed):
    _, tp, _ = mixed
    s = 8 * s0(128)
    ex = BucketedExecutor(metrics=MetricsRegistry())
    ex.solve_batch(tp, method="spar_sink_coo", seeds=range(8), s=s, max_iter=300)
    first = ex.compile_count
    assert first == 2  # one entry a bucket: (64, 64) and (128, 128)
    ex.solve_batch(tp, method="spar_sink_coo", seeds=range(8), s=s, max_iter=300)
    ex.solve_batch(tp[::-1], method="spar_sink_coo", seeds=range(8), s=s, max_iter=300)
    assert ex.compile_count == first
    ex.solve_batch(tp, method="dense", max_iter=300)
    assert ex.compile_count == first + 2
    assert ex.metrics.get_counter("executor.cache_hit") == 4
    assert ex.metrics.get_counter("executor.cache_miss") == 4


def test_cache_lru_eviction(mixed):
    _, tp, _ = mixed
    ex = BucketedExecutor(cache_size=1, metrics=MetricsRegistry())
    small = [p for p in tp if p.shape[0] <= 64]
    big = [p for p in tp if p.shape[0] > 64]
    ex.solve_batch(small, method="dense", max_iter=200)
    ex.solve_batch(big, method="dense", max_iter=200)  # evicts the small entry
    ex.solve_batch(small, method="dense", max_iter=200)  # must fill again
    assert ex.compile_count == 3 and len(ex._cache) == 1
    assert ex.metrics.get_gauge("executor.cache_entries") == 1.0


def test_executor_error_paths(mixed):
    _, tp, _ = mixed
    ex = BucketedExecutor(metrics=MetricsRegistry())
    with pytest.raises(KeyError, match="batchable"):
        ex.solve_batch(tp, method="no_such_method")
    with pytest.raises(TypeError, match="generators"):
        ex.solve_batch(tp, method="spar_sink_coo", s=100.0)
    with pytest.raises(TypeError, match="'s'"):
        ex.solve_batch(tp, method="spar_sink_coo", seeds=range(8))
    with pytest.raises(ValueError, match="8 problems"):
        ex.solve_batch(tp, method="spar_sink_coo", seeds=range(3), s=100.0)
    with pytest.raises(TypeError, match="not both"):
        ex.solve_batch(tp, method="spar_sink_coo", seeds=range(8), generators=[None] * 8, s=100.0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        BucketedExecutor(mesh=object())
    with pytest.raises(ValueError, match="gathered costs"):
        get_batched_solver("spar_sink_mf")(BatchedProblem.from_problems(tp[:1]), BatchedSketch(
            *(torch.zeros((1, 16), dtype=torch.int64) for _ in range(3)), torch.zeros(1)))


def test_per_problem_log_sketch_solvers_run_the_batched_loop(monkeypatch):
    """``spar_sink_log`` and ``spar_sink_mf(stabilize=True)`` run
    `sparse_log_potentials` at B = 1 (the batched engine's program)."""
    from repro_torch.batch import solvers as bs

    calls = []
    real = bs.sparse_log_potentials

    def spy(rows, *args, **kw):
        calls.append(rows.shape[0])
        return real(rows, *args, **kw)

    monkeypatch.setattr(bs, "sparse_log_potentials", spy)
    x, a, b, _ = _data(1, (40,), 5)[0]
    for method, geom, opts in (("spar_sink_log", Geometry.from_points(x, device="cpu"), {}),
                               ("spar_sink_mf", PointCloudGeometry(x, device="cpu"), {"stabilize": True})):
        sol = solve(OTProblem(geom, a, b, EPS), method=method, seed=0, s=400.0, **opts)
        assert sol.domain == "log" and np.isfinite(float(sol.value))
    assert calls == [1, 1]
