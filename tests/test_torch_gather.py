"""Port parity for kernel B1's slice: the gathered kernel's float64
cost-only mode (`ops.gathered_cost`, plain version `ref.gathered_cost_ref`),
the sketch's unchecked entries, the packed point layout, and the geometry
and sketch paths that call them, held against the JAX package on the same
numpy inputs.

The CUDA kernels cannot run here: on CPU tensors every wrapper runs its
plain version. What the wrappers do around a launch on the card (the
points' type, the range flag, the pack's scratch) is driven here with a
stand-in launch that writes the plain results.

Tolerances: float64 costs at rtol 1e-12 (rounding level: the two packages
sum over d in their own orders); the float32 kernel's plain version at the
reference kernel tests' own rtol 2e-3 / atol 1e-6 (K) and rtol 2e-4 /
atol 1e-5 (C); everything the CPU path computed before this slice, bitwise.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers, and
# torch's default of one thread a core would put 48 threads on 8 cores
torch.set_num_threads(1)

from repro.core import geometry as jgeo
from repro.core.api import PointCloudGeometry as JPointCloudGeometry
from repro_torch.core import geometry as tgeo
from repro_torch.core import sparsify
from repro_torch.core.api import OTProblem, PointCloudGeometry, UOTProblem, build_mf_log_sketch, build_mf_sketch
from repro_torch.core.api import solvers
from repro_torch.core.spar_sink import default_cap, s0
from repro_torch.kernels import gather_kernel, library, ops
from repro_torch.kernels.ref import gathered_cost_ref, gathered_kernel_ref, packed_rows_ref

RTOL = 1e-12
K_TOL = dict(rtol=2e-3, atol=1e-6)
C_TOL = dict(rtol=2e-4, atol=1e-5)
COSTS = ["sqeuclidean", "wfr"]


def _case(cost, seed=0, n=300, m=200, d=5, k=4000):
    """Points, index pairs and eta: uniform points for sqeuclidean; for WFR
    two clusters further apart than the range pi * eta, so that about half
    the pairs are blocked."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(size=(n, d)), rng.uniform(size=(m, d))
    eta = 1.0
    if cost == "wfr":
        eta = 0.2
        x, y = 0.2 * x, 0.2 * y
        x[n // 2:, 0] += 1.8
        y[m // 2:, 0] += 1.8
    rows = np.sort(rng.integers(0, n, k))
    cols = rng.integers(0, m, k)
    return x, y, rows, cols, eta


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("cost", COSTS)
def test_cost_only_plain_version_matches_reference_gathered_cost(cost):
    x, y, rows, cols, eta = _case(cost)
    c_t = gathered_cost_ref(*_t(x, y, rows, cols), cost=cost, eta=eta)
    c_j = np.asarray(jgeo.gathered_cost(jnp.asarray(x), jnp.asarray(y), jnp.asarray(rows), jnp.asarray(cols),
                                        cost=cost, eta=eta))
    assert c_t.dtype == torch.float64
    blocked = np.isinf(c_j)
    if cost == "wfr":
        assert 0.1 < blocked.mean() < 0.9  # the blocked branch is taken
    np.testing.assert_array_equal(np.isposinf(c_t.numpy()), blocked)
    np.testing.assert_allclose(c_t.numpy()[~blocked], c_j[~blocked], rtol=RTOL, atol=0)


@pytest.mark.parametrize("cost", COSTS)
def test_cost_only_wrapper_on_cpu_matches_reference_cost_entries(cost):
    x, y, rows, cols, eta = _case(cost, seed=1)
    c_t = ops.gathered_cost(*_t(x, y, rows, cols), cost=cost, eta=eta)
    jgeom = JPointCloudGeometry(jnp.asarray(x), jnp.asarray(y), cost=cost, eta=eta)
    c_j = np.asarray(jgeom.cost_entries(jnp.asarray(rows), jnp.asarray(cols)))
    blocked = np.isinf(c_j)
    np.testing.assert_array_equal(np.isposinf(c_t.numpy()), blocked)
    np.testing.assert_allclose(c_t.numpy()[~blocked], c_j[~blocked], rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cost_only_plain_version_is_float64_of_the_points_as_given(dtype):
    x, y, rows, cols, _ = _case("sqeuclidean", seed=2)
    xt, yt = torch.as_tensor(x, dtype=dtype), torch.as_tensor(y, dtype=dtype)
    c = gathered_cost_ref(xt, yt, *_t(rows, cols))
    want = tgeo.gathered_cost(xt.double(), yt.double(), *_t(rows, cols))
    assert c.dtype == torch.float64
    torch.testing.assert_close(c, want, rtol=0, atol=0)


@pytest.mark.parametrize("cost", COSTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cost_entries_on_cpu_unchanged(cost, dtype):
    """On CPU tensors `cost_entries` is the torch gather in the points' dtype,
    bitwise, as before the cost-only kernel existed."""
    x, y, rows, cols, eta = _case(cost, seed=3)
    xt, yt = torch.as_tensor(x, dtype=dtype), torch.as_tensor(y, dtype=dtype)
    geom = PointCloudGeometry(xt, yt, cost=cost, eta=eta)
    got = geom.cost_entries(*_t(rows, cols))
    want = tgeo.gathered_cost(xt, yt, *_t(rows, cols), cost=cost, eta=eta)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("cost", COSTS)
def test_entries_torch_impl_uses_the_plain_gather(cost, monkeypatch):
    x, y, rows, cols, eta = _case(cost, seed=4)
    geom = PointCloudGeometry(*_t(x, y), cost=cost, eta=eta)

    def no_kernel(*args, **kwargs):
        raise AssertionError("impl='torch' reached a kernel wrapper")

    for name in ("gathered_kernel", "gathered_cost", "gathered_sketch_kernel", "gathered_sketch_cost"):
        monkeypatch.setattr(ops, name, no_kernel)
    k_e, c_e = geom.entries(*_t(rows, cols), 0.1, impl="torch")
    c_want = tgeo.gathered_cost(*_t(x, y, rows, cols), cost=cost, eta=eta)
    torch.testing.assert_close(c_e, c_want, rtol=0, atol=0)
    torch.testing.assert_close(k_e, tgeo.gibbs_kernel(c_want, 0.1), rtol=0, atol=0)
    assert c_e.dtype == torch.float64


def test_cost_only_wrapper_checks():
    x, y, rows, cols, _ = _case("sqeuclidean", seed=5)
    xt, yt, rt, ct = _t(x, y, rows, cols)
    with pytest.raises(ValueError, match="unknown cost"):
        ops.gathered_cost(xt, yt, rt, ct, cost="euclidean")
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        ops.gathered_cost(xt, yt[:, :2], rt, ct)
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        ops.gathered_cost(xt[0], yt, rt, ct)
    with pytest.raises(ValueError, match="equal-length"):
        ops.gathered_cost(xt, yt, rt, ct[:5])
    with pytest.raises(ValueError, match="equal-length"):
        ops.gathered_cost(xt, yt, rt[:, None], ct[:, None])
    with pytest.raises(TypeError, match="int64"):
        ops.gathered_cost(xt, yt, rt.to(torch.int32), ct)
    with pytest.raises(TypeError, match="floating point"):
        ops.gathered_cost(xt.to(torch.int64), yt, rt, ct)
    meta = torch.empty(x.shape, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="one device"):
        ops.gathered_cost(meta, yt, rt, ct)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.gathered_cost(meta, torch.empty(y.shape, dtype=torch.float64, device="meta"),
                          torch.empty(rt.shape, dtype=torch.int64, device="meta"),
                          torch.empty(ct.shape, dtype=torch.int64, device="meta"))


def test_gathered_kernel_wrapper_checks_index_dtype():
    x, y, rows, cols, _ = _case("sqeuclidean", seed=6)
    xt, yt, rt, ct = _t(x, y, rows, cols)
    with pytest.raises(TypeError, match="int64"):
        ops.gathered_kernel(xt, yt, rt, ct.to(torch.int32), eps=0.1)


@pytest.mark.parametrize("cost", COSTS)
def test_sketch_entries_run_the_plain_versions_on_cpu(cost):
    x, y, rows, cols, eta = _case(cost, seed=7)
    args = _t(x, y, rows, cols)
    before = dict(ops.LAUNCHES)
    k_s, c_s = ops.gathered_sketch_kernel(*args, eps=0.1, cost=cost, eta=eta)
    c64_s = ops.gathered_sketch_cost(*args, cost=cost, eta=eta)
    assert ops.LAUNCHES == before  # CPU tensors: no launch
    k_r, c_r = gathered_kernel_ref(*args, eps=0.1, cost=cost, eta=eta)
    torch.testing.assert_close(k_s, k_r, rtol=0, atol=0)
    torch.testing.assert_close(c_s, c_r, rtol=0, atol=0)
    torch.testing.assert_close(c64_s, gathered_cost_ref(*args, cost=cost, eta=eta), rtol=0, atol=0)


def _old_log_sketch(problem, gen, s):
    """The log-domain sketch as it was built before the cost-only kernel:
    the same draw, with the torch gather in the points' dtype."""
    geom = problem.geom
    ra, rb, thin = solvers._proposal(problem)
    return sparsify.sparsify_coo_mf_log(
        gen, ra, rb, s, default_cap(s),
        lambda r, c: tgeo.gathered_cost(geom.x, geom.y, r, c, cost=geom.cost_name, eta=geom.eta),
        float(problem.eps), thin_scale=thin)


def _problem(kind, cost, n=256, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 3))
    a, b = rng.uniform(0.5, 1.5, n), rng.uniform(0.5, 1.5, n)
    eta = 1.0 if cost == "sqeuclidean" else 0.3
    geom = PointCloudGeometry(torch.as_tensor(x), cost=cost, eta=eta)
    if kind == "ot":
        return OTProblem(geom, torch.as_tensor(a / a.sum()), torch.as_tensor(b / b.sum()), 0.1)
    return UOTProblem(geom, torch.as_tensor(a), torch.as_tensor(1.3 * b), 0.1, lam=0.5)


def _assert_same_sketch(got, want):
    (sk, c_e), (sk0, c_e0) = got, want
    for field in ("rows", "cols", "nnz", "csort", "n_proposed", "n_accepted", "overflowed"):
        assert torch.equal(getattr(sk, field), getattr(sk0, field)), field
    vals = "logvals" if hasattr(sk, "logvals") else "vals"
    torch.testing.assert_close(getattr(sk, vals), getattr(sk0, vals), rtol=0, atol=0)
    torch.testing.assert_close(c_e, c_e0, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["ot", "uot"])
@pytest.mark.parametrize("cost", COSTS)
def test_log_sketch_on_cpu_bitwise_as_before(kind, cost):
    problem = _problem(kind, cost)
    s = 8 * s0(256)
    got = build_mf_log_sketch(problem, torch.Generator().manual_seed(3), s)
    want = _old_log_sketch(problem, torch.Generator().manual_seed(3), s)
    _assert_same_sketch(got, want)


@pytest.mark.parametrize("kind", ["ot", "uot"])
def test_scaling_sketch_on_cpu_bitwise_as_before(kind):
    """`build_mf_sketch` on CPU tensors: the torch entries, bitwise as the
    draw with `entries(impl="torch")`."""
    problem = _problem(kind, "sqeuclidean")
    s = 8 * s0(256)
    got = build_mf_sketch(problem, torch.Generator().manual_seed(4), s)
    ra, rb, thin = solvers._proposal(problem)
    want = sparsify.sparsify_coo_mf(
        torch.Generator().manual_seed(4), ra, rb, s, default_cap(s),
        lambda r, c: problem.geom.entries(r, c, 0.1, impl="torch"), thin_scale=thin)
    _assert_same_sketch(got, want)


def test_sketch_impl_cuda_on_cpu_points_raises():
    problem = _problem("ot", "sqeuclidean")
    with pytest.raises(ValueError, match="CUDA device"):
        build_mf_sketch(problem, torch.Generator().manual_seed(0), 8 * s0(256), impl="cuda")


def test_packed_stride_matches_the_cuda_source():
    text = (library.CSRC / "gather_kernel.cu").read_text()
    expr = re.search(r"inline int packed_stride\(int d\) \{ return ([^;]+); \}", text).group(1)
    assert "int gathered_packed_stride(int d) { return packed_stride(d); }" in text
    for d in range(1, 70):
        stride = eval(expr, {"d": d})  # the C expression is valid Python
        assert stride == gather_kernel.packed_stride(d)
        assert stride % 4 == 0 and d + 1 <= stride <= d + 4


@pytest.mark.parametrize("d", [1, 3, 4, 5, 7, 8, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packed_rows_plain_layout(d, dtype):
    x = torch.as_tensor(np.random.default_rng(d).uniform(size=(50, d)))
    packed = packed_rows_ref(x, dtype)
    stride = gather_kernel.packed_stride(d)
    assert packed.shape == (50, stride) and packed.dtype == dtype
    torch.testing.assert_close(packed[:, :d], x.to(dtype), rtol=0, atol=0)
    torch.testing.assert_close(packed[:, d], torch.sum(x.to(dtype) ** 2, dim=1),
                               rtol=d * torch.finfo(dtype).eps, atol=0)
    assert bool((packed[:, d + 1:] == 0).all())


@pytest.mark.parametrize("cost", COSTS)
@pytest.mark.parametrize("d", [3, 5, 13])
def test_values_from_the_packed_layout_match_the_plain_version(cost, d):
    """The float32 kernels' arithmetic on the packed rows (the dot product
    summed in order over the coordinates, the norms read from column d)
    gives `gathered_kernel_ref`'s values at the reference's tolerances."""
    x, y, rows, cols, eta = _case(cost, seed=9, d=d)
    xt, yt, rt, ct = _t(x, y, rows, cols)
    px, py = packed_rows_ref(xt, torch.float32)[rt], packed_rows_ref(yt, torch.float32)[ct]
    xy = torch.zeros(rt.shape[0], dtype=torch.float32)
    for t in range(d):
        xy = xy + px[:, t] * py[:, t]
    sq = torch.clamp_min(px[:, d] + py[:, d] - 2.0 * xy, 0.0)
    if cost == "sqeuclidean":
        c, blocked = sq, torch.zeros_like(sq, dtype=torch.bool)
    else:
        c, blocked = tgeo.wfr_from_dist(torch.sqrt(sq + 1e-30), eta, cos_floor=1e-30)
    k = torch.where(blocked, 0.0, torch.exp(-c / 0.1))
    c = torch.where(blocked, math.inf, c)
    k_r, c_r = gathered_kernel_ref(xt, yt, rt, ct, eps=0.1, cost=cost, eta=eta)
    assert torch.equal(torch.isinf(c), torch.isinf(c_r))
    ok = ~torch.isinf(c_r)
    torch.testing.assert_close(k[ok], k_r[ok], **K_TOL)
    torch.testing.assert_close(c[ok], c_r[ok], **C_TOL)


# --- the wrappers' CUDA branch around a stand-in launch ----------------------


def _stand_in(calls, out_of_range=False):
    """A launch that records what it is given and writes the plain results
    (float32 K and C, or float64 C) into its outputs; with ``out_of_range``
    it sets the flag as the kernel would."""

    def launch(x, y, rows, cols, *outs_and_flag, **kw):
        *outs, flag = outs_and_flag
        calls.append(dict(x=x, y=y, outs=outs, flag=flag, kw=kw))
        if len(outs) == 2:
            k_r, c_r = gathered_kernel_ref(x, y, rows, cols, **kw)
            outs[0].copy_(k_r)
            outs[1].copy_(c_r)
        else:
            outs[0].copy_(gathered_cost_ref(x, y, rows, cols, **kw))
        if out_of_range and flag is not None:
            flag.fill_(1)

    return launch


@pytest.mark.parametrize("x_dtype,y_dtype,packed_dtype", [
    (torch.float32, torch.float32, torch.float32),
    (torch.float64, torch.float32, torch.float64),
    (torch.float64, torch.float64, torch.float64),
    (torch.bfloat16, torch.float32, torch.float64),
])
def test_wrapper_hands_the_pack_one_point_type(x_dtype, y_dtype, packed_dtype):
    x, y, rows, cols, _ = _case("sqeuclidean", seed=10)
    xt, yt = torch.as_tensor(x).to(x_dtype), torch.as_tensor(y).to(y_dtype)
    calls = []
    k_e, c_e = ops._gathered(_stand_in(calls), xt, yt, *_t(rows, cols), (torch.float32, torch.float32), True,
                             eps=0.1, cost="sqeuclidean", eta=1.0)
    (call,) = calls
    assert call["x"].dtype == call["y"].dtype == packed_dtype
    assert call["x"].is_contiguous() and call["y"].is_contiguous()
    assert call["flag"].dtype == torch.int32 and call["flag"].shape == (1,)
    # the cast to one type is exact, so the values are the points' own
    k_r, c_r = gathered_kernel_ref(xt, yt, *_t(rows, cols), eps=0.1)
    torch.testing.assert_close(k_e, k_r, rtol=0, atol=0)
    torch.testing.assert_close(c_e, c_r, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_keeps_y_as_x_and_sizes_the_scratch(dtype):
    x, _, rows, cols, _ = _case("sqeuclidean", seed=11, m=300)
    xt = torch.as_tensor(x).to(dtype)
    calls = []
    ops._gathered(_stand_in(calls), xt, xt, *_t(rows, cols), (torch.float64,), False,
                  cost="sqeuclidean", eta=1.0)
    assert calls[0]["y"] is calls[0]["x"] and calls[0]["flag"] is None
    stride = gather_kernel.packed_stride(5)
    assert gather_kernel._packed(xt, xt, torch.float32).numel() == 300 * stride  # y is x: packed once
    assert gather_kernel._packed(xt, xt.clone(), torch.float64).numel() == 600 * stride
    assert gather_kernel._packed(xt, xt[:200], torch.float32).numel() == 500 * stride


def test_wrapper_raises_on_the_flag_only_when_checked():
    x, y, rows, cols, _ = _case("sqeuclidean", seed=12)
    args = _t(x, y, rows, cols)
    with pytest.raises(IndexError, match="out of range"):
        ops._gathered(_stand_in([], out_of_range=True), *args, (torch.float64,), True, cost="sqeuclidean", eta=1.0)
    calls = []
    ops._gathered(_stand_in(calls, out_of_range=True), *args, (torch.float64,), False, cost="sqeuclidean", eta=1.0)
    assert calls[0]["flag"] is None  # the sketch's entry: no flag, no read


def test_wrapper_launches_nothing_for_no_pairs():
    x, y, _, _, _ = _case("sqeuclidean", seed=13)
    calls = []
    empty = torch.zeros(0, dtype=torch.int64)
    k_e, c_e = ops._gathered(_stand_in(calls), *_t(x, y), empty, empty, (torch.float32, torch.float32), True,
                             eps=0.1, cost="sqeuclidean", eta=1.0)
    assert calls == [] and k_e.shape == c_e.shape == (0,)
