"""Port parity: costs, Gibbs kernels, geometries and the gathered kernel's
plain version, held against the JAX package on the same numpy inputs.

Tolerances: float64 costs and kernels at rtol 1e-12 (rounding level); the
gathered kernel's float32 outputs at the reference kernel tests' own
rtol 2e-3 / atol 1e-6 (K) and rtol 2e-4 / atol 1e-5 (C).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers, and
# torch's default of one thread a core would put 48 threads on 8 cores
torch.set_num_threads(1)

from repro.core import geometry as jgeo
from repro.core.api import Geometry as JGeometry
from repro.core.api import PointCloudGeometry as JPointCloudGeometry
from repro.kernels.ops import gathered_kernel as j_gathered_kernel
from repro.kernels.ref import gathered_kernel_ref as j_gathered_kernel_ref
from repro_torch.core import geometry as tgeo
from repro_torch.core.api import Geometry, PointCloudGeometry
from repro_torch.kernels.ops import gathered_kernel
from repro_torch.kernels.ref import gathered_kernel_ref

RTOL = 1e-12


def _points(n, d, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=(n, d))


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _clusters(seed):
    """Two clusters further apart than the WFR range at eta = 0.2."""
    rng = np.random.default_rng(seed)
    x = np.zeros((120, 3))
    x[:60, 0] = rng.uniform(0.0, 0.2, 60)
    x[60:, 0] = rng.uniform(1.8, 2.0, 60)
    return x


@pytest.mark.parametrize("cost", ["sqeuclidean", "euclidean"])
def test_point_costs_match_reference(cost):
    x, y = _points(40, 4, 0), _points(30, 4, 1)
    fn_t = getattr(tgeo, f"{cost}_cost" if cost == "euclidean" else "squared_euclidean_cost")
    fn_j = getattr(jgeo, f"{cost}_cost" if cost == "euclidean" else "squared_euclidean_cost")
    _close(fn_t(torch.as_tensor(x), torch.as_tensor(y)), fn_j(jnp.asarray(x), jnp.asarray(y)))


def test_wfr_cost_and_kernels_match_reference_with_blocked_entries():
    x = _clusters(2)
    c_t = tgeo.wfr_cost(torch.as_tensor(x), eta=0.2)
    c_j = jgeo.wfr_cost(jnp.asarray(x), eta=0.2)
    blocked = np.isinf(np.asarray(c_j))
    assert 0.2 < blocked.mean() < 0.8  # the blocked branch is taken
    np.testing.assert_array_equal(np.isinf(c_t.numpy()), blocked)
    _close(c_t, c_j)
    for eps in (0.1, 1e-3):
        k_t, k_j = tgeo.gibbs_kernel(c_t, eps), jgeo.gibbs_kernel(c_j, eps)
        assert (k_t.numpy()[blocked] == 0).all()
        _close(k_t, k_j)
        _close(tgeo.log_gibbs_kernel(c_t, eps), jgeo.log_gibbs_kernel(c_j, eps))
    d = np.linspace(0.0, 2.0, 101)
    for floor in (1e-300, 1e-30):
        ct, bt = tgeo.wfr_from_dist(torch.as_tensor(d), 0.3, cos_floor=floor)
        cj, bj = jgeo.wfr_from_dist(jnp.asarray(d), 0.3, cos_floor=floor)
        _close(ct, cj)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


@pytest.mark.parametrize("cost", ["sqeuclidean", "euclidean", "wfr"])
def test_gathered_cost_matches_reference(cost):
    x, y = _clusters(3), _clusters(4)
    rng = np.random.default_rng(5)
    rows, cols = rng.integers(0, 120, 500), rng.integers(0, 120, 500)
    c_t = tgeo.gathered_cost(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(rows),
                             torch.as_tensor(cols), cost=cost, eta=0.2)
    c_j = jgeo.gathered_cost(jnp.asarray(x), jnp.asarray(y), jnp.asarray(rows),
                             jnp.asarray(cols), cost=cost, eta=0.2)
    _close(c_t, c_j)


def test_normalize_cost_matches_reference():
    c = tgeo.wfr_cost(torch.as_tensor(_clusters(6)), eta=0.2)
    ct, st = tgeo.normalize_cost(c)
    cj, sj = jgeo.normalize_cost(jnp.asarray(c.numpy()))
    _close(ct, cj)
    assert float(st) == float(sj)


def test_geometry_kernels_and_bounded_cache_match_reference():
    x = _points(64, 3, 7)
    g, gj = Geometry.from_points(x, device="cpu"), JGeometry.from_points(jnp.asarray(x))
    _close(g.cost, gj.cost)
    _close(g.kernel(0.1), gj.kernel(0.1))
    _close(g.log_kernel(0.05), gj.log_kernel(0.05))
    assert g.kernel(0.1) is g.kernel(0.1)  # cached per eps
    for eps in np.linspace(0.01, 1.0, 12):
        g.kernel(float(eps))
    assert len(g._kernels) == Geometry.DEFAULT_CACHE_SIZE  # LRU-bounded
    gn, gnj = g.normalized(), gj.normalized()
    _close(gn.cost, gnj.cost)


def test_pointcloud_geometry_matches_dense_and_guards():
    x = _points(64, 3, 8)
    pc = PointCloudGeometry(x, device="cpu")
    torch.testing.assert_close(pc.cost, Geometry.from_points(x, device="cpu").cost, rtol=0, atol=0)
    pcw = PointCloudGeometry.wfr(x, eta=0.2, device="cpu")
    _close(pcw.cost, JPointCloudGeometry(jnp.asarray(x), cost="wfr", eta=0.2).cost)
    guarded = PointCloudGeometry(x, dense_guard=32, device="cpu")
    for access in (lambda: guarded.cost, lambda: guarded.kernel(0.1),
                   lambda: guarded.log_kernel(0.1), guarded.normalized):
        with pytest.raises(ValueError, match="refuses dense"):
            access()
    k_e, c_e = guarded.entries(torch.arange(8), torch.arange(8), 0.1)
    assert k_e.shape == (8,) and c_e.shape == (8,)
    with pytest.raises(KeyError):
        PointCloudGeometry(x, cost="euclidean", device="cpu")
    with pytest.raises(TypeError):
        PointCloudGeometry.from_cost(np.eye(4))


@pytest.mark.parametrize("cost", ["sqeuclidean", "wfr"])
def test_pointcloud_entries_match_reference(cost):
    x = _clusters(9)
    rng = np.random.default_rng(10)
    rows, cols = rng.integers(0, 120, 700), rng.integers(0, 120, 700)
    pc = PointCloudGeometry(x, cost=cost, eta=0.2, device="cpu")
    pcj = JPointCloudGeometry(jnp.asarray(x), cost=cost, eta=0.2)
    k_t, c_t = pc.entries(torch.as_tensor(rows), torch.as_tensor(cols), 0.1)
    k_j, c_j = pcj.entries(jnp.asarray(rows), jnp.asarray(cols), 0.1, impl="jnp")
    assert k_t.dtype == torch.float64  # the CPU path keeps the points' dtype
    _close(k_t, k_j)
    _close(c_t, c_j)
    _close(pc.cost_entries(torch.as_tensor(rows), torch.as_tensor(cols)), c_j)
    with pytest.raises(ValueError, match="CUDA"):
        pc.entries(torch.as_tensor(rows), torch.as_tensor(cols), 0.1, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        pc.entries(torch.as_tensor(rows), torch.as_tensor(cols), 0.1, impl="pallas")


def _kernel_inputs(cost):
    """The reference kernel tests' shapes: n=100, m=80, d=5, k=777 for
    sqeuclidean; the two-cluster WFR case for the blocked branch."""
    rng = np.random.default_rng(0)
    if cost == "sqeuclidean":
        x, y = rng.uniform(size=(100, 5)), rng.uniform(size=(80, 5))
        rows, cols = rng.integers(0, 100, 777), rng.integers(0, 80, 777)
        return x.astype(np.float32), y.astype(np.float32), rows, cols, 1.0
    x = np.zeros((256, 128), np.float32)
    x[:128, 0] = rng.uniform(0.0, 0.2, 128)
    x[128:, 0] = rng.uniform(1.8, 2.0, 128)
    rows, cols = rng.integers(0, 256, 1024), rng.integers(0, 256, 1024)
    return x, x, rows, cols, 0.2


@pytest.mark.parametrize("cost", ["sqeuclidean", "wfr"])
def test_gathered_kernel_plain_version_matches_reference_kernel(cost):
    x, y, rows, cols, eta = _kernel_inputs(cost)
    args_t = (torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(rows), torch.as_tensor(cols))
    args_j = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32))
    k_t, c_t = gathered_kernel(*args_t, eps=0.1, cost=cost, eta=eta)  # CPU: the plain version
    k_r, c_r = gathered_kernel_ref(*args_t, eps=0.1, cost=cost, eta=eta)
    assert k_t.dtype == torch.float32 and c_t.dtype == torch.float32
    torch.testing.assert_close(k_t, k_r, rtol=0, atol=0)
    torch.testing.assert_close(c_t, c_r, rtol=0, atol=0)
    k_pallas, c_pallas = j_gathered_kernel(*args_j, eps=0.1, cost=cost, eta=eta, interpret=True)
    k_dense, c_dense = j_gathered_kernel_ref(*args_j, eps=0.1, cost=cost, eta=eta)
    blocked = np.isinf(np.asarray(c_dense))
    if cost == "wfr":
        assert 0.1 < blocked.mean() < 0.9  # the blocked branch is taken
    np.testing.assert_array_equal(k_t.numpy()[blocked], 0.0)
    assert np.isposinf(c_t.numpy()[blocked]).all()
    for k_j, c_j in ((k_pallas, c_pallas), (k_dense, c_dense)):
        np.testing.assert_array_equal(np.isinf(np.asarray(c_j)), blocked)
        ok = ~blocked
        np.testing.assert_allclose(k_t.numpy()[ok], np.asarray(k_j)[ok], rtol=2e-3, atol=1e-6)
        np.testing.assert_allclose(c_t.numpy()[ok], np.asarray(c_j)[ok], rtol=2e-4, atol=1e-5)


def test_gathered_kernel_wrapper_casts_and_checks():
    x, y, rows, cols, _ = _kernel_inputs("sqeuclidean")
    x64 = torch.as_tensor(x.astype(np.float64))
    k64, c64 = gathered_kernel(x64, torch.as_tensor(y), torch.as_tensor(rows),
                               torch.as_tensor(cols), eps=0.1)
    k32, c32 = gathered_kernel(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(rows),
                               torch.as_tensor(cols), eps=0.1)
    assert k64.dtype == torch.float32
    torch.testing.assert_close(k64, k32, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown cost"):
        gathered_kernel(x64, x64, torch.as_tensor(rows), torch.as_tensor(cols), eps=0.1, cost="l1")
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        gathered_kernel(x64, x64[:, :2], torch.as_tensor(rows), torch.as_tensor(cols), eps=0.1)
    with pytest.raises(ValueError, match="equal-length"):
        gathered_kernel(x64, x64, torch.as_tensor(rows), torch.as_tensor(cols[:5]), eps=0.1)
