"""Port parity: the tile-granular sketch, the block-ELL mat-vecs and kernel
B4's plain path, and ``solve(method="spar_sink_block_ell")``, held against
the JAX package on the same numpy inputs.

* Kernel ops (`block_ell_matvec_ref`, `ops.block_ell_matvec`,
  `ops.batched_block_ell_matvec`) against the Pallas kernel in interpret
  mode and ``repro.kernels``: the reference kernel tests' rtol 2e-4 /
  atol 1e-6, two float32 computations that sum in different orders.
* The sampler fed the reference's uniforms, kernel and tile probabilities:
  bitwise equal layouts in float64.
* Mat-vecs and densification on a shared sketch: rtol 1e-12 (float64, sums
  in another order).
* The solve on the reference's sketch: the same ``n_iter`` and ``status``,
  values to rtol 1e-9 (rounding amplified over some hundred iterations).
* ``K~^T u`` on the row layout's tiles (what the card runs): the column
  lists cover every valid tile once, in the reference's scatter order; the
  plain version `block_ell_rmatvec_ref` and an emulation of the kernel's
  work units and fixed-order combine in float32 torch, against the float64
  CPU path and the reference's scatter at the kernel tolerance above.
* ``K~ v`` over the valid slots alone (the solver's launch, with the
  sketch's ``nblocks``): the kernel's walk emulated in float32 torch is
  bitwise the walk over every slot for finite v (rows with no valid slot,
  a ``row_ptr`` layout, two folded sketches), and gives NaN exactly where
  the all-slot walk and the plain version do when a sketch's v block 0
  holds an inf or a NaN; the once-per-sketch check of that layout.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers, and
# torch's default of one thread a core would put 48 threads on 8 cores
torch.set_num_threads(1)

import repro.kernels as jk
from repro.core import sparsify as jsp
from repro.core.api import Geometry as JGeometry
from repro.core.api import OTProblem as JOTProblem
from repro.core.api import UOTProblem as JUOTProblem
from repro.core.api import solve as jsolve
from repro.core.api import solvers as jsolvers
from repro.core.geometry import gibbs_kernel as j_gibbs_kernel
from repro.core.geometry import normalize_cost as j_normalize_cost
from repro.core.geometry import squared_euclidean_cost as j_sqeuclidean
from repro.core.geometry import wfr_cost as j_wfr_cost
from repro.core.spar_sink import default_max_blocks as j_default_max_blocks
from repro.core.spar_sink import s0
from repro.kernels.block_ell import block_ell_matvec_call
from repro.kernels.ref import block_ell_matvec_ref as j_block_ell_matvec_ref
from repro_torch import interop
from repro_torch.core import sparsify as tsp
from repro_torch.core.api import Geometry, OTProblem, PointCloudGeometry, UOTProblem, available_methods, solve
from repro_torch.core.api import solvers as tsolvers
from repro_torch.core.sinkhorn import CHECK_EVERY
from repro_torch.core.spar_sink import default_max_blocks
from repro_torch.kernels import batched_block_ell_matvec, block_ell_matvec, library, ops, ref
from repro_torch.kernels.block_ell import UNIT_TILES, column_lists

KERNEL_TOL = dict(rtol=2e-4, atol=1e-6)
SHAPES = [(8, 2, 4), (16, 4, 8), (32, 3, 4)]  # (bk, maxb, nrb), tests/test_kernels_cpu.py
EPS = 0.1
N = 128


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _random_layout(bk, maxb, nrb, seed, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    vals = rng.uniform(size=lead + (nrb, maxb, bk, bk)).astype(np.float32)
    col_idx = rng.integers(0, nrb, lead + (nrb, maxb)).astype(np.int32)
    v = rng.uniform(size=lead + (nrb * bk,)).astype(np.float32)
    return vals, col_idx, v


# --------------------------------------------------------------------------
# Kernel B4's plain path against the Pallas kernel
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bk,maxb,nrb", SHAPES)
def test_block_ell_matvec_matches_pallas_kernel(bk, maxb, nrb):
    vals, col_idx, v = _random_layout(bk, maxb, nrb, seed=bk * maxb)
    raw_j = block_ell_matvec_call(jnp.asarray(vals), jnp.asarray(col_idx), jnp.asarray(v.reshape(-1, bk)),
                                  interpret=True)
    raw_t = ref.block_ell_matvec_ref(*_t(vals, col_idx, v.reshape(-1, bk)))
    assert raw_t.dtype == torch.float32 and raw_t.shape == (nrb, bk)
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), **KERNEL_TOL)
    oracle = j_block_ell_matvec_ref(jnp.asarray(vals), jnp.asarray(col_idx), jnp.asarray(v.reshape(-1, bk)))
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(oracle), **KERNEL_TOL)
    out_j = jk.block_ell_matvec(jnp.asarray(vals), jnp.asarray(col_idx), jnp.asarray(v), interpret=True)
    out_t = block_ell_matvec(*_t(vals, col_idx, v))
    assert out_t.dtype == torch.float32 and out_t.shape == (nrb * bk,)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **KERNEL_TOL)
    # int64 ids and float64 tiles/v are cast as on the card
    out_64 = block_ell_matvec(*_t(vals.astype(np.float64), col_idx.astype(np.int64), v.astype(np.float64)))
    assert torch.equal(out_64, out_t)


def test_batched_block_ell_matvec_matches_reference():
    vals, col_idx, v = _random_layout(16, 2, 4, seed=0, batch=3)
    out_j = jk.batched_block_ell_matvec(jnp.asarray(vals), jnp.asarray(col_idx), jnp.asarray(v), interpret=True)
    out_t = batched_block_ell_matvec(*_t(vals, col_idx, v))
    assert out_t.shape == (3, 4 * 16)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **KERNEL_TOL)
    for i in range(3):  # one launch for B sketches = B single mat-vecs
        torch.testing.assert_close(out_t[i], block_ell_matvec(*_t(vals[i], col_idx[i], v[i])), rtol=1e-6, atol=1e-6)


def _wfr_case():
    """The WFR zero-mass case of tests/test_kernels_cpu.py: two clusters
    further apart than pi * eta, so every tile across them is blocked."""
    n, bk = 128, 16
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(0.0, 0.2, (n // 2, 2)), rng.uniform(1.8, 2.0, (n // 2, 2))])
    x = jnp.asarray(x, jnp.float32)
    K = j_gibbs_kernel(j_wfr_cost(x, eta=0.2), 0.1).astype(jnp.float32)
    a = jnp.asarray(rng.dirichlet(np.ones(n)), jnp.float32)
    tp = jsp.ot_tile_probs(a, a, bk).astype(jnp.float32)
    v = jnp.asarray(rng.uniform(size=(n,)), jnp.float32)
    return n, bk, K, tp, v


@pytest.mark.parametrize("ensure", [True, False], ids=["forced", "unforced"])
def test_wfr_zero_mass_rows_come_out_exactly_zero(ensure):
    """With forced tiles (the reference test's draw) every row keeps a tile
    of its own cluster; without them, key 3 leaves row-blocks whose kept
    tiles are all blocked, and those rows must be exactly 0."""
    n, bk, K, tp, v = _wfr_case()
    key = jax.random.PRNGKey(3)
    sk = jsp.sparsify_block_ell(key, K, tp, float(n * 8), bk, 4, ensure_rows=ensure)
    out_j = block_ell_matvec_call(sk.vals, sk.col_idx, v.reshape(-1, bk), interpret=True).reshape(-1)
    out_t = block_ell_matvec(*_t(sk.vals, sk.col_idx, v))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **KERNEL_TOL)
    # the port's sampler, fed the same uniforms, gives the same sketch
    uniforms = jax.random.uniform(key, tp.shape, dtype=tp.dtype)
    tsk = tsp.sparsify_block_ell_from_uniforms(*_t(uniforms, K, tp), float(n * 8), bk, 4, ensure_rows=ensure)
    assert torch.equal(tsk.vals, torch.as_tensor(np.array(sk.vals)))
    has_tiles = np.repeat(np.asarray(sk.nblocks) > 0, bk)
    dead = (np.asarray(jnp.sum(jsp.block_ell_to_dense(sk), axis=1)) == 0) & has_tiles
    assert dead.any() != ensure
    assert (out_t.numpy()[dead] == 0).all() and (np.asarray(out_j)[dead] == 0).all()
    assert (tsp.block_ell_matvec(tsk, torch.as_tensor(np.array(v))).numpy()[dead] == 0).all()


def test_row_ptr_sums_the_ell_rows_of_a_row_block():
    vals, col_idx, v = _random_layout(8, 3, 5, seed=2)
    row_ptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)  # 5 ELL rows -> 3 row-blocks, one empty
    per_row = ref.block_ell_matvec_ref(*_t(vals, col_idx, v.reshape(-1, 8)))
    expect = torch.stack([per_row[0] + per_row[1], torch.zeros(8), per_row[2] + per_row[3] + per_row[4]])
    out = block_ell_matvec(*_t(vals, col_idx, v), row_ptr=row_ptr)
    assert out.shape == (24,)
    torch.testing.assert_close(out.reshape(3, 8), expect, rtol=1e-6, atol=1e-6)


def test_wrapper_errors():
    vals, col_idx, v = _t(*_random_layout(8, 2, 4, seed=1))
    with pytest.raises(ValueError, match="shapes must be"):
        block_ell_matvec(vals[0], col_idx, v)
    with pytest.raises(ValueError, match="ids per sketch"):
        block_ell_matvec(vals, col_idx[:, :1], v)
    with pytest.raises(ValueError, match="whole blocks"):
        block_ell_matvec(vals, col_idx, v[:-1])
    with pytest.raises(TypeError, match="floating point"):
        block_ell_matvec(vals.to(torch.int32), col_idx, v)
    with pytest.raises(TypeError, match="int32 or int64"):
        block_ell_matvec(vals, col_idx.to(torch.float32), v)
    for bad in (4, -1):
        ci = col_idx.clone()
        ci[1, 1] = bad
        with pytest.raises(IndexError, match="out of range"):
            block_ell_matvec(vals, ci, v)
    with pytest.raises(IndexError, match="row_ptr"):
        block_ell_matvec(vals, col_idx, v, row_ptr=torch.tensor([0, 3, 2, 4]))
    with pytest.raises(ValueError, match="one device"):
        block_ell_matvec(vals, col_idx, v.to("meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        block_ell_matvec(vals.to("meta"), col_idx.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="shapes must be"):
        batched_block_ell_matvec(vals, col_idx, v)
    assert all(count == 0 for count in ops.LAUNCHES.values())  # CPU: no kernel launched


# --------------------------------------------------------------------------
# Sampling probabilities and the sampler
# --------------------------------------------------------------------------


def _measures(n, kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 3))
    if kind == "tied":  # uniform weights: every row and column mass ties
        a = b = np.full(n, 1.0 / n)
    else:
        a, b = rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))
    if kind == "uot":
        a, b = 5 * a, 3 * b
    C = np.asarray(j_normalize_cost(j_sqeuclidean(jnp.asarray(x)))[0])
    return C, a, b


def test_sampling_probabilities_match_reference():
    C, a, b = _measures(64, "ot")
    logK = -C / EPS
    logK[0, :5] = -np.inf  # blocked entries get probability exactly 0
    np.testing.assert_allclose(tsp.ot_sampling_probs(*_t(a, b)).numpy(),
                               np.asarray(jsp.ot_sampling_probs(jnp.asarray(a), jnp.asarray(b))), rtol=1e-13)
    pu_t = tsp.uot_sampling_probs(*_t(5 * a, 3 * b, logK), 0.5, EPS).numpy()
    pu_j = np.asarray(jsp.uot_sampling_probs(jnp.asarray(5 * a), jnp.asarray(3 * b), jnp.asarray(logK), 0.5, EPS))
    np.testing.assert_allclose(pu_t, pu_j, rtol=1e-12)
    assert (pu_t[0, :5] == 0).all() and abs(pu_t.sum() - 1) < 1e-12
    np.testing.assert_array_equal(tsp.uniform_probs(8, 4, torch.float64, device="cpu").numpy(),
                                  np.asarray(jsp.uniform_probs(8, 4, jnp.float64)))
    for bk in (16, 32):
        np.testing.assert_allclose(tsp.ot_tile_probs(*_t(a, b), bk).numpy(),
                                   np.asarray(jsp.ot_tile_probs(jnp.asarray(a), jnp.asarray(b), bk)), rtol=1e-13)
        np.testing.assert_allclose(tsp.tile_probs_from_elem(torch.tensor(pu_j), bk).numpy(),
                                   np.asarray(jsp.tile_probs_from_elem(jnp.asarray(pu_j), bk)), rtol=1e-13)
    p = torch.tensor(pu_j)
    np.testing.assert_allclose(tsolvers.mix_uniform(p, 0.3).numpy(),
                               np.asarray(jsolvers.mix_uniform(jnp.asarray(pu_j), 0.3)), rtol=1e-14)
    with pytest.raises(ValueError, match="rank-2"):
        tsolvers.mix_uniform((p[:, 0], p[0]), 0.3)


@pytest.mark.parametrize("n,s,block", [(128, 3000.0, 32), (128, 1e5, 128), (8192, 8.6e5, 128), (64, 50.0, 32)])
def test_default_max_blocks_matches_reference(n, s, block):
    assert default_max_blocks(n, s, block) == j_default_max_blocks(n, s, block)


def _reference_sketch_inputs(kind, n, bk, shrinkage=0.0):
    """K, tile probabilities and the uniforms of ``sparsify_block_ell``'s
    draw, as the reference's registered solver makes them."""
    C, a, b = _measures(n, kind)
    if kind == "uot":
        jp = JUOTProblem(JGeometry(jnp.asarray(C)), jnp.asarray(a), jnp.asarray(b), EPS, lam=0.5)
    else:
        jp = JOTProblem(JGeometry(jnp.asarray(C)), jnp.asarray(a), jnp.asarray(b), EPS)
    tile_p = jsp.tile_probs_from_elem(jsolvers._resolve_probs(jp, None, shrinkage), bk)
    key = jax.random.PRNGKey(n + bk)
    return key, jp.kernel(), tile_p, jax.random.uniform(key, tile_p.shape, dtype=tile_p.dtype)


@pytest.mark.parametrize(
    "kind,bk,maxb,shrinkage",
    [("ot", 16, 3, 0.0), ("ot", 32, 4, 0.0), ("uot", 16, 3, 0.0), ("ot", 16, 3, 0.5), ("tied", 16, 3, 0.0)],
)
def test_sampler_fed_reference_uniforms_is_bitwise_equal(kind, bk, maxb, shrinkage):
    """Every row-block's forced tile of rank-1 probabilities lies in one
    column-block, which overflows ``maxb`` unless ``maxb >= n / bk``
    (``("ot", 32, 4)``)."""
    n, s = 128, 2000.0
    key, K, tile_p, uniforms = _reference_sketch_inputs(kind, n, bk, shrinkage)
    sk_j = jsp.sparsify_block_ell(key, K, tile_p, s, bk, maxb)
    pair_j, pair_jt = jsp.sparsify_block_ell_pair(key, K, tile_p, s, bk, maxb)
    sk = tsp.sparsify_block_ell_from_uniforms(*_t(uniforms, K, tile_p), s, bk, maxb)
    for field in ("vals", "col_idx", "nblocks"):
        for ref_sk in (sk_j, pair_j):
            np.testing.assert_array_equal(getattr(sk, field).numpy(), np.asarray(getattr(ref_sk, field)))
    assert sk.col_idx.dtype == torch.int32 and sk.vals32 is None  # no float32 copy on the CPU
    # the transposed layout is exactly the row layout's transpose ...
    dense = tsp.block_ell_to_dense(sk)
    assert torch.equal(tsp.block_ell_to_dense(sk.transposed), dense.T)
    counts = np.bincount(np.asarray(sk_j.col_idx)[np.arange(sk_j.max_blocks)[None, :] < np.asarray(sk_j.nblocks)[:, None]],
                         minlength=n // bk)
    if counts.max() <= maxb:  # ... and the reference pair's, where no column-block overflows
        assert sk.transposed.row_ptr is None
        for field in ("vals", "col_idx", "nblocks"):
            np.testing.assert_array_equal(getattr(sk.transposed, field).numpy(), np.asarray(getattr(pair_jt, field)))
    else:  # the reference pair drops the overflow; the port splits it over ELL rows
        assert sk.transposed.row_ptr is not None
        assert not np.array_equal(np.asarray(jsp.block_ell_to_dense(pair_jt)), dense.T.numpy())
    # the generator-driven draw keeps the same shapes
    drawn = tsp.sparsify_block_ell(torch.Generator().manual_seed(0), *_t(K, tile_p), s, bk, maxb)
    assert drawn.vals.shape == sk.vals.shape


def test_tied_masses_need_the_stable_sort():
    """Uniform weights tie every row and column mass: the forced column
    matching must follow index order, as the reference's stable argsort."""
    _, K, tile_p, uniforms = _reference_sketch_inputs("tied", 128, 16)
    p_t = tsp._tile_keep_probs(torch.as_tensor(np.array(tile_p)), 2000.0, 16, True)
    p_j = jsp._tile_keep_probs(tile_p, 2000.0, 16, True)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    assert bool((p_t.diagonal() == 1.0).all())  # row k matched with column k


def test_block_ell_sampler_is_unbiased():
    """E[K~] = K over the port's own draws (tests/test_sparsify.py)."""
    rng = np.random.default_rng(0)
    n, bk = 64, 16
    x = torch.as_tensor(rng.uniform(size=(n, 2)))
    a = torch.as_tensor(rng.dirichlet(np.ones(n)))
    b = torch.as_tensor(rng.dirichlet(np.ones(n)))
    K = torch.exp(-torch.cdist(x, x) ** 2 / EPS)
    tp = tsp.ot_tile_probs(a, b, bk)
    gen = torch.Generator().manual_seed(0)
    n_rep = 300
    acc = sum(tsp.block_ell_to_dense(tsp.sparsify_block_ell(gen, K, tp, 1500.0, bk, 4)) for _ in range(n_rep))
    mean = (acc / n_rep).numpy()
    assert np.abs(mean - K.numpy()).mean() < 0.05 * K.numpy().mean() + 0.02


# --------------------------------------------------------------------------
# Mat-vecs on a shared sketch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ot", "tied"])
def test_matvecs_and_densify_match_reference(kind):
    n, bk, maxb, s = 128, 16, 3, 2000.0
    key, K, tile_p, uniforms = _reference_sketch_inputs(kind, n, bk)
    sk_j = jsp.sparsify_block_ell(key, K, tile_p, s, bk, maxb)
    sk = tsp.sparsify_block_ell_from_uniforms(*_t(uniforms, K, tile_p), s, bk, maxb)
    v = np.random.default_rng(1).uniform(size=n)
    vt = torch.as_tensor(v)
    np.testing.assert_allclose(tsp.block_ell_matvec(sk, vt).numpy(),
                               np.asarray(jsp.block_ell_matvec(sk_j, jnp.asarray(v))), rtol=1e-12)
    rmat = tsp.block_ell_rmatvec(sk, vt)
    np.testing.assert_allclose(rmat.numpy(), np.asarray(jsp.block_ell_rmatvec(sk_j, jnp.asarray(v))), rtol=1e-12)
    np.testing.assert_array_equal(tsp.block_ell_to_dense(sk).numpy(), np.asarray(jsp.block_ell_to_dense(sk_j)))
    # the plain mat-vec on the transposed layout (what the card runs for K~^T u)
    torch.testing.assert_close(tsp.block_ell_matvec(sk.transposed, vt), rmat, rtol=1e-12, atol=0)
    t32 = sk.transposed
    on_t = block_ell_matvec(t32.vals, t32.col_idx, vt, row_ptr=t32.row_ptr)
    torch.testing.assert_close(on_t, rmat.to(torch.float32), **KERNEL_TOL)
    # the transposed layout's own rmatvec (a scatter over its ELL rows) is K~ v
    torch.testing.assert_close(tsp.block_ell_rmatvec(sk.transposed, vt), tsp.block_ell_matvec(sk, vt),
                               rtol=1e-12, atol=0)


def test_interop_carries_the_reference_pair_and_refuses_a_truncated_one():
    for bk, maxb, ok in ((32, 4, True), (16, 3, False)):
        key, K, tile_p, _ = _reference_sketch_inputs("ot", 128, bk)
        rows, cols = jsp.sparsify_block_ell_pair(key, K, tile_p, 2000.0, bk, maxb)
        arrays = [np.asarray(t) for t in (rows.vals, rows.col_idx, rows.nblocks)]
        kw = dict(vals_t=np.asarray(cols.vals), col_idx_t=np.asarray(cols.col_idx),
                  nblocks_t=np.asarray(cols.nblocks), device="cpu")
        if not ok:
            with pytest.raises(ValueError, match="overflowed"):
                interop.block_ell_sketch_from_numpy(*arrays, 128, 128, **kw)
            continue
        sk = interop.block_ell_sketch_from_numpy(*arrays, 128, 128, **kw)
        assert sk.col_idx.dtype == torch.int32 and sk.transposed.n == 128
        assert torch.equal(tsp.block_ell_to_dense(sk.transposed), tsp.block_ell_to_dense(sk).T)


# --------------------------------------------------------------------------
# The solve
# --------------------------------------------------------------------------


def _api_problems(kind):
    """The tests/test_api.py problem: N = 128, d = 4, normalized cost."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(N, 4))
    a, b = rng.dirichlet(np.ones(N)), rng.dirichlet(np.ones(N))
    C = np.asarray(j_normalize_cost(j_sqeuclidean(jnp.asarray(x)))[0])
    if kind == "ot":
        return (JOTProblem(JGeometry(jnp.asarray(C)), jnp.asarray(a), jnp.asarray(b), EPS),
                OTProblem(Geometry(C, device="cpu"), a, b, EPS))
    return (JUOTProblem(JGeometry(jnp.asarray(C)), jnp.asarray(5 * a), jnp.asarray(3 * b), EPS, lam=0.5),
            UOTProblem(Geometry(C, device="cpu"), 5 * a, 3 * b, EPS, lam=0.5))


@pytest.mark.parametrize(
    "kind,block,mult,tol,n_iter,status",
    [("ot", 32, 16, 1e-9, 136, 2), ("ot", 64, 16, 1e-9, 138, 2), ("uot", 32, 32, 1e-6, 52, 0)],
)
def test_solve_on_reference_sketch_matches_reference(kind, block, mult, tol, n_iter, status):
    """The reference's registered solve and the port's loop on the same
    sketch: OT stops on the stall rule at 136 / 138 (ROADMAP C-2), UOT
    converges in 52."""
    jp, tp = _api_problems(kind)
    s, key = mult * s0(N), jax.random.PRNGKey(0)
    sol_j = jsolve(jp, method="spar_sink_block_ell", key=key, s=s, block=block, tol=tol, max_iter=5000)
    tile_p = jsp.tile_probs_from_elem(jsolvers._resolve_probs(jp, None, 0.0), block)
    rows, cols = jsp.sparsify_block_ell_pair(key, jp.kernel(), tile_p, s, block, j_default_max_blocks(N, s, block))
    sk = interop.block_ell_sketch_from_numpy(
        *(np.asarray(t) for t in (rows.vals, rows.col_idx, rows.nblocks)), N, N,
        vals_t=np.asarray(cols.vals), col_idx_t=np.asarray(cols.col_idx), nblocks_t=np.asarray(cols.nblocks),
        device="cpu",
    )
    sol_t = tsolvers._block_ell_solution(tp, sk, tol, 5000)
    assert (int(sol_j.n_iter), int(sol_j.status)) == (n_iter, status)
    assert (int(sol_t.n_iter), int(sol_t.status)) == (n_iter, status)
    np.testing.assert_allclose(sol_t.result.u.numpy(), np.asarray(sol_j.result.u), rtol=1e-9)
    np.testing.assert_allclose(sol_t.result.v.numpy(), np.asarray(sol_j.result.v), rtol=1e-9)
    np.testing.assert_allclose(float(sol_t.value), float(sol_j.value), rtol=1e-9)
    assert int(sol_t.nnz) == int(sol_j.nnz)
    np.testing.assert_allclose(sol_t.plan().numpy(), np.asarray(sol_j.plan()), rtol=1e-9, atol=1e-300)


def test_registered_solve_runs_on_the_cpu_and_is_reproducible():
    _, tp = _api_problems("ot")
    opts = dict(method="spar_sink_block_ell", s=4 * s0(N), block=32, tol=1e-6)
    sol = solve(tp, seed=3, **opts)
    again = solve(tp, generator=torch.Generator().manual_seed(3), **opts)
    assert sol.domain == "scaling" and sol.result.u.device.type == "cpu"
    assert float(sol.value) == float(again.value) and int(sol.n_iter) == int(again.n_iter)
    plan = sol.plan()
    assert plan.shape == (N, N) and int(torch.sum(plan > 0)) <= int(sol.nnz)
    row, col = sol.marginals()
    torch.testing.assert_close(col, tp.b, rtol=0, atol=1e-6)  # v is updated last
    assert math.isfinite(float(sol.value))


def test_solve_runs_two_matvecs_per_executed_iteration(monkeypatch):
    """`chip_smoke.py` counts the kernel launches of a block-ELL solve as
    2 * min(max_iter, CHECK_EVERY * ceil(n_iter / CHECK_EVERY)); counted
    here on the CPU path, which runs in the kernel's place."""
    calls = []
    real = tsp.block_ell_matvec

    def counted(sk, v, bad_index=None):
        calls.append(1)
        return real(sk, v, bad_index)

    monkeypatch.setattr(tsp, "block_ell_matvec", counted)
    monkeypatch.setattr(tsp, "block_ell_rmatvec", lambda sk, u, bad_index=None: counted(sk.transposed, u))
    _, tp = _api_problems("uot")
    for max_iter in (1000, 20, 0):
        calls.clear()
        sol = solve(tp, method="spar_sink_block_ell", seed=0, s=8 * s0(N), block=32, max_iter=max_iter)
        n_iter = int(sol.n_iter)
        assert len(calls) == 2 * min(max_iter, CHECK_EVERY * math.ceil(n_iter / CHECK_EVERY))


def test_registry_lists_block_ell_and_rejects_bad_options():
    assert "spar_sink_block_ell" in available_methods()
    _, tp = _api_problems("ot")
    # trace= and certify= are options here, as in the reference; init= is not
    for opt in (dict(init=(None, None)), dict(stabilize=True), dict(key=0)):
        with pytest.raises(TypeError, match="unexpected option"):
            solve(tp, method="spar_sink_block_ell", s=100.0, seed=0, **opt)
    with pytest.raises(TypeError, match=r"requires option\(s\) \['s'\]"):
        solve(tp, method="spar_sink_block_ell", seed=0)
    with pytest.raises(TypeError, match="exactly one of generator"):
        solve(tp, method="spar_sink_block_ell", s=100.0)
    with pytest.raises(ValueError, match="divisible by block=48"):
        solve(tp, method="spar_sink_block_ell", s=100.0, seed=0, block=48)
    x = np.random.default_rng(0).uniform(size=(256, 2))
    big = OTProblem(PointCloudGeometry(x, dense_guard=128, device="cpu"), np.full(256, 1 / 256), np.full(256, 1 / 256), EPS)
    with pytest.raises(ValueError, match="dense_guard=128"):
        solve(big, method="spar_sink_block_ell", s=100.0, seed=0, block=32)


# --------------------------------------------------------------------------
# K~^T u on the row layout's tiles: column lists, plain version, the kernel's
# arithmetic
# --------------------------------------------------------------------------


def _listed(cols):
    return [cols.tile[int(cols.col_ptr[c]):int(cols.col_ptr[c + 1])].tolist()
            for c in range(cols.col_ptr.shape[0] - 1)]


@pytest.mark.parametrize("kind,bk,maxb", [("ot", 16, 3), ("uot", 16, 3), ("tied", 16, 3), ("ot", 32, 4)])
def test_column_lists_cover_every_valid_tile_once(kind, bk, maxb):
    """The lists of a sketch built from the reference's uniforms (and of its
    transposed layout, whose row-blocks span several ELL rows): every valid
    slot exactly once, under its column id, in the order of row-block then
    slot, with the row-block of its ELL row, cut into units of UNIT_TILES."""
    n, s = 128, 2000.0
    _, K, tile_p, uniforms = _reference_sketch_inputs(kind, n, bk)
    sk = tsp.sparsify_block_ell_from_uniforms(*_t(uniforms, K, tile_p), s, bk, maxb)
    for lay in (sk, sk.transposed):
        cols = tsp.block_ell_columns(lay)
        assert all(t.dtype == torch.int32 for t in (cols.tile, cols.urow, cols.col_ptr, cols.col_unit_ptr))
        valid = (torch.arange(lay.max_blocks)[None, :] < lay.nblocks[:, None]).reshape(-1)
        want = torch.nonzero(valid).reshape(-1)
        assert sorted(cols.tile.tolist()) == want.tolist()  # each valid slot once
        ids = lay.col_idx.reshape(-1)
        row_of = lay.row_blocks_of_ell_rows()
        for c, tiles in enumerate(_listed(cols)):
            assert all(int(ids[t]) == c for t in tiles)
            assert tiles == sorted(tiles)  # ELL rows follow their row-blocks: row-block, then slot
        assert torch.equal(cols.urow.long(), row_of[cols.tile.long() // lay.max_blocks])
        counts = torch.diff(cols.col_ptr.long())
        assert torch.equal(torch.diff(cols.col_unit_ptr.long()), -(-counts // UNIT_TILES))
        assert cols.units == int(cols.col_unit_ptr[-1])
    if kind != "tied":  # rank-1 probabilities force every row-block's heaviest tile into one column-block
        assert int(torch.diff(tsp.block_ell_columns(sk).col_unit_ptr.long()).max()) > 1


def test_column_lists_refuse_a_column_id_out_of_range():
    vals, col_idx, _ = _t(*_random_layout(8, 2, 4, seed=1))
    nb = torch.full((4,), 2, dtype=torch.int32)
    for bad in (4, -1):
        ci = col_idx.clone()
        ci[1, 1] = bad
        with pytest.raises(IndexError, match="out of range"):
            column_lists(ci, nb, torch.arange(4), 4)
    ci = col_idx.clone()
    ci[1, 1] = 9  # a padded slot's id is never read
    column_lists(ci, torch.tensor([2, 1, 2, 2], dtype=torch.int32), torch.arange(4), 4)


@pytest.mark.parametrize("kind,bk,maxb", [("ot", 16, 3), ("uot", 16, 3), ("tied", 16, 3), ("ot", 32, 4)])
def test_block_ell_rmatvec_ref_matches_cpu_path_and_reference(kind, bk, maxb):
    """The plain version over the column lists against the port's float64
    CPU path on the port's sketch, and against the reference's scatter
    (`repro.core.sparsify.block_ell_rmatvec`) on the reference's own sketch,
    fed through interop (where no column-block overflows, the reference
    pair holds every tile: ("ot", 32, 4))."""
    n, s = 128, 2000.0
    key, K, tile_p, uniforms = _reference_sketch_inputs(kind, n, bk)
    u = np.random.default_rng(5).uniform(size=n)
    ut = torch.as_tensor(u)
    sk = tsp.sparsify_block_ell_from_uniforms(*_t(uniforms, K, tile_p), s, bk, maxb)
    got = ref.block_ell_rmatvec_ref(sk.vals, tsp.block_ell_columns(sk), ut.reshape(-1, bk)).reshape(-1)
    assert got.dtype == torch.float32 and got.shape == (n,)
    torch.testing.assert_close(got, tsp.block_ell_rmatvec(sk, ut).to(torch.float32), **KERNEL_TOL)
    sk_j = jsp.sparsify_block_ell(key, K, tile_p, s, bk, maxb)
    want_j = np.asarray(jsp.block_ell_rmatvec(sk_j, jnp.asarray(u)))
    np.testing.assert_allclose(got.numpy(), want_j, **KERNEL_TOL)
    if kind == "ot" and bk == 32:
        rows, cols = jsp.sparsify_block_ell_pair(key, K, tile_p, s, bk, maxb)
        sk_i = interop.block_ell_sketch_from_numpy(
            *(np.asarray(t) for t in (rows.vals, rows.col_idx, rows.nblocks)), n, n,
            vals_t=np.asarray(cols.vals), col_idx_t=np.asarray(cols.col_idx), nblocks_t=np.asarray(cols.nblocks),
            device="cpu")
        got_i = ref.block_ell_rmatvec_ref(sk_i.vals, tsp.block_ell_columns(sk_i), ut.reshape(-1, bk)).reshape(-1)
        np.testing.assert_allclose(got_i.numpy(), np.asarray(jsp.block_ell_rmatvec(rows, jnp.asarray(u))),
                                   **KERNEL_TOL)


def _kernel_unit_tiles() -> int:
    text = (library.CSRC / "block_ell.cu").read_text()
    return int(re.search(r"constexpr int kUnitTiles = (\d+);", text).group(1))


def test_kernel_unit_size_follows_the_source():
    """The lists are cut into units of the kernel's own size."""
    assert UNIT_TILES == _kernel_unit_tiles() >= 1


def _emulated_rmatvec(vals, cols, u):
    """The K~^T u kernel's arithmetic in float32 torch (its FMAs as a
    product and a sum): unit q of column-block c holds the list entries
    col_ptr[c] + (q - col_unit_ptr[c]) * kUnitTiles onward, at most
    kUnitTiles of them. At Bk = 128 warp w sums the tile rows 16w..16w+15
    of the unit's tiles in order, for each column, and the 8 warp sums are
    added in warp order; at other Bk each column is summed over the tiles
    and rows in order. The combine adds each column-block's unit partials
    in unit order, from 0."""
    unit = _kernel_unit_tiles()
    bk = vals.shape[-1]
    tiles = vals.reshape(-1, bk, bk).to(torch.float32)
    ub = u.to(torch.float32).reshape(-1, bk)
    ncb = cols.col_ptr.shape[0] - 1
    out = torch.zeros((ncb, bk), dtype=torch.float32)
    for c in range(ncb):
        c0, c1 = int(cols.col_ptr[c]), int(cols.col_ptr[c + 1])
        total = torch.zeros(bk, dtype=torch.float32)
        for q in range(int(cols.col_unit_ptr[c]), int(cols.col_unit_ptr[c + 1])):
            e0 = c0 + (q - int(cols.col_unit_ptr[c])) * unit
            entries = range(e0, min(e0 + unit, c1))
            if bk == 128:
                acc = torch.zeros((8, bk), dtype=torch.float32)  # warp, column
                for e in entries:
                    t, r = int(cols.tile[e]), int(cols.urow[e])
                    for k in range(16):
                        rows = torch.arange(8) * 16 + k
                        acc = acc + tiles[t][rows] * ub[r][rows][:, None]
                part = torch.zeros(bk, dtype=torch.float32)
                for w in range(8):
                    part = part + acc[w]
            else:
                part = torch.zeros(bk, dtype=torch.float32)
                for e in entries:
                    t, r = int(cols.tile[e]), int(cols.urow[e])
                    for i in range(bk):
                        part = part + tiles[t][i] * ub[r][i]
            total = total + part
        out[c] = total
    return out.reshape(-1)


def _hand_layout(bk, nrb, maxb, ncb, seed):
    """A row layout whose column-block 0 is kept by every row-block (several
    units) and whose last column-block by none (output exactly 0), with
    ragged valid counts."""
    rng = np.random.default_rng(seed)
    col_idx = np.zeros((nrb, maxb), np.int32)
    for r in range(nrb):
        col_idx[r, 1:] = rng.permutation(np.arange(1, ncb - 1))[: maxb - 1]
    nblocks = rng.integers(1, maxb + 1, nrb).astype(np.int32)
    nblocks[0] = maxb
    valid = np.arange(maxb)[None, :] < nblocks[:, None]
    vals = np.where(valid[:, :, None, None], rng.uniform(size=(nrb, maxb, bk, bk)), 0.0).astype(np.float32)
    col_idx = np.where(valid, col_idx, 0).astype(np.int32)
    u = rng.uniform(size=nrb * bk)
    return vals, col_idx, nblocks, u


@pytest.mark.parametrize("bk,nrb,maxb,ncb", [(8, 6, 3, 5), (16, 7, 4, 6), (128, 5, 3, 4)])
def test_kernel_rmatvec_arithmetic_matches_plain_version(bk, nrb, maxb, ncb):
    """The emulated units and combine against the plain version (and the
    float64 CPU path) at the kernel tolerance: both float32, summed in other
    orders. Column-block 0 spans several units; the last one has no tile
    and comes out exactly 0."""
    vals, col_idx, nblocks, u = _hand_layout(bk, nrb, maxb, ncb, seed=bk + nrb)
    sk = tsp.BlockEllKernel(*_t(vals.astype(np.float64), col_idx, nblocks), nrb * bk, ncb * bk)
    cols = tsp.block_ell_columns(sk)
    assert int(cols.col_unit_ptr[1]) > 1 and int(cols.col_ptr[-1] - cols.col_ptr[-2]) == 0
    ut = torch.as_tensor(u)
    got = _emulated_rmatvec(sk.vals, cols, ut)
    plain = ref.block_ell_rmatvec_ref(sk.vals, cols, ut.reshape(-1, bk)).reshape(-1)
    torch.testing.assert_close(got, plain, **KERNEL_TOL)
    torch.testing.assert_close(got, tsp.block_ell_rmatvec(sk, ut).to(torch.float32), **KERNEL_TOL)
    assert bool((got[-bk:] == 0).all()) and bool((plain[-bk:] == 0).all())


# --------------------------------------------------------------------------
# K~ v over the valid slots alone: the kernel's walk with the sketch's
# nblocks, emulated in float32 torch
# --------------------------------------------------------------------------


def _lane_sums(rows, w):
    """Each tile row of ``rows`` (R, Bk) against the staged v block ``w``
    as a warp sums it: lane l adds its columns' products in order (4l..4l+3
    at Bk = 128, else l, l + 32, ...), then the fixed butterfly over the 32
    lanes; float32, an FMA as a product and a sum."""
    nrows, bk = rows.shape
    prod = rows * w
    lanes = torch.zeros((nrows, 32), dtype=torch.float32)
    for lane in range(32):
        cols = range(4 * lane, 4 * lane + 4) if bk == 128 else range(lane, bk, 32)
        for j, col in enumerate(cols):
            lanes[:, lane] = prod[:, col] if (bk == 128 and j == 0) else lanes[:, lane] + prod[:, col]
    idx = torch.arange(32)
    for offset in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ offset]
    return lanes[:, 0]


def _emulated_matvec(vals, col_idx, v, *, row_ptr=None, nblocks=None, row_blocks_per_sketch=None):
    """``K~ v`` as the kernels walk it: for each output row-block, its ELL
    rows in order and in each every slot (``nblocks`` None) or the valid
    ones alone, one tile's `_lane_sums` against the staged v block added to
    the row's sum slot by slot (a warp's share of rows does not enter a
    row's sum); row-block r reads sketch r // ``row_blocks_per_sketch``'s
    part of ``v``. The valid walk makes every row of a row-block with
    padding NaN where that sketch's v block 0 holds an inf or a NaN, as the
    padding's 0 * inf makes the walk over every slot. On the card the valid
    walk is ``block_ell_bk128_valid`` (the row layout); other layouts walk
    every slot, which the tests show gives the same sums."""
    ell_rows, maxb, bk, _ = vals.shape
    nrb = ell_rows if row_ptr is None else len(row_ptr) - 1
    per_sketch = row_blocks_per_sketch or nrb
    vb = v.to(torch.float32).reshape(-1, bk)
    ncb = vb.shape[0] // -(-nrb // per_sketch)
    out = torch.empty((nrb, bk), dtype=torch.float32)
    for r in range(nrb):
        e0, e1 = (r, r + 1) if row_ptr is None else (int(row_ptr[r]), int(row_ptr[r + 1]))
        block0 = (r // per_sketch) * ncb
        acc = torch.zeros(bk, dtype=torch.float32)
        padded = False
        for e in range(e0, e1):
            count = maxb if nblocks is None else int(nblocks[e])
            padded |= count < maxb
            for k in range(count):
                acc = acc + _lane_sums(vals[e, k].to(torch.float32), vb[block0 + int(col_idx[e, k])])
        if nblocks is not None and padded and not bool(torch.isfinite(vb[block0]).all()):
            acc = torch.full_like(acc, math.nan)
        out[r] = acc
    return out.reshape(-1)


def _padded_layout(bk, maxb, ell_rows, ncb, seed, nblocks=None):
    """Ragged valid counts (some 0, one full) with zero tiles and column id
    0 past them, distinct column ids in a row, and v from N(0, 1), so that
    padding terms are +0 and -0."""
    rng = np.random.default_rng(seed)
    if nblocks is None:
        nblocks = rng.integers(0, maxb + 1, ell_rows)
        nblocks[:2] = (0, maxb)
    nblocks = np.asarray(nblocks, np.int32)
    valid = np.arange(maxb)[None, :] < nblocks[:, None]
    col_idx = np.stack([rng.permutation(ncb)[:maxb] for _ in range(ell_rows)])
    col_idx = np.where(valid, col_idx, 0).astype(np.int32)
    vals = np.where(valid[:, :, None, None], rng.standard_normal((ell_rows, maxb, bk, bk)), 0.0).astype(np.float32)
    return vals, col_idx, nblocks


@pytest.mark.parametrize("bk", [8, 128])
def test_valid_slot_walk_is_bitwise_the_all_slot_walk(bk):
    """Finite v: skipping the padding slots (rows with 0 valid slots among
    them) leaves every sum's bits, and both walks agree with the plain
    version at the kernel tolerance."""
    maxb, nrb, ncb = 4, 7, 6
    vals, col_idx, nblocks = _padded_layout(bk, maxb, nrb, ncb, seed=bk)
    v = np.random.default_rng(bk + 1).standard_normal(ncb * bk).astype(np.float32)
    tv, tci, tnb, tvec = _t(vals, col_idx, nblocks, v)
    every = _emulated_matvec(tv, tci, tvec)
    valid = _emulated_matvec(tv, tci, tvec, nblocks=tnb)
    assert torch.equal(valid, every) and bool((valid[:bk] == 0).all())
    assert torch.equal(torch.signbit(valid), torch.signbit(every))
    plain = ref.block_ell_matvec_ref(tv, tci, tvec.reshape(-1, bk)).reshape(-1)
    torch.testing.assert_close(valid, plain, **KERNEL_TOL)


def test_valid_slot_walk_on_a_row_ptr_layout():
    """Row-blocks of several ELL rows (one of none), padding in the last ELL
    row of each, as the transposed layout lays them out."""
    bk, maxb, ncb = 16, 3, 5
    per_row = [2, 0, 1, 3]
    counts = [maxb, 1, 2, maxb, maxb, 0]  # the last ELL row of each row-block padded
    vals, col_idx, nblocks = _padded_layout(bk, maxb, sum(per_row), ncb, seed=3, nblocks=counts)
    row_ptr = torch.tensor(np.concatenate([[0], np.cumsum(per_row)]), dtype=torch.int32)
    v = np.random.default_rng(4).standard_normal(ncb * bk).astype(np.float32)
    tv, tci, tnb, tvec = _t(vals, col_idx, nblocks, v)
    every = _emulated_matvec(tv, tci, tvec, row_ptr=row_ptr)
    valid = _emulated_matvec(tv, tci, tvec, row_ptr=row_ptr, nblocks=tnb)
    assert torch.equal(valid, every)
    plain = ref.block_ell_matvec_ref(tv, tci, tvec.reshape(-1, bk), row_ptr).reshape(-1)
    torch.testing.assert_close(valid, plain, **KERNEL_TOL)
    assert bool((valid[bk:2 * bk] == 0).all())  # the row-block of no ELL row


def test_valid_slot_walk_on_two_folded_sketches():
    """Two sketches folded into the row-block axis (the batched launch),
    each reading its own part of v, with its own v block 0."""
    bk, maxb, nrb, ncb = 8, 3, 4, 4
    sketches = [_padded_layout(bk, maxb, nrb, ncb, seed=10 + i) for i in range(2)]
    vals, col_idx, nblocks = (np.concatenate(parts) for parts in zip(*sketches))
    v = np.random.default_rng(12).standard_normal((2, ncb * bk)).astype(np.float32)
    tv, tci, tnb, tvec = _t(vals, col_idx, nblocks, v.reshape(-1))
    every = _emulated_matvec(tv, tci, tvec, row_blocks_per_sketch=nrb)
    valid = _emulated_matvec(tv, tci, tvec, nblocks=tnb, row_blocks_per_sketch=nrb)
    assert torch.equal(valid, every)
    plain = torch.cat([ref.block_ell_matvec_ref(*_t(vals[i * nrb:(i + 1) * nrb], col_idx[i * nrb:(i + 1) * nrb],
                                                    v[i].reshape(-1, bk))).reshape(-1) for i in range(2)])
    torch.testing.assert_close(valid, plain, **KERNEL_TOL)


@pytest.mark.parametrize("bad", [math.inf, -math.inf, math.nan])
@pytest.mark.parametrize("folded", [False, True], ids=["one", "folded"])
def test_valid_slot_walk_gives_nan_where_padding_meets_a_nonfinite_block0(bad, folded):
    """v block 0 holding an inf (or a NaN): the all-slot walk and the plain
    version add 0 * inf in every row of a row-block with padding; the valid
    walk gives NaN in exactly those rows too (and in the second folded
    sketch, whose block 0 is finite, nowhere it would not)."""
    bk, maxb, nrb, ncb = 8, 3, 5, 4
    sketches = [_padded_layout(bk, maxb, nrb, ncb, seed=20 + i) for i in range(2 if folded else 1)]
    vals, col_idx, nblocks = (np.concatenate(parts) for parts in zip(*sketches))
    v = np.random.default_rng(22).standard_normal((len(sketches), ncb * bk)).astype(np.float32)
    v[0, 3] = bad
    tv, tci, tnb, tvec = _t(vals, col_idx, nblocks, v.reshape(-1))
    every = _emulated_matvec(tv, tci, tvec, row_blocks_per_sketch=nrb)
    valid = _emulated_matvec(tv, tci, tvec, nblocks=tnb, row_blocks_per_sketch=nrb)
    plain = torch.cat([ref.block_ell_matvec_ref(*_t(vals[i * nrb:(i + 1) * nrb], col_idx[i * nrb:(i + 1) * nrb],
                                                    v[i].reshape(-1, bk))).reshape(-1) for i in range(len(sketches))])
    padded = np.repeat(nblocks < maxb, bk)
    first = torch.as_tensor(padded[:nrb * bk])
    assert bool(first.any()) and bool(torch.isnan(valid[:nrb * bk][first]).all())
    assert torch.equal(torch.isnan(valid), torch.isnan(every))
    assert torch.equal(torch.isnan(valid), torch.isnan(plain))
    finite = ~torch.isnan(every)
    assert torch.equal(valid[finite], every[finite])


def test_cuda_sketch_layout_check_refuses_what_the_valid_walk_cannot_skip():
    """The check a CUDA sketch gets once (`sparsify._check_padding`): the
    sampler's layouts pass; a count out of range, a nonzero padding tile or
    a padding column id other than 0 raises."""
    n, bk, K, tp, _ = _wfr_case()
    uniforms = jax.random.uniform(jax.random.PRNGKey(3), tp.shape, dtype=tp.dtype)
    sk = tsp.sparsify_block_ell_from_uniforms(*_t(uniforms, K, tp), float(n * 8), bk, 4)
    for lay in (sk, sk.transposed):
        tsp._check_padding(lay, lay.vals.to(torch.float32))
    row = int(torch.nonzero(sk.nblocks < sk.max_blocks)[0])
    for field, change in (("nblocks", lambda t: t.fill_(sk.max_blocks + 1)), ("nblocks", lambda t: t.fill_(-1)),
                          ("vals", lambda t: t[row, -1, 0, 0].fill_(1.0)),
                          ("col_idx", lambda t: t[row, -1].fill_(1))):
        bad = sk._replace(**{field: change(getattr(sk, field).clone())})
        with pytest.raises(IndexError):
            tsp._check_padding(bad, bad.vals.to(torch.float32))
