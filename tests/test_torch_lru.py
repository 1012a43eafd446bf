"""Port parity: the linear-recurrence scan ``lru_scan`` (kernel B5's
wrapper) and its plain version, held against the JAX package on the same
numpy inputs.

* ``ops.lru_scan`` on CPU tensors (the plain doubling scan) against the
  reference's ``repro.kernels.ops.lru_scan`` (the Pallas kernel, in
  interpret mode on the CPU) and its ``repro.kernels.ref.lru_scan_ref``
  (``jax.lax.associative_scan``), at the shapes and inputs of
  ``tests/test_kernels.py::test_lru_scan_kernel_sweep``: rtol = atol = 1e-5,
  the reference's own tolerance (float32 sums in different orders).
* The doubling `linear_scan` against a float64 sequential loop.
* The gradient of ``ops.lru_scan`` (a `torch.autograd.Function` whose
  backward is kernel B6 on CUDA and `lru_scan_bwd_ref` on the CPU) against
  ``jax.grad`` of the reference's ``ops.lru_scan`` (its custom VJP over the
  backward Pallas kernel, in interpret mode) and against the reference's
  ``ref.lru_scan_bwd_ref``, at the same shapes: rtol = atol = 1e-4, the
  reference test's tolerance for the gradients.
* `lru_scan_bwd_ref` against a float64 reverse loop.
* The wrapper's refusals: shapes, dtypes, contiguity and devices.
* The CUDA forward's chunked arithmetic (each chunk's product and end
  state, the inclusive carry of the chunk before it in chunk order, each
  chunk re-run from its carry), emulated in float32 torch with the chunk
  rule and constants read from ``csrc/lru_scan.cu``, against `lru_scan_ref` and the reference's
  Pallas kernel in interpret mode: rtol = atol = 1e-5, the reference
  test's tolerance (float32 sums in another order).
* The CUDA backward's chunked reverse arithmetic (each chunk's product of
  the shifted a and its lam from 0, the carries in reverse chunk order, the
  re-scan writing db and da), emulated the same way with the backward's
  chunk rule (its own longest chunk, read from the source), against
  ``jax.vjp`` of the reference's ``ops.lru_scan`` in interpret
  mode and `lru_scan_bwd_ref`: rtol = atol = 1e-5; with da not wanted, db
  keeps its bits.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers, and
# torch's default of one thread a core would put 48 threads on 8 cores
torch.set_num_threads(1)

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import library, ops
from repro_torch.kernels.ops import lru_scan
from repro_torch.kernels.ref import linear_scan, lru_scan_bwd_ref, lru_scan_ref

SHAPES = [(2, 64, 32), (1, 300, 130), (2, 512, 256)]  # tests/test_kernels.py
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_kernels.py:120-121


def _inputs(shape, seed):
    """a in U(0.7, 0.999) and b = 0.1 N(0, 1), as the reference test draws them."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, shape).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return a, b


def _sequential64(a, b, dim):
    a, b = np.moveaxis(np.asarray(a, np.float64), dim, 0), np.moveaxis(np.asarray(b, np.float64), dim, 0)
    h, p = np.zeros_like(b), np.zeros_like(a)
    h_prev, p_prev = np.zeros_like(b[0]), np.ones_like(a[0])
    for t in range(a.shape[0]):
        h_prev = a[t] * h_prev + b[t]
        p_prev = p_prev * a[t]
        h[t], p[t] = h_prev, p_prev
    return np.moveaxis(p, 0, dim), np.moveaxis(h, 0, dim)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("reference", ["pallas_interpret", "associative_scan"])
def test_lru_scan_matches_the_reference(shape, reference):
    a, b = _inputs(shape, sum(shape))
    if reference == "pallas_interpret":
        want = np.asarray(jops.lru_scan(jnp.asarray(a), jnp.asarray(b)))
    else:
        want = np.asarray(jref.lru_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    before = dict(ops.LAUNCHES)
    got = lru_scan(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert ops.LAUNCHES == before  # CPU tensors run the plain version: no launch


@pytest.mark.parametrize("length", [1, 2, 3, 17, 64, 300])
@pytest.mark.parametrize("dim", [1, 2])
def test_linear_scan_matches_a_sequential_float64_loop(length, dim):
    shape = (2, length, 5) if dim == 1 else (2, 3, length, 5)
    a, b = _inputs(shape, length)
    p_want, h_want = _sequential64(a, b, dim)
    p_got, h_got = linear_scan(torch.as_tensor(a), torch.as_tensor(b), dim)
    np.testing.assert_allclose(h_got.numpy(), h_want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p_got.numpy(), p_want, rtol=1e-5, atol=1e-30)


def test_lru_scan_ref_is_the_recurrence_in_float64_up_to_float32_rounding():
    a, b = _inputs((1, 2048, 3), 0)
    _, h_want = _sequential64(a, b, 1)
    got = lru_scan_ref(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), h_want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("reference", ["pallas_interpret_vjp", "lru_scan_bwd_ref"])
def test_lru_scan_gradient_matches_the_reference(shape, reference):
    a, b = _inputs(shape, sum(shape))
    g = np.random.default_rng(sum(shape) + 1).standard_normal(shape).astype(np.float32)
    if reference == "pallas_interpret_vjp":
        da_want, db_want = jax.grad(lambda x, y: jnp.vdot(jops.lru_scan(x, y), jnp.asarray(g)), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    else:
        h = jref.lru_scan_ref(jnp.asarray(a), jnp.asarray(b))
        da_want, db_want = jref.lru_scan_bwd_ref(jnp.asarray(a), h, jnp.asarray(g))
    at = torch.as_tensor(a).requires_grad_()
    bt = torch.as_tensor(b).requires_grad_()
    before = dict(ops.LAUNCHES)
    torch.sum(lru_scan(at, bt) * torch.as_tensor(g)).backward()
    assert ops.LAUNCHES == before  # CPU tensors: the plain versions, both ways
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(da_want), **GRAD_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_want), **GRAD_TOL)


@pytest.mark.parametrize("length", [1, 2, 33, 300])
def test_lru_scan_bwd_ref_is_the_reverse_recurrence_in_float64(length):
    a, b = _inputs((2, length, 5), length)
    g = np.random.default_rng(length).standard_normal((2, length, 5)).astype(np.float32)
    _, h = _sequential64(a, b, 1)
    lam = np.zeros_like(h)
    nxt = np.zeros_like(h[:, 0])
    a64 = np.asarray(a, np.float64)
    for t in range(length - 1, -1, -1):
        nxt = g[:, t] + (a64[:, t + 1] * nxt if t + 1 < length else 0.0)
        lam[:, t] = nxt
    h_prev = np.concatenate([np.zeros_like(h[:, :1]), h[:, :-1]], axis=1)
    da, db = lru_scan_bwd_ref(torch.as_tensor(a), torch.as_tensor(h, dtype=torch.float32), torch.as_tensor(g))
    np.testing.assert_allclose(db.numpy(), lam, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(da.numpy(), lam * h_prev, rtol=1e-5, atol=1e-5)


def test_lru_scan_takes_inputs_that_require_grad():
    """Gradients flow to a and b, and only to the inputs that want one."""
    a, b = (torch.as_tensor(x) for x in _inputs((2, 8, 4), 0))
    g = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 8, 4)).astype(np.float32))
    ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
    h = lru_scan(ag, bg)
    assert h.requires_grad
    torch.testing.assert_close(h.detach(), lru_scan(a, b), rtol=0, atol=0)
    torch.sum(h * g).backward()
    da, db = lru_scan_bwd_ref(a, lru_scan_ref(a, b), g)
    torch.testing.assert_close(ag.grad, da, rtol=0, atol=0)
    torch.testing.assert_close(bg.grad, db, rtol=0, atol=0)
    bg2 = b.clone().requires_grad_()
    torch.sum(lru_scan(a, bg2) * g).backward()
    torch.testing.assert_close(bg2.grad, db, rtol=0, atol=0)


def _bad_cases():
    a = torch.rand(2, 8, 4)
    return {
        "shape_mismatch": ((a, torch.rand(2, 8, 5)), ValueError),
        "not_3d": ((a[0], a[0]), ValueError),
        "float64": ((a.double(), a.double()), TypeError),
        "bfloat16": ((a.bfloat16(), a), TypeError),
        "int": ((a.int(), a.int()), TypeError),
        "non_contiguous": ((a.transpose(1, 2).contiguous().transpose(1, 2), a), ValueError),
        "mixed_devices": ((a, torch.empty(2, 8, 4, device="meta")), ValueError),
        "meta_device": ((torch.empty(2, 8, 4, device="meta"),) * 2, ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_cases()))
def test_lru_scan_refuses_bad_inputs(case):
    args, error = _bad_cases()[case]
    before = dict(ops.LAUNCHES)
    with pytest.raises(error):
        lru_scan(*args)
    assert ops.LAUNCHES == before


def test_lru_scan_takes_empty_sequences():
    out = lru_scan(torch.empty(2, 0, 4), torch.empty(2, 0, 4))
    assert tuple(out.shape) == (2, 0, 4)


# --- the CUDA forward's chunked arithmetic, emulated in float32 torch --------


def _source_constants() -> dict[str, int]:
    text = (library.CSRC / "lru_scan.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
            for name in ("kMaxChunk", "kBwdMaxChunk", "kMinChunk", "kTargetWarps")}


def _chunk_length(batch, seq, width, backward=False):
    """lru_scan_chunk of the source (lru_scan_bwd_chunk with ``backward``):
    the longest power of two from kMaxChunk (kBwdMaxChunk) down to
    kMinChunk at which batch * ceil(width / 32) * ceil(seq / L) warps reach
    kTargetWarps."""
    k = _source_constants()
    groups = batch * -(-width // 32)
    chunk = k["kBwdMaxChunk" if backward else "kMaxChunk"]
    while chunk > k["kMinChunk"] and groups * -(-seq // chunk) < k["kTargetWarps"]:
        chunk //= 2
    return chunk


def _emulated_chunked_scan(a, b, chunk):
    """The forward launch's arithmetic: for each chunk the product A_c of a
    and the end state H_c from 0, in step order; the inclusive carries
    h_in(0) = 0, h_in(c+1) = A_c h_in(c) + H_c, in chunk order (a block
    reads the one its predecessor published); each chunk's recurrence from
    h_in(c). Float32, an FMA as a product and a sum."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    bsz, seq, width = a.shape
    chunks = -(-seq // chunk)
    spans = [(c * chunk, min((c + 1) * chunk, seq)) for c in range(chunks)]
    agg_a, agg_h = [], []
    for t0, t1 in spans[:-1]:
        prod, state = torch.ones(bsz, width), torch.zeros(bsz, width)
        for t in range(t0, t1):
            state = a[:, t] * state + b[:, t]
            prod = prod * a[:, t]
        agg_a.append(prod)
        agg_h.append(state)
    h_in = [torch.zeros(bsz, width)]
    for c in range(chunks - 1):
        h_in.append(agg_a[c] * h_in[c] + agg_h[c])
    h = torch.empty_like(a)
    for (t0, t1), state in zip(spans, h_in):
        for t in range(t0, t1):
            state = a[:, t] * state + b[:, t]
            h[:, t] = state
    return h


def test_chunk_rule_at_the_paths_shapes():
    """Chunks of 256 at the prefill shape (128 of them: 10,240 warps, where
    one thread a channel gave 80 warps) and at the train step's (8: 640
    warps); the reference test shapes and a short sequence get the
    shortest chunk."""
    assert _chunk_length(1, 32768, 2560) == 256
    assert _chunk_length(1, 2048, 2560) == 256
    k = _source_constants()
    assert all(_chunk_length(*shape) == k["kMinChunk"] for shape in SHAPES + [(2, 20, 40)])
    assert k["kMaxChunk"] % k["kMinChunk"] == 0


@pytest.mark.parametrize("shape", SHAPES + [(2, 20, 40)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("chunk", ["rule", 64])
def test_chunked_forward_arithmetic_matches_the_reference(shape, chunk):
    """At the reference test's shapes (300 steps: 9 chunks of 32 and one of
    12), at S = 20 < the chunk (one chunk, no carry), and with a chunk of 64
    (300 = 4 x 64 + 44). The reference is its ``ops.lru_scan``, which pads
    to whole tiles and runs ``lru_scan_fwd_call`` in interpret mode."""
    a, b = _inputs(shape, sum(shape) + 7)
    length = _chunk_length(*shape) if chunk == "rule" else chunk
    got = _emulated_chunked_scan(a, b, length)
    torch.testing.assert_close(got, lru_scan_ref(torch.as_tensor(a), torch.as_tensor(b)), **TOL)
    want = np.asarray(jops.lru_scan(jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_chunked_forward_arithmetic_over_64_chunks():
    """64 chunks of 32 on a narrow width, against the float64 recurrence."""
    a, b = _inputs((1, 2048, 8), 11)
    got = _emulated_chunked_scan(a, b, 32)
    _, h_want = _sequential64(a, b, 1)
    np.testing.assert_allclose(got.numpy(), h_want, **TOL)


# --- the CUDA backward's chunked reverse arithmetic, emulated in float32 ----


def _emulated_chunked_bwd(a, h, g, chunk):
    """The backward launch's arithmetic: the shifted a_{t+1} (a_S = 0); for
    each chunk but the first, from its end, the product A_c of the shifted
    a and G_c, its lam_{t0} from 0; the inclusive carries lam_in(C-1) = 0,
    lam_in(c-1) = A_c lam_in(c) + G_c, in reverse chunk order (a block reads
    the one the block of the next chunk published); each chunk's reverse
    recurrence from lam_in(c), writing db = lam and da = lam h_{t-1}
    (h_{-1} = 0). ``h`` None: the gradient of a is not wanted, and h is not
    read. Float32, an FMA as a product and a sum."""
    a, g = torch.as_tensor(a), torch.as_tensor(g)
    bsz, seq, width = a.shape
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    chunks = -(-seq // chunk)
    spans = [(c * chunk, min((c + 1) * chunk, seq)) for c in range(chunks)]
    lam_in = {chunks - 1: torch.zeros(bsz, width)}
    for c in range(chunks - 1, 0, -1):
        prod, state = torch.ones(bsz, width), torch.zeros(bsz, width)
        t0, t1 = spans[c]
        for t in range(t1 - 1, t0 - 1, -1):
            state = a_next[:, t] * state + g[:, t]
            prod = prod * a_next[:, t]
        lam_in[c - 1] = prod * lam_in[c] + state
    db = torch.empty_like(a)
    da = None if h is None else torch.empty_like(a)
    for c, (t0, t1) in enumerate(spans):
        lam = lam_in[c]
        for t in range(t1 - 1, t0 - 1, -1):
            lam = a_next[:, t] * lam + g[:, t]
            db[:, t] = lam
            if da is not None:
                da[:, t] = lam * (torch.as_tensor(h)[:, t - 1] if t > 0 else 0.0)
    return da, db


# ragged S and W not a multiple of 32 (300 = 9 x 32 + 12 steps, 130 channels);
# S shorter than one chunk; the reference test's other shapes
BWD_SHAPES = [(1, 300, 130), (2, 20, 40), (2, 64, 32), (2, 512, 256)]


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("chunk", ["rule", 64])
def test_chunked_backward_arithmetic_matches_the_reference(shape, chunk):
    """The emulated reverse chunks against ``jax.vjp`` of the reference's
    ``ops.lru_scan`` (its custom VJP over the backward Pallas kernel in
    interpret mode) and against `lru_scan_bwd_ref`, at the reference test's
    forward tolerance; with the chunk rule's length (read from the source)
    and with chunks of 64."""
    a, b = _inputs(shape, sum(shape) + 3)
    g = np.random.default_rng(sum(shape) + 4).standard_normal(shape).astype(np.float32)
    length = _chunk_length(*shape, backward=True) if chunk == "rule" else chunk
    h = lru_scan_ref(torch.as_tensor(a), torch.as_tensor(b))
    da, db = _emulated_chunked_bwd(a, h, g, length)
    da_ref, db_ref = lru_scan_bwd_ref(torch.as_tensor(a), h, torch.as_tensor(g))
    torch.testing.assert_close(db, db_ref, **TOL)
    torch.testing.assert_close(da, da_ref, **TOL)
    _, vjp = jax.vjp(lambda x, y: jops.lru_scan(x, y, True), jnp.asarray(a), jnp.asarray(b))
    da_j, db_j = vjp(jnp.asarray(g))
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), **TOL)
    np.testing.assert_allclose(da.numpy(), np.asarray(da_j), **TOL)


def test_chunked_backward_arithmetic_over_64_chunks():
    """64 chunks of 32 on a narrow width: 63 carries in reverse chunk order,
    against the float64 reverse recurrence."""
    a, b = _inputs((1, 2048, 8), 12)
    g = np.random.default_rng(13).standard_normal((1, 2048, 8)).astype(np.float32)
    _, h64 = _sequential64(a, b, 1)
    da, db = _emulated_chunked_bwd(a, torch.as_tensor(h64, dtype=torch.float32), g, 32)
    a64 = np.asarray(a, np.float64)
    lam = np.zeros_like(h64)
    nxt = np.zeros_like(h64[:, 0])
    for t in range(2047, -1, -1):
        nxt = g[:, t] + (a64[:, t + 1] * nxt if t + 1 < 2048 else 0.0)
        lam[:, t] = nxt
    h_prev = np.concatenate([np.zeros_like(h64[:, :1]), h64[:, :-1]], axis=1)
    np.testing.assert_allclose(db.numpy(), lam, **TOL)
    np.testing.assert_allclose(da.numpy(), lam * h_prev, **TOL)


def test_chunked_backward_without_da_gives_the_same_db():
    """da not wanted (h not read): db keeps its bits, and it matches the
    reference's gradient of b."""
    shape = (1, 300, 130)
    a, b = _inputs(shape, 21)
    g = np.random.default_rng(22).standard_normal(shape).astype(np.float32)
    h = lru_scan_ref(torch.as_tensor(a), torch.as_tensor(b))
    length = _chunk_length(*shape, backward=True)
    da_none, db_alone = _emulated_chunked_bwd(a, None, g, length)
    _, db = _emulated_chunked_bwd(a, h, g, length)
    assert da_none is None and torch.equal(db_alone, db)
    _, vjp = jax.vjp(lambda y: jops.lru_scan(jnp.asarray(a), y, True), jnp.asarray(b))
    np.testing.assert_allclose(db_alone.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **TOL)


def test_backward_chunk_rule_at_the_paths_shapes():
    """The backward's chunks are shorter: 128 steps at the train step's
    shape (16 of them: 1,280 warps) and at the prefill's (256), half the
    forward's shared memory a warp; the reference test shapes get the
    shortest chunk. Its launch takes a chunk and a scratch as the
    forward's does."""
    k = _source_constants()
    assert _chunk_length(1, 2048, 2560, backward=True) == 128
    assert _chunk_length(1, 32768, 2560, backward=True) == 128
    assert k["kMinChunk"] <= k["kBwdMaxChunk"] < k["kMaxChunk"] and k["kBwdMaxChunk"] % k["kMinChunk"] == 0
    assert all(_chunk_length(*shape, backward=True) == k["kMinChunk"] for shape in SHAPES + [(2, 20, 40)])
    text = (library.CSRC / "lru_scan.cu").read_text()
    assert "int64_t lru_scan_bwd_chunk(int64_t batch, int64_t seq, int64_t width)" in text
    assert library.SIGNATURES["lru_scan_bwd"][-3:] == library.SIGNATURES["lru_scan_fwd"][-3:]
