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
* The wrapper's refusals: shapes, dtypes, contiguity, devices and inputs
  that require grad (the backward, kernel B6, is not ported yet).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.ops import lru_scan
from repro_torch.kernels.ref import linear_scan, lru_scan_ref

SHAPES = [(2, 64, 32), (1, 300, 130), (2, 512, 256)]  # tests/test_kernels.py
TOL = dict(rtol=1e-5, atol=1e-5)


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
        "requires_grad": ((a.clone().requires_grad_(), a), NotImplementedError),
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
