"""Build the port's objects from numpy arrays.

This system runs no model: what carries over from the JAX package is
problem data and sketches. A caller (the parity tests, for one) exports
those as numpy arrays and rebuilds them here, so both packages can run the
same problem on the same sketch.
"""
from __future__ import annotations


import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.api.geometry import PointCloudGeometry
from repro_torch.core.api.problems import OTProblem, UOTProblem
from repro_torch.core.sparsify import (
    BlockEllKernel,
    LogSparseKernelCOO,
    SparseKernelCOO,
    _with_float32,
)

__all__ = ["block_ell_sketch_from_numpy", "problem_from_numpy", "sketch_from_numpy"]


def problem_from_numpy(
    x,
    a,
    b,
    eps: float,
    *,
    y=None,
    lam: float | None = None,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
    device=None,
) -> OTProblem:
    """An `OTProblem` (``lam=None``) or `UOTProblem` over a
    `PointCloudGeometry` of points ``x`` (and ``y``), on ``device``
    (``None`` means ``"cuda"``)."""
    dev = resolve_device(device)
    geom = PointCloudGeometry(np.asarray(x), None if y is None else np.asarray(y),
                              cost=cost, eta=eta, device=dev)
    if lam is None:
        return OTProblem(geom, np.asarray(a), np.asarray(b), float(eps))
    return UOTProblem(geom, np.asarray(a), np.asarray(b), float(eps), lam=float(lam))


def sketch_from_numpy(
    rows,
    cols,
    nnz,
    n: int,
    m: int,
    *,
    vals=None,
    logvals=None,
    csort=None,
    overflowed=False,
    n_proposed=None,
    n_accepted=None,
    device=None,
) -> SparseKernelCOO | LogSparseKernelCOO:
    """A `SparseKernelCOO` (given ``vals``) or `LogSparseKernelCOO` (given
    ``logvals``) on ``device`` from the arrays of a row-sorted sketch.
    Indices become int64; ``csort`` defaults to the stable column sort."""
    if (vals is None) == (logvals is None):
        raise TypeError("pass exactly one of vals= or logvals=")
    dev = resolve_device(device)
    rows_t = torch.tensor(np.asarray(rows, np.int64), device=dev)
    cols_t = torch.tensor(np.asarray(cols, np.int64), device=dev)
    if rows_t.ndim != 1 or rows_t.shape != cols_t.shape:
        raise ValueError("rows and cols must be equal-length 1-d arrays")
    if bool(torch.any(rows_t[1:] < rows_t[:-1])):
        raise ValueError("the sketch's rows must be sorted ascending")
    if csort is None:
        csort_t = torch.argsort(cols_t, stable=True)
    else:
        csort_t = torch.tensor(np.asarray(csort, np.int64), device=dev)

    def scalar(v, dtype):
        return None if v is None else torch.tensor(np.asarray(v), dtype=dtype, device=dev)

    w = torch.tensor(np.asarray(vals if logvals is None else logvals), device=dev)
    cls = SparseKernelCOO if logvals is None else LogSparseKernelCOO
    return cls(
        rows_t, cols_t, w, scalar(nnz, torch.int64), int(n), int(m),
        csort=csort_t,
        overflowed=scalar(overflowed, torch.bool),
        n_proposed=scalar(n_proposed, torch.int64),
        n_accepted=scalar(n_accepted, torch.int64),
    )


def _valid_pairs(vals, col_idx, nblocks) -> set[tuple[int, int]]:
    valid = np.arange(vals.shape[1])[None, :] < np.asarray(nblocks)[:, None]
    rows = np.nonzero(valid)[0]
    return set(zip(rows.tolist(), np.asarray(col_idx)[valid].tolist()))


def block_ell_sketch_from_numpy(
    vals,
    col_idx,
    nblocks,
    n: int,
    m: int,
    *,
    vals_t,
    col_idx_t,
    nblocks_t,
    device=None,
) -> BlockEllKernel:
    """A `BlockEllKernel` with its transposed layout on ``device`` from the
    arrays of the reference's ``sparsify_block_ell_pair`` (row layout, then
    the ``*_t`` transposed one). The transposed layout must hold exactly
    the row layout's tiles (it does unless a column-block overflowed the
    reference's ``max_blocks``), else `ValueError`. Column ids become int32;
    on CUDA the float32 tiles of the kernel are made here."""
    if _valid_pairs(vals, col_idx, nblocks) != {
        (r, c) for c, r in _valid_pairs(vals_t, col_idx_t, nblocks_t)
    }:
        raise ValueError(
            "the transposed layout does not hold the row layout's tiles (a "
            "column-block overflowed max_blocks); K~^T u would not be the transpose"
        )
    dev = resolve_device(device)

    def layout(v, ci, nb, rows, cols, transposed=None):
        return _with_float32(BlockEllKernel(
            torch.tensor(np.asarray(v), device=dev),
            torch.tensor(np.asarray(ci, np.int32), device=dev),
            torch.tensor(np.asarray(nb, np.int32), device=dev),
            int(rows), int(cols), transposed=transposed,
        ))

    return layout(vals, col_idx, nblocks, n, m, layout(vals_t, col_idx_t, nblocks_t, m, n))
