"""Build the port's objects from numpy arrays.

What carries over from the JAX package is problem data, sketches, LM
parameters and training states. A caller (the parity tests, for one) exports those as numpy
arrays and rebuilds them here, so both packages can run the same problem
on the same sketch, or the same model on the same weights.
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
    _for_cuda,
)
from repro_torch.models.layers import torch_dtype
from repro_torch.models.lm import init_params
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.step import TrainState

__all__ = [
    "block_ell_sketch_from_numpy",
    "lm_params_from_numpy",
    "problem_from_numpy",
    "sketch_from_numpy",
    "train_state_from_numpy",
]


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
    on CUDA the row layout's float32 tiles and column lists, which the
    kernels read, are made, and the sketch is checked, here."""
    if _valid_pairs(vals, col_idx, nblocks) != {
        (r, c) for c, r in _valid_pairs(vals_t, col_idx_t, nblocks_t)
    }:
        raise ValueError(
            "the transposed layout does not hold the row layout's tiles (a "
            "column-block overflowed max_blocks); K~^T u would not be the transpose"
        )
    dev = resolve_device(device)

    def layout(v, ci, nb, rows, cols, transposed=None):
        return BlockEllKernel(
            torch.tensor(np.asarray(v), device=dev),
            torch.tensor(np.asarray(ci, np.int32), device=dev),
            torch.tensor(np.asarray(nb, np.int32), device=dev),
            int(rows), int(cols), transposed=transposed,
        )

    return _for_cuda(layout(vals, col_idx, nblocks, n, m, layout(vals_t, col_idx_t, nblocks_t, m, n)))


def _unstack(tree, n: int, path: str) -> list:
    """A tree whose leaves have a leading layer axis of ``n`` as ``n``
    trees, one a layer (the reference's ``vmap``-stacked blocks)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n, f"{path}/{k}") for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    arr = np.asarray(tree)
    if arr.ndim == 0 or arr.shape[0] != n:
        raise ValueError(f"{path}: shape {tuple(arr.shape)}, expected a leading layer axis of {n}")
    return list(arr)


def _unstacked(tree, cfg) -> dict:
    """The reference's parameter tree with its stacked blocks split into
    the port's lists: ``blocks`` on the layer axis (dense, moe, ssm,
    audio), on the group then the layer-in-group axis (vlm), beside
    ``cross_blocks`` (vlm) and ``encoder`` (audio). A tree whose blocks
    are not a dict (the hybrid family's list, or a malformed tree) is
    left for the key and shape checks."""
    if not isinstance(tree, dict) or not isinstance(tree.get("blocks"), dict):
        return tree
    fam = cfg.family
    out = dict(tree)
    if fam in ("dense", "moe", "ssm", "audio"):
        out["blocks"] = _unstack(tree["blocks"], cfg.num_layers, "params/blocks")
    if fam == "vlm":
        n_groups = cfg.num_layers // cfg.cross_attn_period
        groups = _unstack(tree["blocks"], n_groups, "params/blocks")
        out["blocks"] = [_unstack(g, cfg.cross_attn_period - 1, f"params/blocks[{i}]") for i, g in enumerate(groups)]
        if isinstance(tree.get("cross_blocks"), dict):
            out["cross_blocks"] = _unstack(tree["cross_blocks"], n_groups, "params/cross_blocks")
    if fam == "audio" and isinstance(tree.get("encoder"), dict):
        out["encoder"] = _unstack(tree["encoder"], cfg.encoder_layers, "params/encoder")
    return out


def lm_params_from_numpy(tree, cfg, device=None):
    """The port's LM parameters from the reference's parameter pytree with
    numpy leaves (``jax.tree.map(np.asarray, params)``), each leaf as a
    ``cfg.param_dtype`` tensor on ``device`` (``None`` means ``"cuda"``).
    The hybrid family's blocks are a list of RG-LRU and attention dicts in
    both packages; the other families' are dicts whose leaves are stacked
    along leading layer axes (two in the vlm family's ``blocks``), which
    are split into the port's lists (`_unstacked`). Every key and shape is
    checked against the port's own layout for ``cfg``; a missing or extra
    key, a wrong block count, a wrong layer axis or a wrong shape raises
    `ValueError`."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def convert(expected, given, path):
        if isinstance(expected, torch.Tensor):
            arr = np.asarray(given)
            if tuple(arr.shape) != tuple(expected.shape):
                raise ValueError(f"{path}: shape {tuple(arr.shape)}, expected {tuple(expected.shape)}")
            return torch.tensor(arr, dtype=dtype, device=dev)
        if isinstance(expected, dict):
            if not isinstance(given, dict) or set(given) != set(expected):
                got = sorted(given) if isinstance(given, dict) else type(given).__name__
                raise ValueError(f"{path}: keys {got}, expected {sorted(expected)}")
            return {k: convert(expected[k], given[k], f"{path}/{k}") for k in expected}
        if not isinstance(given, (list, tuple)) or len(given) != len(expected):
            got = len(given) if isinstance(given, (list, tuple)) else type(given).__name__
            raise ValueError(f"{path}: {got} entries, expected a list of {len(expected)}")
        return [convert(e, g, f"{path}[{i}]") for i, (e, g) in enumerate(zip(expected, given))]

    return convert(init_params(cfg, device="meta"), _unstacked(tree, cfg), "params")


def train_state_from_numpy(tree, cfg, tcfg, device=None) -> TrainState:
    """The port's `TrainState` from the reference's ``TrainState`` with numpy
    leaves (``jax.tree.map(np.asarray, state)``): ``(params, (step, m, v),
    ef)``. ``params`` go through `lm_params_from_numpy`; ``m``, ``v`` and
    ``ef`` are checked key by key and shape by shape the same way and become
    float32; ``step`` an int32 scalar. ``ef`` must be present exactly when
    ``tcfg.grad_compression`` is on. A wrong tree raises `ValueError`."""
    dev = resolve_device(device)
    if not isinstance(tree, tuple) or len(tree) != 3 or not isinstance(tree[1], tuple) or len(tree[1]) != 3:
        raise ValueError("state: expected (params, (step, m, v), ef)")
    params, (step, m, v), ef = tree
    if (ef is not None) != bool(tcfg.grad_compression):
        raise ValueError(f"state.ef: {'residuals' if ef is not None else 'None'} given, but "
                         f"grad_compression is {tcfg.grad_compression}")
    step = np.asarray(step)
    if step.shape != () or step.dtype.kind not in "iu":
        raise ValueError(f"state.opt.step: expected an integer scalar, got {step.dtype} {step.shape}")
    f32 = cfg.replace(param_dtype="float32")
    return TrainState(
        lm_params_from_numpy(params, cfg, dev),
        AdamWState(torch.tensor(int(step), dtype=torch.int32, device=dev),
                   lm_params_from_numpy(m, f32, dev), lm_params_from_numpy(v, f32, dev)),
        None if ef is None else lm_params_from_numpy(ef, f32, dev),
    )
