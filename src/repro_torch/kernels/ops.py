"""Wrappers around the port's hand-written kernels.

A wrapper checks what it is given, launches its kernel on PyTorch's current
stream for CUDA tensors, and counts the launch (`LAUNCHES`). For CPU tensors
it runs the kernel's plain version (`repro_torch.kernels.ref`; that of
`bind_coo_gather_logsumexp` sits beside it, a composition of this module's
reductions); nothing else selects the plain version, and a failed build or
launch raises.

The reference's TPU tiling arguments (``block_n``, ``block_m``, ``block_s``)
and ``interpret`` are not carried over, nor is its padding of the inputs to
whole tiles: the CUDA kernels size their own tiles and mask their edges,
and the CPU runs the plain versions.

The kernels on the sharded paths (`lru_scan`, B5 and B6;
`gathered_sketch_kernel` and `gathered_sketch_cost`, B1) take DTensors
through `torch.distributed.tensor.experimental.local_map`, which declares
their placements and runs the kernel on each rank's local shard; plain
tensors pass through the same `local_map` unchanged. A DTensor placed
otherwise than the wrapper declares raises: no wrapper redistributes.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.core.sinkhorn import SinkhornResult, generic_scaling_loop
from repro_torch.kernels.block_ell import BlockEllColumns, _launch_block_ell_matvec, _launch_block_ell_rmatvec
from repro_torch.kernels.fused_sinkhorn import _launch_online_lse, _launch_online_matvec
from repro_torch.kernels.gather_kernel import _launch_gathered_cost, _launch_gathered_kernel
from repro_torch.kernels.library import COSTS, LAUNCHES, reset_launch_counts
from repro_torch.kernels.lru_scan import _launch_lru_scan_bwd, _launch_lru_scan_fwd
from repro_torch.kernels.ref import (
    block_ell_matvec_ref,
    gathered_cost_ref,
    gathered_kernel_ref,
    lru_scan_bwd_ref,
    lru_scan_ref,
    online_lse_ref,
    online_matvec_ref,
)
from repro_torch.kernels.segment_lse import segment_lse_launcher

__all__ = [
    "LAUNCHES",
    "batched_block_ell_matvec",
    "batched_coo_logsumexp",
    "batched_coo_matvec",
    "batched_coo_rmatvec",
    "block_ell_matvec",
    "block_ell_sketch_matvec",
    "block_ell_sketch_rmatvec",
    "bind_coo_gather_logsumexp",
    "coo_gather_logsumexp_ref",
    "fused_sinkhorn_solve",
    "gathered_cost",
    "gathered_kernel",
    "gathered_sketch_cost",
    "gathered_sketch_kernel",
    "lru_scan",
    "online_lse",
    "online_matvec",
    "reset_launch_counts",
]


def _check_cost(cost: str) -> None:
    if cost not in COSTS:
        raise ValueError(f"unknown cost {cost!r}; available: {', '.join(COSTS)}")


def _check_points(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"points must be (n, d) and (m, d); got {tuple(x.shape)}, {tuple(y.shape)}")
    if not (x.is_floating_point() and y.is_floating_point()):
        raise TypeError(f"points must be floating point; got {x.dtype}, {y.dtype}")


def _one_device(name: str, *tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device; got {sorted(map(str, devices))}")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {dev.type}")
    return dev


def _check_gather(name: str, x, y, rows, cols, cost: str) -> torch.device:
    """The checks of the public gathered wrappers; returns the device."""
    _check_cost(cost)
    _check_points(x, y)
    if rows.ndim != 1 or rows.shape != cols.shape:
        raise ValueError(f"{name}: rows/cols must be equal-length 1-d; got {tuple(rows.shape)}, {tuple(cols.shape)}")
    if rows.dtype != torch.int64 or cols.dtype != torch.int64:
        raise TypeError(f"{name}: rows/cols must be int64; got {rows.dtype}, {cols.dtype}")
    dev = _one_device(name, x, y, rows, cols)
    if dev.type == "cuda" and not (rows.is_contiguous() and cols.is_contiguous()):
        raise ValueError(f"{name}: rows/cols must be contiguous")
    return dev


def _gathered(launch, x, y, rows, cols, out_dtypes, checked: bool, **kw) -> list[torch.Tensor]:
    """One counted launch of a gathered kernel on CUDA tensors (none for
    k = 0): the points as the pack reads them, both float32 as they are or
    both float64 (another float type cast to it, exactly; y stays x where it
    is x), fresh outputs, and with ``checked`` the kernel's range flag, read
    after the launch (a host sync) to raise `IndexError`."""
    dtype = torch.float32 if x.dtype == y.dtype == torch.float32 else torch.float64
    xc = x.to(dtype).contiguous()
    yc = xc if y is x else y.to(dtype).contiguous()
    outs = [torch.empty(rows.shape[0], dtype=dt, device=x.device) for dt in out_dtypes]
    if rows.shape[0] == 0:
        return outs
    flag = torch.zeros(1, dtype=torch.int32, device=x.device) if checked else None
    launch(xc, yc, rows, cols, *outs, flag, **kw)
    # the kernel range-checks every index as it reads it (no extra pass)
    if checked and bool(flag):
        raise IndexError("rows/cols out of range of the point arrays")
    return outs


def gathered_kernel(
    x: torch.Tensor,
    y: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    *,
    eps: float,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(K_e, C_e) = (exp(-C(x_i,y_j)/eps), C(x_i,y_j))`` at k index pairs.

    Shapes ``(n,d),(m,d),(k,),(k,) -> ((k,),(k,))``, int64 indices, both
    outputs float32 (float32 arithmetic on the points rounded to float32).
    WFR pairs beyond range come out exactly ``(0, +inf)``. CUDA tensors go
    through the CUDA kernel (``csrc/gather_kernel.cu``), whose range flag is
    read after the launch: an index outside the points raises `IndexError`.
    CPU tensors go through `gathered_kernel_ref`.
    """
    dev = _check_gather("gathered_kernel", x, y, rows, cols, cost)
    if dev.type == "cpu":
        return gathered_kernel_ref(x, y, rows, cols, eps=eps, cost=cost, eta=eta)
    k_e, c_e = _gathered(_launch_gathered_kernel, x, y, rows, cols, (torch.float32, torch.float32), True,
                         eps=eps, cost=cost, eta=eta)
    return k_e, c_e


def gathered_cost(
    x: torch.Tensor,
    y: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    *,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
) -> torch.Tensor:
    """``C_e = C(x_i, y_j)`` at k index pairs in float64, the cost-only
    mode of the gathered kernel: ``(n,d),(m,d),(k,),(k,) -> (k,)``, int64
    indices, points of any float type (cast to float64, exactly). Blocked
    WFR pairs come out exactly ``+inf``. CUDA tensors go through the CUDA
    kernel, checked as `gathered_kernel`; CPU tensors through
    `gathered_cost_ref`.
    """
    dev = _check_gather("gathered_cost", x, y, rows, cols, cost)
    if dev.type == "cpu":
        return gathered_cost_ref(x, y, rows, cols, cost=cost, eta=eta)
    return _gathered(_launch_gathered_cost, x, y, rows, cols, (torch.float64,), True, cost=cost, eta=eta)[0]


def _placed(t):
    """A DTensor's placements as `local_map` takes one input's (a list:
    a tuple would read as one entry an output); None for a tensor."""
    return list(t.placements) if isinstance(t, DTensor) else None


def _pair_placements(name: str, x, y, rows, cols):
    """The placements of a gathered kernel's outputs under `local_map`:
    the points replicated, the pairs sharded along k (``Shard(0)``) or
    replicated, rows and cols alike; ``None`` for plain tensors. Anything
    else raises: no wrapper redistributes to make its kernel run."""
    dts = [isinstance(t, DTensor) for t in (x, y, rows, cols)]
    if not any(dts):
        return None
    if not all(dts):
        raise TypeError(f"{name}: pass the points and the pairs all as DTensors or all as tensors")
    for t, what in ((x, "x"), (y, "y")):
        if any(not isinstance(p, Replicate) for p in t.placements):
            raise ValueError(f"{name}: the points {what} must be replicated; got {t.placements}")
    if rows.placements != cols.placements:
        raise ValueError(f"{name}: rows and cols must be placed alike; got {rows.placements}, {cols.placements}")
    for p in rows.placements:
        if not (isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim == 0)):
            raise ValueError(f"{name}: the pairs may be sharded along k or replicated; got {rows.placements}")
    return list(rows.placements)


def _sketch_kernel_local(x, y, rows, cols, eps, cost, eta):
    if x.device.type == "cpu":
        return gathered_kernel_ref(x, y, rows, cols, eps=eps, cost=cost, eta=eta)
    k_e, c_e = _gathered(_launch_gathered_kernel, x, y, rows, cols, (torch.float32, torch.float32), False,
                         eps=eps, cost=cost, eta=eta)
    return k_e, c_e


def _sketch_cost_local(x, y, rows, cols, cost, eta):
    if x.device.type == "cpu":
        return gathered_cost_ref(x, y, rows, cols, cost=cost, eta=eta)
    return _gathered(_launch_gathered_cost, x, y, rows, cols, (torch.float64,), False, cost=cost, eta=eta)[0]


def gathered_sketch_kernel(x, y, rows, cols, *, eps: float, cost: str, eta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """`gathered_kernel` as the matrix-free sketch calls it
    (`repro_torch.core.api.build_mf_sketch`): no argument check and no flag,
    so no host sync. The sketch's draw makes contiguous int64 indices in
    range (`repro_torch.core.sparsify._draw` clamps rows to n - 1 and
    columns to m - 1); an index out of range would still read no point and
    come out NaN. CPU tensors run `gathered_kernel_ref`.

    DTensors go through `local_map`: ``x`` and ``y`` replicated, ``rows``
    and ``cols`` sharded along the pairs (or replicated); each rank's
    kernel computes its own pairs, and the outputs are placed as ``rows``."""
    pl = _pair_placements("gathered_sketch_kernel", x, y, rows, cols)
    run = local_map(_sketch_kernel_local, out_placements=(pl, pl),
                    in_placements=(_placed(x), _placed(y), pl, pl, None, None, None))
    return run(x, y, rows, cols, eps, cost, eta)


def gathered_sketch_cost(x, y, rows, cols, *, cost: str, eta: float) -> torch.Tensor:
    """`gathered_cost` as the log-domain sketch calls it
    (`repro_torch.core.api.build_mf_log_sketch`), unchecked and without a
    host sync, as `gathered_sketch_kernel`, and under the same `local_map`
    for DTensors. CPU tensors run `gathered_cost_ref`."""
    pl = _pair_placements("gathered_sketch_cost", x, y, rows, cols)
    run = local_map(_sketch_cost_local, out_placements=pl,
                    in_placements=(_placed(x), _placed(y), pl, pl, None, None))
    return run(x, y, rows, cols, cost, eta)


def _online(name: str, ref, launch, x, y, w, *, eps: float, cost: str, eta: float) -> torch.Tensor:
    """The checks and dispatch shared by `online_matvec` and `online_lse`."""
    _check_cost(cost)
    _check_points(x, y)
    if w.ndim != 1 or w.shape[0] != y.shape[0]:
        raise ValueError(f"{name}: the weights must be (m,) = ({y.shape[0]},); got {tuple(w.shape)}")
    if not w.is_floating_point():
        raise TypeError(f"{name}: the weights must be floating point; got {w.dtype}")
    dev = _one_device(name, x, y, w)
    if dev.type == "cpu":
        return ref(x, y, w, eps=eps, cost=cost, eta=eta)
    xf = x.to(torch.float32).contiguous()
    yf = xf if y is x else y.to(torch.float32).contiguous()
    wf = w.to(torch.float32).contiguous()
    out = torch.empty(xf.shape[0], dtype=torch.float32, device=dev)
    launch(xf, yf, wf, out, eps=eps, cost=cost, eta=eta)
    return out


def online_matvec(
    x: torch.Tensor,
    y: torch.Tensor,
    v: torch.Tensor,
    *,
    eps: float,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
) -> torch.Tensor:
    """``K(x, y) @ v`` without materializing K: ``out_i = sum_j exp(-C_ij/eps) v_j``.

    Shapes ``(n,d),(m,d),(m,) -> (n,)``, float32; points and v of another
    float dtype are cast to float32 first. WFR-blocked pairs add 0. CUDA
    tensors go through the CUDA kernel (``csrc/fused_sinkhorn.cu``); CPU
    tensors through `online_matvec_ref`.
    """
    return _online("online_matvec", online_matvec_ref, _launch_online_matvec, x, y, v,
                   eps=eps, cost=cost, eta=eta)


def online_lse(
    x: torch.Tensor,
    y: torch.Tensor,
    g: torch.Tensor,
    *,
    eps: float,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
) -> torch.Tensor:
    """``logsumexp_j(-C_ij/eps + g_j/eps)`` streamed, without materializing K.

    Shapes ``(n,d),(m,d),(m,) -> (n,)``, float32, cast as `online_matvec`.
    WFR-blocked pairs and ``g_j = -inf`` carry no mass; a row with no mass
    at all comes out at or below the ``-1e30`` sentinel. CUDA tensors go
    through the CUDA kernel; CPU tensors through `online_lse_ref`.
    """
    return _online("online_lse", online_lse_ref, _launch_online_lse, x, y, g,
                   eps=eps, cost=cost, eta=eta)


def fused_sinkhorn_solve(
    x: torch.Tensor,
    y: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    eps: float,
    fe: float = 1.0,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
    tol: float = 1e-6,
    max_iter: int = 1000,
) -> SinkhornResult:
    """Dense Sinkhorn (OT: ``fe = 1``; UOT: ``fe = lam/(lam+eps)``) in
    O((n + m) d) memory: both mat-vecs of each iteration are `online_matvec`
    (``K v`` on (x, y), ``K^T u`` on (y, x)), so K is never stored.

    The loop is `generic_scaling_loop` in the dtype of ``a``/``b``: with
    float64 histograms the float32 mat-vecs are promoted in the updates.
    Runs where the tensors lie: CUDA tensors launch two kernels an iteration.
    """
    xf = x.to(torch.float32)
    yf = xf if y is x else y.to(torch.float32)
    return generic_scaling_loop(
        lambda v: online_matvec(xf, yf, v, eps=eps, cost=cost, eta=eta),
        lambda u: online_matvec(yf, xf, u, eps=eps, cost=cost, eta=eta),
        a, b, fe, tol=tol, max_iter=max_iter,
    )


#: the largest tile side the CUDA kernel stages (one v block in 32 KB)
MAX_BLOCK = 8192


def _block_ell(name: str, vals, col_idx, v, row_ptr, bad_index) -> torch.Tensor:
    """The checks and dispatch shared by `block_ell_matvec` and
    `batched_block_ell_matvec`, on B sketches (a leading batch axis on
    every input but ``row_ptr``, which B = 1 alone takes). Returns
    ``(B, nrb * Bk)`` float32."""
    if vals.ndim != 5 or vals.shape[-1] != vals.shape[-2]:
        raise ValueError(f"{name}: vals must be (rows, maxb, Bk, Bk) tiles; got {tuple(vals.shape)}")
    bsz, rows, maxb, bk = vals.shape[:4]
    if tuple(col_idx.shape) != (bsz, rows, maxb):
        raise ValueError(f"{name}: col_idx must hold {(rows, maxb)} ids per sketch to match vals; "
                         f"got {tuple(col_idx.shape)}")
    if v.ndim != 2 or v.shape[0] != bsz or bk == 0 or v.shape[1] % bk:
        raise ValueError(f"{name}: v must hold whole blocks of Bk = {bk} values per sketch; "
                         f"got {tuple(v.shape)}")
    if not (vals.is_floating_point() and v.is_floating_point()):
        raise TypeError(f"{name}: vals and v must be floating point; got {vals.dtype}, {v.dtype}")
    for what, ids in (("col_idx", col_idx), ("row_ptr", row_ptr)):
        if ids is not None and ids.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name}: {what} must be int32 or int64; got {ids.dtype}")
    if row_ptr is not None and row_ptr.ndim != 1:
        raise ValueError(f"{name}: row_ptr must be 1-d; got {tuple(row_ptr.shape)}")
    dev = _one_device(name, vals, col_idx, v, *([] if row_ptr is None else [row_ptr]))
    ncb = v.shape[1] // bk
    nrb = rows if row_ptr is None else row_ptr.shape[0] - 1
    if dev.type == "cpu":
        if col_idx.numel() and bool((col_idx < 0).any() | (col_idx >= ncb).any()):
            raise IndexError(f"{name}: column ids out of range [0, {ncb})")
        if row_ptr is not None and not (
            int(row_ptr[0]) == 0 and int(row_ptr[-1]) == rows and bool((torch.diff(row_ptr) >= 0).all())
        ):
            raise IndexError(f"{name}: row_ptr is not a non-decreasing cover of the {rows} ELL rows")
        offsets = (torch.arange(bsz) * ncb)[:, None, None]
        out = block_ell_matvec_ref(
            vals.reshape(bsz * rows, maxb, bk, bk),
            (col_idx.long() + offsets).reshape(bsz * rows, maxb),
            v.reshape(bsz * ncb, bk),
            row_ptr,
        )
        return out.reshape(bsz, nrb * bk)
    if bk > MAX_BLOCK:
        raise ValueError(f"{name}: the CUDA kernel takes Bk <= {MAX_BLOCK}; got {bk}")
    vf = vals.to(torch.float32).contiguous()
    ci = col_idx.to(torch.int32).contiguous()
    wf = v.to(torch.float32).contiguous()
    rp = None if row_ptr is None else row_ptr.to(torch.int32).contiguous()
    out = torch.empty((bsz, nrb * bk), dtype=torch.float32, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev) if bad_index is None else bad_index
    if out.numel():
        _launch_block_ell_matvec(vf.reshape(bsz * rows, maxb, bk, bk), ci, wf, rp, out.reshape(-1), flag,
                                 col_blocks=ncb, row_blocks_per_sketch=max(nrb, 1))
    if bad_index is None and bool(flag):  # reading the flag waits for the launch
        raise IndexError(f"{name}: column ids out of range [0, {ncb}), or row_ptr out of the ELL rows")
    return out


def block_ell_matvec(
    vals: torch.Tensor,
    col_idx: torch.Tensor,
    v: torch.Tensor,
    *,
    row_ptr: torch.Tensor | None = None,
    bad_index: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sparse sketch mat-vec ``out[r] = sum_k vals[r, k] @ v[col_idx[r, k]]``:
    ``(nrb, maxb, Bk, Bk), (nrb, maxb), (ncb * Bk,) -> (nrb * Bk,)`` float32.

    ``row_ptr`` (``(nrb + 1,)``, the port's layout for a row-block whose
    tiles fill several ELL rows) makes output row-block r the sum over the
    ELL rows ``row_ptr[r]:row_ptr[r+1]``. Tiles and v of another float
    dtype are cast to float32 first, int64 ids to int32. CUDA tensors go
    through the CUDA kernel (``csrc/block_ell.cu``); CPU tensors through
    `block_ell_matvec_ref`. A column id outside ``[0, ncb)`` (or a bad
    ``row_ptr``) raises `IndexError`: on CUDA the kernel sets a flag, which
    the wrapper reads after the launch (a host sync), unless the caller
    passes its own zeroed ``(1,)`` int32 ``bad_index`` to read when it
    chooses (the block-ELL solver reads it once per solve).
    """
    if vals.ndim != 4 or col_idx.ndim != 2 or v.ndim != 1:
        raise ValueError(f"block_ell_matvec: shapes must be (nrb, maxb, Bk, Bk), (nrb, maxb), "
                         f"(ncb * Bk,); got {tuple(vals.shape)}, {tuple(col_idx.shape)}, {tuple(v.shape)}")
    return _block_ell("block_ell_matvec", vals[None], col_idx[None], v[None], row_ptr, bad_index)[0]


def batched_block_ell_matvec(
    vals: torch.Tensor,
    col_idx: torch.Tensor,
    v: torch.Tensor,
    *,
    bad_index: torch.Tensor | None = None,
) -> torch.Tensor:
    """B independent block-ELL mat-vecs in ONE launch:
    ``(B, nrb, maxb, Bk, Bk), (B, nrb, maxb), (B, ncb * Bk) -> (B, nrb * Bk)``.

    The batch axis is folded into the row-block axis; the kernel reads the
    column ids of sketch b against its own part of v (offset ``b * ncb``
    blocks), so an id out of range of its sketch is caught. Casts, dispatch
    and errors as `block_ell_matvec`.
    """
    if vals.ndim != 5 or col_idx.ndim != 3 or v.ndim != 2:
        raise ValueError(f"batched_block_ell_matvec: shapes must be (B, nrb, maxb, Bk, Bk), "
                         f"(B, nrb, maxb), (B, ncb * Bk); got {tuple(vals.shape)}, "
                         f"{tuple(col_idx.shape)}, {tuple(v.shape)}")
    return _block_ell("batched_block_ell_matvec", vals, col_idx, v, None, bad_index)


# ---------------------------------------------------------------------------
# Batched padded-COO reductions: plain torch on every device
# ---------------------------------------------------------------------------


def batched_offsets(idx: torch.Tensor, n: int, *, indices_are_sorted: bool = False):
    """The flat layout of B per-element segment reductions: ``(order,
    offsets)`` of the ``B * n`` segments ``idx[j, e] + j * n``. With
    per-element ascending ids the flat ids ascend too, and ``order`` is
    None; otherwise ``order`` is their stable sort. Callers running many
    reductions over one layout (the batched Sinkhorn loops) compute it once."""
    from repro_torch.core.sparsify import sorted_offsets

    bsz = idx.shape[0]
    seg = (idx + (torch.arange(bsz, dtype=idx.dtype, device=idx.device) * n)[:, None]).reshape(-1)
    order = None
    if not indices_are_sorted:
        order = torch.argsort(seg, stable=True)
        seg = seg[order]
    return order, sorted_offsets(seg, bsz * n)


def _flat(x: torch.Tensor, order) -> torch.Tensor:
    x = x.reshape(-1)
    return x if order is None else x[order]


def batched_coo_matvec(
    rows: torch.Tensor,
    vals: torch.Tensor,
    v_gathered: torch.Tensor,
    *,
    n: int | None = None,
    indices_are_sorted: bool = False,
    layout=None,
) -> torch.Tensor:
    """B independent padded-COO mat-vec reductions as one flat segment sum.

    ``rows`` is (B, cap) per-element row ids, ``v_gathered`` the gathered
    right factor ``v.gather(1, cols)`` (callers own the gather, so the
    transpose direction reuses this reduction). The sum runs over sorted
    flat segments by `torch.segment_reduce` (never ``index_add_``, whose
    CUDA atomics add in a varying order): each element's segments hold its
    own entries in its own order, so the result is bitwise that of B
    separate `repro_torch.core.sparsify.coo_matvec` calls (on the card too,
    where each element's slots start at the alignment of its own sketch, as
    `repro_torch.batch`'s stacked sketches keep them; ``chip_smoke.py``
    phase 11 checks it). ``layout`` is a precomputed `batched_offsets(rows,
    n, ...)`. Returns (B, n).
    """
    from repro_torch.core.sparsify import segment_sum

    if n is None:
        raise TypeError("batched_coo_matvec requires n (the output width)")
    order, offsets = batched_offsets(rows, n, indices_are_sorted=indices_are_sorted) if layout is None else layout
    return segment_sum(_flat(vals * v_gathered, order), offsets).reshape(rows.shape[0], n)


def batched_coo_rmatvec(
    cols: torch.Tensor,
    vals: torch.Tensor,
    u_gathered: torch.Tensor,
    *,
    m: int | None = None,
    indices_are_sorted: bool = False,
    layout=None,
) -> torch.Tensor:
    """Transpose counterpart of `batched_coo_matvec` (segments over
    columns). For the sorted reduction callers pass the column-sorted
    permutation of all three arrays (``x.gather(1, csort)``)."""
    return batched_coo_matvec(cols, vals, u_gathered, n=m, indices_are_sorted=indices_are_sorted, layout=layout)


def batched_coo_logsumexp(
    idx: torch.Tensor,
    z: torch.Tensor,
    *,
    n: int | None = None,
    indices_are_sorted: bool = False,
    layout=None,
) -> torch.Tensor:
    """B independent padded-COO segment-logsumexps as one flat reduction,
    the log-domain `batched_coo_matvec`: ``z`` is the per-entry summand
    ``logvals + y.gather(1, cols)``, ``idx`` the (B, cap) segment ids.
    Runs the port's one `repro_torch.core.sparsify.segment_logsumexp`, so
    ``-inf`` entries are inert and empty segments come out exactly
    ``-inf``. Returns (B, n)."""
    from repro_torch.core.sparsify import segment_logsumexp

    if n is None:
        raise TypeError("batched_coo_logsumexp requires n (the output width)")
    order, offsets = batched_offsets(idx, n, indices_are_sorted=indices_are_sorted) if layout is None else layout
    return segment_logsumexp(_flat(z, order), offsets).reshape(idx.shape[0], n)


# ---------------------------------------------------------------------------
# The log-domain half-step: gather and segment logsumexp in one kernel
# ---------------------------------------------------------------------------


def coo_gather_logsumexp_ref(offsets: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor, y: torch.Tensor,
                             eps: torch.Tensor) -> torch.Tensor:
    """The plain version of `bind_coo_gather_logsumexp`'s half-step: the
    gather, the add and `batched_coo_logsumexp`'s reduction (`repro_torch.core.sparsify.
    segment_logsumexp`) over the flat layout, as the log-domain loop ran
    them before the kernel, so its outputs keep their bits."""
    from repro_torch.core.sparsify import segment_logsumexp

    z = vals + (y / eps[:, None]).gather(1, idx)
    return segment_logsumexp(z.reshape(-1), offsets).reshape(vals.shape[0], -1)


def bind_coo_gather_logsumexp(offsets: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                              eps: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """One half-step of the log-domain sparse Sinkhorn loop
    (`repro_torch.batch.solvers.sparse_log_potentials`) on B padded-COO
    sketches, bound to its layout: returns ``y -> out`` with
    ``out[b, i] = log sum_e exp(vals[b, e] + y[b, idx[b, e]] / eps[b])``
    over the entries e of flat segment ``b * n + i``.

    ``vals`` and ``idx`` are (B, cap) in segment order (the column
    direction takes column-ordered copies), ``offsets`` the ``(B * n + 1,)``
    int64 offsets of their flat segments (`batched_offsets`) and ``eps``
    (B,); ``y`` is the (B, n_other) potentials, ``out`` (B, n). ``-inf``
    entries are inert, empty and all-dead segments come out exactly
    ``-inf``, a NaN in a segment makes it NaN.

    The layout is checked, and on the card made contiguous and bound to the
    kernel's launch, once, here: the loop calls the result with new
    potentials every half-step, and it checks no more of ``y`` than its
    rank, batch, device, and on the card its type and contiguity. CUDA
    tensors go through the CUDA kernel (``csrc/segment_lse.cu``), one
    counted launch a call that checks no index (the sketch's are in range),
    all in float64 (a ``TypeError`` for another type). Each segment's sum
    runs in one order fixed by its own entries, so an element of a batch
    gets bitwise its B = 1 output; against the plain version the order
    differs (``chip_smoke.py`` holds them at 1e-13 relative). CPU tensors go
    through `coo_gather_logsumexp_ref`."""
    name = "bind_coo_gather_logsumexp"
    bsz = vals.shape[0]
    if not (vals.ndim == 2 and idx.shape == vals.shape and tuple(eps.shape) == (bsz,) and offsets.ndim == 1
            and bsz > 0 and (offsets.shape[0] - 1) % bsz == 0):
        raise ValueError(f"{name}: expected offsets (B * n + 1,), vals and idx (B, cap) and eps (B,); got "
                         f"{tuple(offsets.shape)}, {tuple(vals.shape)}, {tuple(idx.shape)}, {tuple(eps.shape)}")
    if offsets.dtype != torch.int64 or idx.dtype != torch.int64:
        raise TypeError(f"{name}: offsets and idx must be int64; got {offsets.dtype}, {idx.dtype}")
    dev = _one_device(name, offsets, vals, idx, eps)
    on_card = dev.type != "cpu"
    if on_card and (vals.dtype != torch.float64 or eps.dtype != torch.float64):
        raise TypeError(f"{name}: the kernel takes float64 values and eps; got {vals.dtype}, {eps.dtype}")

    def check(y: torch.Tensor) -> None:
        if y.ndim != 2 or y.shape[0] != bsz or y.device != dev:
            raise ValueError(f"{name}: expected y (B, n_other) with B = {bsz} on {dev}; got {tuple(y.shape)} on "
                             f"{y.device}")
        if on_card and (y.dtype != torch.float64 or not y.is_contiguous()):
            raise TypeError(f"{name}: the kernel takes contiguous float64 potentials; got {y.dtype}, "
                            f"contiguous {y.is_contiguous()}")

    if not on_card:
        def plain(y: torch.Tensor) -> torch.Tensor:
            check(y)
            return coo_gather_logsumexp_ref(offsets, vals, idx, y, eps)

        return plain
    run = segment_lse_launcher(*(t.contiguous() for t in (offsets, vals, idx, eps)))

    def kernel(y: torch.Tensor) -> torch.Tensor:
        check(y)
        return run(y)

    return kernel


def _path_dtype(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a type the block-ELL kernels read and write (float32 or
    float64; another float type as float32), contiguous."""
    if t.dtype not in (torch.float32, torch.float64):
        t = t.to(torch.float32)
    return t.contiguous()


def block_ell_sketch_matvec(vals32: torch.Tensor, col_idx: torch.Tensor, v: torch.Tensor,
                            row_ptr: torch.Tensor | None, bad_index: torch.Tensor | None,
                            nblocks: torch.Tensor) -> torch.Tensor:
    """``K~ v`` as the block-ELL solver calls it on a CUDA sketch: one
    counted launch and nothing else. It takes what was made and checked
    once, when the sketch was built (`repro_torch.core.sparsify`: the
    float32 tiles, int32 column ids in range, the ``row_ptr`` cover, the
    int32 valid counts ``nblocks`` with zero tiles and column id 0 past
    them), and checks none of it again. On the row layout's 16-byte tiles
    at Bk = 128, up to 8 slots a row, the kernel reads only the valid slots;
    either way the sums are the walk's over every slot. ``v`` float32 or
    float64 is read as it is, and the output
    comes in its dtype (the bits of a cast to float32, the float32 kernel
    and a cast back); ``bad_index`` as in `block_ell_matvec`."""
    vt = _path_dtype(v)
    bk = vals32.shape[-1]
    rows = vals32.shape[0] if row_ptr is None else row_ptr.shape[0] - 1
    out = torch.empty(rows * bk, dtype=vt.dtype, device=vt.device)
    flag = torch.zeros(1, dtype=torch.int32, device=vt.device) if bad_index is None else bad_index
    _launch_block_ell_matvec(vals32, col_idx, vt, row_ptr, out, flag, col_blocks=vt.shape[0] // bk,
                             row_blocks_per_sketch=max(rows, 1), nblocks=nblocks)
    if bad_index is None and bool(flag):  # reading the flag waits for the launch
        raise IndexError("block_ell_sketch_matvec: an index of the sketch out of range")
    return out if out.dtype == v.dtype else out.to(v.dtype)


def block_ell_sketch_rmatvec(vals32: torch.Tensor, columns: BlockEllColumns, u: torch.Tensor,
                             bad_index: torch.Tensor | None) -> torch.Tensor:
    """``K~^T u`` as the block-ELL solver calls it on a CUDA sketch: one
    counted launch of the kernel that reads the row layout's float32 tiles
    through their column lists (`repro_torch.kernels.block_ell.column_lists`,
    made and checked with the sketch), with no check of its own; types and
    ``bad_index`` as `block_ell_sketch_matvec`. Returns ``(ncb * Bk,)``."""
    ut = _path_dtype(u)
    out = torch.empty((columns.col_ptr.shape[0] - 1) * vals32.shape[-1], dtype=ut.dtype, device=ut.device)
    flag = torch.zeros(1, dtype=torch.int32, device=ut.device) if bad_index is None else bad_index
    _launch_block_ell_rmatvec(vals32, columns, ut, out, flag)
    if bad_index is None and bool(flag):
        raise IndexError("block_ell_sketch_rmatvec: an index of the column lists out of range")
    return out if out.dtype == u.dtype else out.to(u.dtype)


class _LruScan(torch.autograd.Function):
    """The scan with the reference's custom VJP (``repro.kernels.ops``):
    forward B5, backward B6 on CUDA tensors; the plain versions on CPU
    tensors. It saves ``a`` and ``h`` for the backward."""

    @staticmethod
    def forward(ctx, a, b):
        if a.device.type == "cpu":
            h = lru_scan_ref(a, b)
        else:
            h = torch.empty_like(a)
            if h.numel():
                _launch_lru_scan_fwd(a, b, h)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        want_a, want_b = ctx.needs_input_grad
        g = g.contiguous()
        if a.device.type == "cpu":
            da, db = lru_scan_bwd_ref(a, h, g)
        else:
            da = torch.empty_like(a) if want_a else None
            db = torch.empty_like(a)
            if db.numel():
                _launch_lru_scan_bwd(a, h, g, da, db)
        return (da if want_a else None), (db if want_b else None)


def _lru_scan_local(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("lru_scan: a and b must be contiguous")
    _one_device("lru_scan", a, b)
    return _LruScan.apply(a, b)


def _scan_placements(a, b):
    """The placements of `lru_scan` under `local_map` (``None`` for plain
    tensors): a and b placed alike, sharded on B or W or replicated. A
    shard on S raises, since the recurrence runs along S, and so does a
    partial sum; no redistribution is made here."""
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return None
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or a.placements != b.placements:
        raise ValueError("lru_scan: a and b must both be DTensors placed alike, or both tensors")
    for p in a.placements:
        if isinstance(p, Shard) and p.dim % 3 == 1:
            raise ValueError(f"lru_scan: the recurrence runs along S, which must not be sharded; got {a.placements}")
        if not isinstance(p, (Shard, Replicate)):
            raise ValueError(f"lru_scan: a and b must be sharded on B or W, or replicated; got {a.placements}")
    return list(a.placements)


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The linear recurrence ``h_t = a_t h_{t-1} + b_t`` along S, with
    ``h_{-1} = 0``: ``(B, S, W), (B, S, W) -> (B, S, W)`` float32.

    Takes contiguous float32 tensors on one device. CUDA tensors go through
    the CUDA kernel (``csrc/lru_scan.cu``, B5); CPU tensors through
    `lru_scan_ref`. Differentiable, as the reference's custom VJP: the
    gradient is the reverse scan, kernel B6 on CUDA tensors
    (`lru_scan_bwd_ref` on CPU ones), which gives ``db = lam`` and
    ``da = lam h_{t-1}`` in one pass.

    DTensors go through `local_map`: each rank scans its local shard
    (sharded on B or W; S unsharded), forward and backward, and the output
    is placed as ``a``.
    """
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"lru_scan: a and b must be (B, S, W) of one shape; got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"lru_scan: a and b must be float32; got {a.dtype}, {b.dtype}")
    pl = _scan_placements(a, b)
    return local_map(_lru_scan_local, out_placements=pl, in_placements=(pl, pl))(a, b)
