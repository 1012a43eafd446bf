"""Launches of the CUDA block-ELL sketch mat-vecs (``csrc/block_ell.cu``).

The counterpart of the reference's ``repro.kernels.block_ell``:
``out[i] = sum_k vals[i, k] @ v[col_idx[i, k]]`` over a fixed-width list of
kept (Bk x Bk) tiles per row-block (``K~ v``), and ``K~^T u`` on the same
row-layout tiles through the sketch's column lists (`column_lists`), the
reference's ``repro.core.sparsify.block_ell_rmatvec``. The checked wrappers
are `repro_torch.kernels.ops.block_ell_matvec` and
`~.batched_block_ell_matvec`; the solver's calls are
`~.block_ell_sketch_matvec` and `~.block_ell_sketch_rmatvec`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.library import launch

#: tiles of one ``K~^T u`` work unit (``kUnitTiles`` in the source)
UNIT_TILES = 2


class BlockEllColumns(NamedTuple):
    """The column lists of a block-ELL layout, which ``K~^T u`` walks: for
    each column-block c, its valid tiles in the order of row-block, then
    slot, at ``col_ptr[c]:col_ptr[c+1]``, cut into work units of
    `UNIT_TILES` tiles (the last one of a column-block shorter)."""

    #: (T,) int32 flat slot ``e * max_blocks + k`` of each listed tile
    tile: torch.Tensor
    #: (T,) int32 row-block of ELL row e: the block of u the tile reads
    urow: torch.Tensor
    #: (ncb + 1,) int32 offsets of each column-block's tiles
    col_ptr: torch.Tensor
    #: (ncb + 1,) int32 offsets of each column-block's work units
    col_unit_ptr: torch.Tensor
    #: the number of work units, ``col_unit_ptr[-1]``
    units: int


def column_lists(col_idx: torch.Tensor, nblocks: torch.Tensor, row_of_ell: torch.Tensor,
                 col_blocks: int) -> BlockEllColumns:
    """The column lists of a layout with column ids ``(ell_rows, maxb)``,
    ``nblocks`` valid slots per ELL row and ELL row -> row-block map
    ``row_of_ell``, on their device. Raises `IndexError` for a valid slot's
    column id outside ``[0, col_blocks)``. Reads two sizes to the host."""
    dev = col_idx.device
    maxb = col_idx.shape[1]
    valid = torch.arange(maxb, device=dev)[None, :] < nblocks.long()[:, None]
    flat = torch.nonzero(valid.reshape(-1)).reshape(-1)  # ascending: ELL row, then slot
    cols = col_idx.reshape(-1)[flat].long()
    if cols.numel() and bool(((cols < 0) | (cols >= col_blocks)).any()):
        raise IndexError(f"column ids out of range [0, {col_blocks})")
    order = torch.argsort(cols, stable=True)
    tile = flat[order]
    counts = torch.bincount(cols, minlength=col_blocks)
    zero = counts.new_zeros(1)
    col_ptr = torch.cat([zero, torch.cumsum(counts, 0)])
    col_unit_ptr = torch.cat([zero, torch.cumsum(-(-counts // UNIT_TILES), 0)])
    return BlockEllColumns(
        tile.to(torch.int32), row_of_ell.long()[tile // maxb].to(torch.int32),
        col_ptr.to(torch.int32), col_unit_ptr.to(torch.int32), int(col_unit_ptr[-1]),
    )


def _launch_block_ell_matvec(vals, col_idx, v, row_ptr, out, bad_index, *, col_blocks: int,
                             row_blocks_per_sketch: int, nblocks=None) -> None:
    """One counted ``K~ v`` launch on already-checked CUDA tensors:
    contiguous float32 tiles ``(ell_rows, maxb, Bk, Bk)``, int32 column ids
    ``(ell_rows, maxb)``, ``row_ptr`` None (one ELL row per row-block) or
    int32 ``(R + 1,)``, ``v`` (``col_blocks * Bk`` values per sketch) and
    ``out`` ``(R * Bk,)`` both float32 or both float64, and a zeroed int32
    flag that the kernel sets on a column id outside ``[0, col_blocks)`` or
    a ``row_ptr`` range outside the ELL rows. Output row-block ``r`` belongs
    to sketch ``r // row_blocks_per_sketch`` and reads that sketch's part of
    ``v``. ``nblocks`` (int32 ``(ell_rows,)``, the valid slots at the start
    of each ELL row, the rest zero tiles with column id 0) lets the kernel
    read only the valid slots (the row layout's 16-byte tiles at Bk = 128,
    up to 8 slots a row), with the sums of the walk over every slot, which
    None asks for. Runs on the current stream; raises if the launch is
    refused."""
    ell_rows, max_blocks, bk = vals.shape[0], vals.shape[1], vals.shape[2]
    launch(
        "block_ell_matvec", vals.device,
        vals.data_ptr(), col_idx.data_ptr(), v.data_ptr(),
        None if row_ptr is None else row_ptr.data_ptr(), None if nblocks is None else nblocks.data_ptr(),
        out.shape[0] // bk, ell_rows, max_blocks, bk, col_blocks, row_blocks_per_sketch,
        int(v.dtype == torch.float64), out.data_ptr(), bad_index.data_ptr(),
    )


def _launch_block_ell_rmatvec(vals, columns: BlockEllColumns, u, out, bad_index) -> None:
    """One counted ``K~^T u`` launch on already-checked CUDA tensors: the
    row layout's contiguous float32 tiles, its `column_lists` on the same
    device, ``u`` (``n``) and ``out`` (``ncb * Bk``) both float32 or both
    float64, and a zeroed int32 flag that the kernel sets on a list entry
    out of range. The scratch of the units' partials is allocated here.
    Runs on the current stream; raises if the launch is refused."""
    bk = vals.shape[-1]
    part = torch.empty(columns.units * bk, dtype=torch.float32, device=vals.device)
    launch(
        "block_ell_rmatvec", vals.device,
        vals.data_ptr(), columns.tile.data_ptr(), columns.urow.data_ptr(), columns.col_ptr.data_ptr(),
        columns.col_unit_ptr.data_ptr(), u.data_ptr(), columns.units, vals.shape[0] * vals.shape[1],
        u.shape[0] // bk, bk, out.shape[0] // bk, int(u.dtype == torch.float64), part.data_ptr(),
        out.data_ptr(), bad_index.data_ptr(),
    )
