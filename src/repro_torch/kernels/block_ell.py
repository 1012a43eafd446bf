"""Launch of the CUDA block-ELL sketch mat-vec (``csrc/block_ell.cu``).

The counterpart of the reference's ``repro.kernels.block_ell``:
``out[i] = sum_k vals[i, k] @ v[col_idx[i, k]]`` over a fixed-width list of
kept (Bk x Bk) tiles per row-block. ``K~^T u`` is the same kernel on the
sketch's transposed layout. The checked wrappers are
`repro_torch.kernels.ops.block_ell_matvec` and `~.batched_block_ell_matvec`.
"""
from __future__ import annotations

from repro_torch.kernels.library import launch


def _launch_block_ell_matvec(vals, col_idx, v, row_ptr, out, bad_index, *, col_blocks: int,
                             row_blocks_per_sketch: int) -> None:
    """One counted launch on already-checked CUDA tensors: contiguous float32
    tiles ``(ell_rows, maxb, Bk, Bk)``, int32 column ids ``(ell_rows, maxb)``,
    ``row_ptr`` None (one ELL row per row-block) or int32 ``(R + 1,)``,
    float32 ``v`` (``col_blocks * Bk`` values per sketch), float32 ``out``
    ``(R * Bk,)`` and a zeroed int32 flag that the kernel sets on a column id
    outside ``[0, col_blocks)`` or a ``row_ptr`` range outside the ELL rows.
    Output row-block ``r`` belongs to sketch ``r // row_blocks_per_sketch``
    and reads that sketch's part of ``v``. Runs on the current stream;
    raises if the launch is refused."""
    ell_rows, max_blocks, bk = vals.shape[0], vals.shape[1], vals.shape[2]
    row_blocks = out.shape[0] // bk
    launch(
        "block_ell_matvec", vals.device,
        vals.data_ptr(), col_idx.data_ptr(), v.data_ptr(),
        None if row_ptr is None else row_ptr.data_ptr(),
        row_blocks, ell_rows, max_blocks, bk, col_blocks, row_blocks_per_sketch,
        out.data_ptr(), bad_index.data_ptr(),
    )
