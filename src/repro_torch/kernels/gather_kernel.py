"""Launches of the CUDA gathered-kernel evaluation (``csrc/gather_kernel.cu``):
the float32 ``(K_e, C_e)`` kernel and its float64 cost-only mode.

The counterpart of the reference's ``repro.kernels.gather_kernel``; the
checked wrappers are `repro_torch.kernels.ops.gathered_kernel` and
`repro_torch.kernels.ops.gathered_cost`, the sketch's unchecked ones
`ops.gathered_sketch_kernel` and `ops.gathered_sketch_cost`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.library import COSTS, launch


def packed_stride(d: int) -> int:
    """Values in one packed point row: the d coordinates and the squared
    norm, rounded up to a multiple of 4 (the C ``gathered_packed_stride``)."""
    return (d + 4) & ~3


def _packed(x: torch.Tensor, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Scratch for the packed rows of x and, unless y is x (as the launch
    decides: one address, one length), of y."""
    rows = x.shape[0] + (0 if x.data_ptr() == y.data_ptr() and x.shape[0] == y.shape[0] else y.shape[0])
    return torch.empty(rows * packed_stride(x.shape[1]), dtype=dtype, device=x.device)


def _launch_gathered_kernel(x, y, rows, cols, k_out, c_out, bad_index, *, eps: float, cost: str, eta: float,
                            packed: torch.Tensor | None = None) -> None:
    """One counted launch (the pack, then the kernel) on checked CUDA
    tensors: contiguous points, both float32 or both float64 (y may be x),
    int64 indices, float32 outputs, and a zeroed int32 flag that the kernel
    sets on an out-of-range index, or None for no flag. ``packed`` is the
    pack's scratch (allocated here if None); raises if a launch is
    refused."""
    packed = _packed(x, y, torch.float32) if packed is None else packed
    launch(
        "gathered_kernel", x.device,
        x.data_ptr(), y.data_ptr(), int(x.dtype == torch.float64), rows.data_ptr(), cols.data_ptr(),
        x.shape[0], y.shape[0], rows.shape[0], x.shape[1], float(eps), COSTS[cost], float(eta),
        packed.data_ptr(), k_out.data_ptr(), c_out.data_ptr(), None if bad_index is None else bad_index.data_ptr(),
    )


def _launch_gathered_cost(x, y, rows, cols, c_out, bad_index, *, cost: str, eta: float,
                          packed: torch.Tensor | None = None) -> None:
    """One counted launch of the float64 cost-only mode, as
    `_launch_gathered_kernel` with a float64 output and no ``eps``."""
    packed = _packed(x, y, torch.float64) if packed is None else packed
    launch(
        "gathered_cost", x.device,
        x.data_ptr(), y.data_ptr(), int(x.dtype == torch.float64), rows.data_ptr(), cols.data_ptr(),
        x.shape[0], y.shape[0], rows.shape[0], x.shape[1], COSTS[cost], float(eta),
        packed.data_ptr(), c_out.data_ptr(), None if bad_index is None else bad_index.data_ptr(),
    )
