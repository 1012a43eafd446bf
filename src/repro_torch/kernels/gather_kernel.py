"""Launch of the CUDA gathered-kernel evaluation (``csrc/gather_kernel.cu``).

The counterpart of the reference's ``repro.kernels.gather_kernel``; the
checked wrapper is `repro_torch.kernels.ops.gathered_kernel`.
"""
from __future__ import annotations

from repro_torch.kernels.library import COSTS, launch


def _launch_gathered_kernel(xf, yf, rows, cols, k_out, c_out, bad_index, *, eps: float, cost: str, eta: float) -> None:
    """One counted launch of the CUDA kernel on already-checked CUDA tensors
    (contiguous float32 points, int64 indices, float32 outputs, a zeroed
    int32 flag that the kernel sets on an out-of-range index), on the
    current stream; raises if the launch is refused."""
    launch(
        "gathered_kernel", xf.device,
        xf.data_ptr(), yf.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        xf.shape[0], yf.shape[0], rows.shape[0], xf.shape[1], float(eps), COSTS[cost], float(eta),
        k_out.data_ptr(), c_out.data_ptr(), bad_index.data_ptr(),
    )
