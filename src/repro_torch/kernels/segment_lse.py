"""Launch of the gathered segment logsumexp (``csrc/segment_lse.cu``), the
half-step of the log-domain sparse Sinkhorn loop. The wrapper is
`repro_torch.kernels.ops.bind_coo_gather_logsumexp`; the kernel replaces no
TPU kernel (the reference leaves these segment reductions to XLA).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.library import launcher


def segment_lse_launcher(offsets, vals, idx, eps) -> Callable[[torch.Tensor], torch.Tensor]:
    """``y -> out``: counted launches over one layout, on checked CUDA
    tensors (the returned function holds them): ``offsets`` (B * n + 1,) int64,
    ``vals`` (B, cap) float64 and ``idx`` (B, cap) int64, ``eps`` (B,)
    float64, all contiguous. The returned function takes the (B, n_other)
    float64 potentials, contiguous, and returns the (B, n) output; the
    layout's pointers and the stream are resolved here, once."""
    bsz = vals.shape[0]
    segments = offsets.shape[0] - 1
    per_elem = segments // bsz
    dev = vals.device
    call = launcher("segment_lse", dev)
    args = (offsets.data_ptr(), vals.data_ptr(), idx.data_ptr())
    eps_ptr = eps.data_ptr()

    def run(y: torch.Tensor) -> torch.Tensor:
        out = torch.empty((bsz, per_elem), dtype=torch.float64, device=dev)
        if segments:
            call(*args, y.data_ptr(), eps_ptr, segments, per_elem, y.shape[1], out.data_ptr())
        return out

    run.layout = (offsets, vals, idx, eps)  # alive while their pointers are bound
    return run
