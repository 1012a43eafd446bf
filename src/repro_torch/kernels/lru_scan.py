"""Launch of the CUDA linear-recurrence scan (``csrc/lru_scan.cu``).

The counterpart of the reference's ``repro.kernels.lru_scan`` forward
(``lru_scan_fwd_call``): ``h_t = a_t h_{t-1} + b_t`` over (B, S, W). The
checked wrapper is `repro_torch.kernels.ops.lru_scan`. The backward
(``lru_scan_bwd_call``) comes with the training slice.
"""
from __future__ import annotations

from repro_torch.kernels.library import launch


def _launch_lru_scan_fwd(a, b, h) -> None:
    """One counted launch on already-checked CUDA tensors: contiguous
    float32 ``a``, ``b`` and output ``h``, all (B, S, W). Runs on the
    current stream; raises if the launch is refused."""
    bsz, seq, width = a.shape
    launch("lru_scan_fwd", a.device, a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, seq, width)
