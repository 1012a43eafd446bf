"""Launches of the CUDA linear-recurrence scan (``csrc/lru_scan.cu``).

The counterparts of the reference's ``repro.kernels.lru_scan``: the forward
``lru_scan_fwd_call`` (``h_t = a_t h_{t-1} + b_t`` over (B, S, W), kernel
B5) and the backward ``lru_scan_bwd_call`` with the custom VJP around it
(``lam_t = g_t + a_{t+1} lam_{t+1}``, ``da = lam h_{t-1}``, ``db = lam``,
kernel B6). The checked wrapper, a `torch.autograd.Function`, is
`repro_torch.kernels.ops.lru_scan`.

The forward cuts S into chunks (the library's ``lru_scan_chunk`` picks
their length for the shape), one warp a chunk of 32 channels: each chunk's
product and end state, then the previous chunk's carry in chunk order, then
the chunk again from its carry, in one pass. The scratch for the carries,
their flags and the ticket counter is allocated here, since the kernels
allocate nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.library import launch, load


def _launch_lru_scan_fwd(a, b, h) -> None:
    """One counted launch on already-checked CUDA tensors: contiguous
    float32 ``a``, ``b`` and output ``h``, all (B, S, W). Runs on the
    current stream; raises if the launch is refused."""
    bsz, seq, width = a.shape
    chunk = load().lru_scan_chunk(bsz, seq, width)
    part = torch.empty(3 * bsz * -(-seq // chunk) * width, dtype=torch.float32, device=a.device)
    launch("lru_scan_fwd", a.device, a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, seq, width, chunk,
           part.data_ptr())


def _launch_lru_scan_bwd(a, h, g, da, db) -> None:
    """One counted launch on already-checked CUDA tensors: the forward's
    ``a`` and ``h``, the cotangent ``g`` and the outputs ``da`` (or None:
    not written) and ``db``, all contiguous float32 (B, S, W)."""
    bsz, seq, width = a.shape
    launch("lru_scan_bwd", a.device, a.data_ptr(), h.data_ptr(), g.data_ptr(),
           None if da is None else da.data_ptr(), db.data_ptr(), bsz, seq, width)
