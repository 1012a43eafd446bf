"""Launches of the CUDA linear-recurrence scan (``csrc/lru_scan.cu``).

The counterparts of the reference's ``repro.kernels.lru_scan``: the forward
``lru_scan_fwd_call`` (``h_t = a_t h_{t-1} + b_t`` over (B, S, W), kernel
B5) and the backward ``lru_scan_bwd_call`` with the custom VJP around it
(``lam_t = g_t + a_{t+1} lam_{t+1}``, ``da = lam h_{t-1}``, ``db = lam``,
kernel B6). The checked wrapper, a `torch.autograd.Function`, is
`repro_torch.kernels.ops.lru_scan`.

Both cut S into chunks (the library's ``lru_scan_chunk`` and
``lru_scan_bwd_chunk`` pick their length for the shape), one warp a chunk of
32 channels: each chunk's product and end state, then the neighbouring
chunk's carry in chunk order (the forward's from the start, the backward's
from the end), then the chunk again from its carry, in one pass. The scratch
for the carries, their flags and the ticket counter is allocated here, since
the kernels allocate nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.library import launch, load


def _chunk_scratch(x: torch.Tensor, backward: bool) -> tuple[int, torch.Tensor]:
    """The chunk length of a forward or backward launch over ``x``'s
    (B, S, W) and its scratch (the carries, their flags and the ticket
    counter)."""
    bsz, seq, width = x.shape
    lib = load()
    chunk = (lib.lru_scan_bwd_chunk if backward else lib.lru_scan_chunk)(bsz, seq, width)
    return chunk, torch.empty(3 * bsz * -(-seq // chunk) * width, dtype=torch.float32, device=x.device)


def _launch_lru_scan_fwd(a, b, h) -> None:
    """One counted launch on already-checked CUDA tensors: contiguous
    float32 ``a``, ``b`` and output ``h``, all (B, S, W). Runs on the
    current stream; raises if the launch is refused."""
    chunk, part = _chunk_scratch(a, backward=False)
    launch("lru_scan_fwd", a.device, a.data_ptr(), b.data_ptr(), h.data_ptr(), *a.shape, chunk, part.data_ptr())


def _launch_lru_scan_bwd(a, h, g, da, db) -> None:
    """One counted launch on already-checked CUDA tensors: the forward's
    ``a`` and ``h``, the cotangent ``g`` and the outputs ``da`` (or None:
    not written) and ``db``, all contiguous float32 (B, S, W). Runs on the
    current stream; raises if the launch is refused."""
    chunk, part = _chunk_scratch(a, backward=True)
    launch("lru_scan_bwd", a.device, a.data_ptr(), h.data_ptr(), g.data_ptr(),
           None if da is None else da.data_ptr(), db.data_ptr(), *a.shape, chunk, part.data_ptr())
