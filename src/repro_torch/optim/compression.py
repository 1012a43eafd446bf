"""Gradient compression: per-tensor int8 quantization with error feedback.

The counterpart of the reference's ``repro.optim.compression``. With one
card there is no data-parallel all-reduce to compress, but the train step
keeps the reference's ``grad_compression`` branch (the same arithmetic on
every leaf), so a run with it on gives the reference's numbers.
"""
from __future__ import annotations

import torch

__all__ = ["compress_int8", "decompress_int8", "ef_update"]


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(values int8, scale float32 0-dim). Symmetric per-tensor quantization."""
    x32 = x.to(torch.float32)
    amax = torch.max(torch.abs(x32))
    scale = torch.clamp(amax, min=1e-12) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def ef_update(grad: torch.Tensor, residual: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Error feedback: compress (grad + residual); return (the decompressed
    grad in ``grad``'s dtype, the new residual)."""
    target = grad.to(torch.float32) + residual
    q, scale = compress_int8(target)
    deq = decompress_int8(q, scale)
    return deq.to(grad.dtype), target - deq
