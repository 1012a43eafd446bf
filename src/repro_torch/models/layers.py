"""Shared transformer building blocks (plain torch, parameter dicts).

The counterpart of the reference's ``repro.models.layers``, with the same
conventions:

* parameters are nested dicts of tensors whose keys are those of the
  reference's pytree; init functions mirror apply functions;
* weights are float32 masters (``cfg.param_dtype``), cast to ``cfg.dtype``
  (bf16) at use;
* all linears are bias-free.

Init functions draw from a `torch.Generator` on the target device; on the
``meta`` device they allocate nothing and draw nothing (shapes only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.layout import replicated

__all__ = [
    "dense_init",
    "dense",
    "rms_norm_init",
    "rms_norm",
    "rope",
    "swiglu_init",
    "swiglu",
    "embed_init",
    "embed",
    "softcap",
    "torch_dtype",
]


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a torch dtype passes through)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _normal(gen: torch.Generator | None, shape, scale: float, device, dtype=torch.float32):
    """N(0, scale^2) float32 draws from ``gen``, cast to ``dtype``; an empty
    tensor on the ``meta`` device."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(scale)
    return out.to(dtype)


def dense_init(gen, d_in: int, d_out: int, device, dtype=torch.float32, scale: float | None = None):
    scale = (d_in**-0.5) if scale is None else scale
    return {"w": _normal(gen, (d_in, d_out), scale, device, dtype)}


def dense(params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return x @ params["w"].to(dtype)


def rms_norm_init(d: int, device, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * params["scale"].to(torch.float32)
    return out.to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split halves (not interleaved). x: (..., S, H, hd);
    positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_init(gen, d: int, d_ff: int, device, dtype=torch.float32):
    return {
        "wi": dense_init(gen, d, d_ff, device, dtype),
        "wg": dense_init(gen, d, d_ff, device, dtype),
        "wo": dense_init(gen, d_ff, d, device, dtype),
    }


def swiglu(params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    h = dense(params["wi"], x, dtype) * F.silu(dense(params["wg"], x, dtype))
    return dense(params["wo"], h, dtype)


def embed_init(gen, vocab: int, d: int, device, dtype=torch.float32):
    return {"w": _normal(gen, (vocab, d), 0.02, device, dtype)}


def embed(params, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Rows ``tokens`` of the table, cast to ``dtype``: (B, S) -> (B, S, D).

    DTensor tokens are replicated first (a few bytes a token): the gather's
    index and the table's FSDP shards conflict, which GSPMD resolves by
    unsharding the batch too (the caller re-shards it, the reference's G5
    `constrain`), and some DTensor versions refuse a batch sharded over two
    mesh dims (pod and data) in the gather."""
    return params["w"][replicated(tokens)].to(dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` (``F.softplus`` switches to
    the identity above 20, which this does not)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of width K along S, in the working dtype:
    ``sum_i pad(x)[:, i : i + S] * w[i]`` with K - 1 zeros in front, summed
    left to right (RG-LRU's and Mamba-2's). x (B, S, C), w (K, C)."""
    k = w.shape[0]
    # K - 1 zeros in front by a concatenation (the values of F.pad's, which
    # some DTensor versions give one placement on a mesh of two dims)
    pad = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2])), x], dim=1)
    s = x.shape[1]
    out = pad[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + pad[:, i : i + s, :] * w[i][None, None, :]
    return out


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)
