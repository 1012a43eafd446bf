"""RecurrentGemma recurrent block: gated linear branch x conv1d + RG-LRU.

The counterpart of the reference's ``repro.models.rglru``. RG-LRU
recurrence (Griffin, arXiv:2402.19427):
  r_t = sigmoid(W_r u_t),  i_t = sigmoid(W_i u_t)
  a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The linear recurrence has three backends, as in the reference:
``"assoc"`` (one log-depth doubling scan over the sequence), ``"chunked"``
(doubling scans inside chunks of ``cfg.rglru_chunk`` plus one across the
chunks' states; the default) and ``"pallas"`` (the hand-written kernel,
`repro_torch.kernels.ops.lru_scan`, kernel B5; the name is the
reference's). Decode is one fused step with an O(1) state.

Conventions kept from JAX: ``jax.nn.gelu`` is the tanh approximation, and
``jax.nn.softplus`` is ``logaddexp(x, 0)`` (``F.softplus`` switches to the
identity above 20, which this is not).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.layout import layout_as, unshard, unshard_for_split
from repro_torch.kernels.ops import lru_scan
from repro_torch.kernels.ref import linear_scan
from repro_torch.models.layers import _causal_conv, _normal, _softplus, dense_init

__all__ = ["init_rglru", "rglru_forward", "RGLRUState", "init_rglru_state", "rglru_decode"]

_C = 8.0
_CONV_K = 4


def init_rglru(gen, cfg: ModelConfig, device, dtype=torch.float32):
    w = cfg.rnn_width or cfg.d_model
    return {
        "w_x": dense_init(gen, cfg.d_model, w, device, dtype),
        "w_gate": dense_init(gen, cfg.d_model, w, device, dtype),
        "conv_w": _normal(gen, (_CONV_K, w), 0.1, device, dtype),
        "w_r": dense_init(gen, w, w, device, dtype),
        "w_i": dense_init(gen, w, w, device, dtype),
        "lam": torch.full((w,), 2.0, dtype=dtype, device=device),  # softplus(2) ~ 2.1 => slow decay
        "w_out": dense_init(gen, w, cfg.d_model, device, dtype),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _gates(params, u, dtype):
    r = torch.sigmoid(u @ params["w_r"]["w"].to(dtype)).to(torch.float32)
    i = torch.sigmoid(u @ params["w_i"]["w"].to(dtype)).to(torch.float32)
    log_a = -_C * _softplus(params["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i


def _scan_assoc(a, b):
    """Baseline: one doubling scan over the full sequence."""
    return linear_scan(a, b, 1)[1]


def _scan_chunked(a, b, q: int):
    """Chunked scan: doubling scans inside chunks of q (log2(q) passes) and
    one across the (B, nc, W) chunk states."""
    bsz, s, w = a.shape
    if s % q != 0 or s <= q:
        return _scan_assoc(a, b)
    nc = s // q
    ac = unshard_for_split(a, 1, nc).reshape(bsz, nc, q, w)
    bc = unshard_for_split(b, 1, nc).reshape(bsz, nc, q, w)
    a_cum, h_intra = linear_scan(ac, bc, 2)
    # carry across chunks: H_c = A_c H_{c-1} + h_last_c
    big_a = a_cum[:, :, -1, :]
    hl = h_intra[:, :, -1, :]
    _, big_h = linear_scan(big_a, hl, 1)
    h_prev = torch.cat([torch.zeros_like(big_h[:, :1]), big_h[:, :-1]], dim=1)
    h = h_intra + a_cum * h_prev[:, :, None, :]
    return h.reshape(bsz, s, w)


def rglru_forward(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, D) -> (B, S, D)."""
    dtype = x.dtype
    u = x @ params["w_x"]["w"].to(dtype)
    gate = _gelu(x @ params["w_gate"]["w"].to(dtype))
    u = _causal_conv(u, params["conv_w"].to(dtype))
    a, bi = _gates(params, u, dtype)  # (B,S,W) f32
    b_seq = bi * u.to(torch.float32)

    if cfg.rglru_backend == "pallas":
        # a DTensor's shard on S replicated (the recurrence runs along S),
        # a partial sum reduced, and b laid out as a: lru_scan's layout
        a = unshard(a, 1)
        h = lru_scan(a, layout_as(b_seq, a))
    elif cfg.rglru_backend == "chunked":
        h = _scan_chunked(a, b_seq, cfg.rglru_chunk or 256)
    else:
        h = _scan_assoc(a, b_seq)
    return (h.to(dtype) * gate) @ params["w_out"]["w"].to(dtype)


class RGLRUState(NamedTuple):
    h: torch.Tensor  # (B, W)
    conv: torch.Tensor  # (B, K-1, W)


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None):
    """A zero state; ``device=None`` means the card."""
    w = cfg.rnn_width or cfg.d_model
    dev = resolve_device(device)
    return RGLRUState(
        torch.zeros((batch, w), dtype=dtype, device=dev),
        torch.zeros((batch, _CONV_K - 1, w), dtype=dtype, device=dev),
    )


def rglru_decode(params, x: torch.Tensor, state: RGLRUState, cfg: ModelConfig):
    """One-token step. x (B, 1, D) -> (y (B,1,D), new state)."""
    dtype = x.dtype
    u = x @ params["w_x"]["w"].to(dtype)  # (B,1,W)
    gate = _gelu(x @ params["w_gate"]["w"].to(dtype))
    window = torch.cat([state.conv.to(dtype), u], dim=1)  # (B,K,W)
    u1 = torch.sum(window * params["conv_w"].to(dtype)[None], dim=1, keepdim=True)
    a, bi = _gates(params, u1, dtype)  # (B,1,W)
    h_new = a[:, 0] * state.h.to(torch.float32) + (bi * u1.to(torch.float32))[:, 0]
    y = (h_new[:, None, :].to(dtype) * gate) @ params["w_out"]["w"].to(dtype)
    return y, RGLRUState(h_new.to(state.h.dtype), window[:, 1:].to(state.conv.dtype))
