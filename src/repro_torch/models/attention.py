"""Attention: grouped-query attention with RoPE / qk-norm, query-chunked
softmax, sliding-window and bidirectional masks, cross-attention, and
KV-cache decode with ring buffers for windowed layers.

The counterpart of the reference's ``repro.models.attention``, with its
decode K/V pin (`constrain`, a no-op without a mesh). Under a mesh a head
split whose width is sharded unevenly replicates that width first
(`unshard_for_split`), as GSPMD does, and attention runs on each rank's
heads (`local_apply`). The query-chunked formulation
(a loop over query tiles against the full K/V) keeps the score memory at
(B, Hkv, rep, chunk, S) instead of (B, H, S, S). Scores are computed for
the whole chunk x S and then masked, as in the reference: at S = 32768
that is O(S^2) products, left to ``torch.matmul`` as the reference leaves
them to XLA.

Cross-attention (the VLM's image layers, Whisper's decoder) attends from
the tokens to a fixed memory (image patches, encoder frames) with no RoPE,
no qk-norm and an all-true mask, unchunked as in the reference: its
float32 scores are (B, H, S, M). `cross_kv` projects the memory once so
that decode steps skip those projections (`cross_attention_cached`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.layout import local_apply, unshard_for_merge, unshard_for_split
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import dense, dense_init, rms_norm, rms_norm_init, rope

__all__ = [
    "KVCache",
    "attention",
    "attention_decode",
    "cross_attention",
    "cross_attention_cached",
    "cross_kv",
    "init_attention",
    "init_kv_cache",
]

_NEG = -1e30


def init_attention(generator, cfg: ModelConfig, device, dtype=torch.float32, cross: bool = False):
    """The projections (and the qk-norm scales if ``cfg.qk_norm``, but not
    for ``cross``-attention), drawn from ``generator``."""
    p = {
        "wq": dense_init(generator, cfg.d_model, cfg.q_dim, device, dtype),
        "wk": dense_init(generator, cfg.d_model, cfg.kv_dim, device, dtype),
        "wv": dense_init(generator, cfg.d_model, cfg.kv_dim, device, dtype),
        "wo": dense_init(generator, cfg.q_dim, cfg.d_model, device, dtype),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = rms_norm_init(cfg.head_dim, device, dtype)
        p["k_norm"] = rms_norm_init(cfg.head_dim, device, dtype)
    return p


def _split_heads(x, n_heads, head_dim):
    """(B, S, n_heads * head_dim) -> (B, S, n_heads, head_dim); a DTensor
    whose width is sharded by a count that does not divide ``n_heads`` is
    replicated along those mesh dims first, as GSPMD does."""
    b, s, _ = x.shape
    return unshard_for_split(x, -1, n_heads).reshape(b, s, n_heads, head_dim)


# the named axes of `_gqa_attend`'s operands (`local_apply`): batch, KV
# heads (a query's heads are its KV head's, rep apiece) and head_dim
_QKV = ("b", None, "h", "d")  # q (B,C,H,hd), k and v (B,S,Hkv,hd)
_SCORES = ("b", "h", None, None, None)  # (B,Hkv,rep,C,S)
_MASK = ("b", None, None)  # (B,C,S)


def _gqa_attend(q, k, v, mask, scale, grouped_out: bool = False):
    """Grouped-query attention without repeating K/V.

    q (B,C,H,hd), k/v (B,S,Hkv,hd), mask (B,C,S) -> (B,C,H,hd), or
    (B,C,Hkv,rep,hd) with ``grouped_out``. Scores in float32, masked
    entries at -1e30, softmax weights cast to ``v.dtype``.

    DTensors run on each rank's shards (`local_apply`): the batch and the
    KV heads where they divide, and a head_dim that K shards (the decode
    cache's layout) stays sharded: the scores are then summed over its
    shards (one all-reduce of (B, H, C, S)) and K/V never move.
    """
    scores = local_apply(functools.partial(_scores, scale=scale), k, q, axes=(_QKV, _QKV), out=_SCORES, sums=("d",))
    out_axes = ("b", None, "h", None, "d") if grouped_out else _QKV
    return local_apply(functools.partial(_weigh, grouped_out=grouped_out), v, scores, mask,
                       axes=(_QKV, _SCORES, _MASK), out=out_axes)


def _scores(k, q, scale):
    b, c, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, c, hkv, h // hkv, d)
    return torch.einsum("bcgrd,bsgd->bgrcs", qg, k).to(torch.float32) * scale


def _weigh(v, scores, mask, grouped_out: bool):
    scores = torch.where(mask[:, None, None, :, :], scores, _NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrcs,bsgd->bcgrd", w, v)
    if grouped_out:
        return out
    b, c, g, r, d = out.shape
    return out.reshape(b, c, g * r, d)


def _project_qkv(params, x, cfg: ModelConfig, positions, dtype):
    q = _split_heads(dense(params["wq"], x, dtype), cfg.num_heads, cfg.head_dim)
    k = _split_heads(dense(params["wk"], x, dtype), cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(dense(params["wv"], x, dtype), cfg.num_kv_heads, cfg.head_dim)
    if "q_norm" in params:
        q = rms_norm(params["q_norm"], q)
        k = rms_norm(params["k_norm"], k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(
    params,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (S,)
    cfg: ModelConfig,
    window: int,  # <= 0 means full causal
    causal: bool = True,  # False => bidirectional (the Whisper encoder)
) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention, query-chunked;
    ``causal=False`` lets every position see every other (RoPE still
    applies, as in the reference)."""
    dtype = x.dtype
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions[None, :], dtype)
    scale = cfg.head_dim**-0.5

    chunk = min(cfg.attn_chunk, s)
    if s % chunk != 0:
        chunk = s  # fallback: single chunk (smoke-size sequences)
    outs = []
    for c0 in range(0, s, chunk):
        pos_i = positions[c0 : c0 + chunk]
        rel = pos_i[:, None] - positions[None, :]
        visible = rel >= 0 if causal else torch.ones_like(rel, dtype=torch.bool)
        in_window = torch.abs(rel) < window if window > 0 else torch.ones_like(visible)
        mask = (visible & in_window)[None].expand(b, chunk, s)
        outs.append(_gqa_attend(q[:, c0 : c0 + chunk], k, v, mask, scale))
    out = unshard_for_merge(torch.cat(outs, dim=1), 2, 4).reshape(b, s, cfg.q_dim)
    return dense(params["wo"], out, dtype)


def cross_kv(params, memory: torch.Tensor, cfg: ModelConfig, dtype=torch.bfloat16):
    """The cross-attention K/V of the (fixed) memory, (B, M, Hkv, hd) each,
    projected once a request so that decode steps skip the (B, M, D)
    projections."""
    k = _split_heads(dense(params["wk"], memory.to(dtype), dtype), cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(dense(params["wv"], memory.to(dtype), dtype), cfg.num_kv_heads, cfg.head_dim)
    return k, v


def _cross_attend(params, x, k, v, cfg: ModelConfig):
    dtype = x.dtype
    b, s, _ = x.shape
    q = _split_heads(dense(params["wq"], x, dtype), cfg.num_heads, cfg.head_dim)
    mask = torch.ones((b, s, k.shape[1]), dtype=torch.bool, device=x.device)
    out = _gqa_attend(q, k, v, mask, cfg.head_dim**-0.5)
    return dense(params["wo"], unshard_for_merge(out, 2, 4).reshape(b, s, cfg.q_dim), dtype)


def cross_attention_cached(
    params,
    x: torch.Tensor,  # (B, S, D) queries
    k: torch.Tensor,  # (B, M, Hkv, hd) from `cross_kv`
    v: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """Cross-attention against precomputed K/V (cast to ``x``'s dtype)."""
    return _cross_attend(params, x, k.to(x.dtype), v.to(x.dtype), cfg)


def cross_attention(
    params,
    x: torch.Tensor,  # (B, S, D) queries
    memory: torch.Tensor,  # (B, M, D) keys/values source (image / encoder output)
    cfg: ModelConfig,
) -> torch.Tensor:
    """Cross-attention from ``x`` to ``memory``, both in ``x``'s dtype."""
    dtype = x.dtype
    k = _split_heads(dense(params["wk"], memory, dtype), cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(dense(params["wv"], memory, dtype), cfg.num_kv_heads, cfg.head_dim)
    return _cross_attend(params, x, k, v, cfg)


# --------------------------------------------------------------------------
# Decode path
# --------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, Hkv, hd)
    v: torch.Tensor  # (B, S_cache, Hkv, hd)


def init_kv_cache(cfg: ModelConfig, batch: int, seq: int, window, dtype=torch.bfloat16, device=None):
    """A zero cache of ``min(seq, window)`` slots (``seq`` for no window);
    ``device=None`` means the card."""
    s_cache = min(seq, window) if (window and window > 0) else seq
    shape = (batch, s_cache, cfg.num_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev))


def attention_decode(
    params,
    x: torch.Tensor,  # (B, 1, D) the new token's activations
    cache: KVCache,
    pos: int,  # absolute position of the new token
    cfg: ModelConfig,
    window: int = 0,  # mask width (0 = full causal)
    ring: bool = False,  # True => cache is a ring buffer of size < pos range
) -> tuple[torch.Tensor, KVCache]:
    """One-token causal attention against a KV cache.

    Two cache disciplines:
    * ``ring=False``: cache length covers positions [0, s_cache); the new
      token is written at slot ``min(pos, s_cache - 1)`` and masked by
      ``window`` if set.
    * ``ring=True``: cache is a circular buffer (sliding-window layers at
      long context); slot ``pos % s_cache``, everything resident is visible.

    Unlike the reference, which returns a new cache, the new token's K/V
    are written into ``cache`` in place (no copy of the cache a step); the
    returned cache is the same tensors.
    """
    pos = int(pos)
    dtype = x.dtype
    b = x.shape[0]
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions, dtype)
    s_cache = cache.k.shape[1]
    slot = (pos % s_cache) if ring else min(pos, s_cache - 1)
    cache.k[:, slot : slot + 1] = k_new.to(cache.k.dtype)
    cache.v[:, slot : slot + 1] = v_new.to(cache.v.dtype)
    if ring:
        # windowed ring caches are small by construction: not pinned
        kf, vf = cache.k.to(dtype), cache.v.to(dtype)
    else:
        # pin K/V to the cache layout (batch -> dp, head_dim -> tp), as the
        # reference does: the scores contract the tp-sharded head_dim where
        # the cache lies, and only they are reduced
        kf = constrain(cache.k.to(dtype), ("dp", "sp", None, "tp"))
        vf = constrain(cache.v.to(dtype), ("dp", "sp", None, "tp"))
    idx = torch.arange(s_cache, device=x.device)
    if ring:
        age = (slot - idx) % s_cache  # 0 = newest entry
        valid = age <= min(pos, s_cache - 1)
    else:
        valid = idx <= pos
        if window > 0:
            valid = valid & (pos - idx < window)
    mask = valid[None, None, :].expand(b, 1, s_cache)
    out = _gqa_attend(q, kf, vf, mask, cfg.head_dim**-0.5, grouped_out=True)
    # (g, r, hd) merged with the KV heads outermost (wo's row order), a
    # sharded head_dim gathered first (B x q_dim: a token's worth)
    out = unshard_for_merge(out, 2, 5).reshape(b, 1, cfg.q_dim)
    return out @ params["wo"]["w"].to(dtype), cache
