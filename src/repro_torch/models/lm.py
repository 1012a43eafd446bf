"""Model assembly: the ``dense``, ``moe`` and ``hybrid`` families.

The counterpart of the reference's ``repro.models.lm`` for three of its
block layouts:

* dense / moe : uniform decoder blocks (attention + SwiGLU or MoE FFN);
                gemma3's 5:1 local:global pattern is a per-layer window
                (`layer_windows`, 0 = global). The reference scans the
                blocks over a stacked layer axis; the port loops over a
                list of per-layer dicts.
* hybrid      : an unrolled (rglru, rglru, window-attn) pattern, each block
                followed by a SwiGLU FFN (RecurrentGemma).

The ``ssm``, ``vlm`` and ``audio`` families raise `NotImplementedError`
until they are ported (ROADMAP A-11).

Parameters are plain nested dicts (and a list of blocks) of tensors, with
keys one-to-one with the reference's pytree: ``{"embed": {"w"},
"final_norm": {"scale"}, "unembed": {"w"}, "blocks": [...]}``, each block
``{"ln1", "mix", "ln2", "ffn"}`` (RG-LRU) or ``{"ln1", "attn", "ln2",
"ffn"}`` (attention; ``ffn`` holds the MoE's ``router``, ``wi``, ``wg``,
``wo`` in the moe family). They are float32 masters, cast to ``cfg.dtype``
at use. `repro_torch.interop.lm_params_from_numpy` carries the reference's
parameters over (its dense/moe blocks split along the stacked layer axis).

Where the reference takes a PRNG key (the MoE routers' draws), the port
takes ``generator=``, a `torch.Generator` on the tokens' device. `forward`
draws every layer from it in turn (``None``: one generator seeded 0, as
the reference splits ``PRNGKey(0)``); `decode_step` gives each layer a
generator seeded 0, as the reference passes each layer no key.

Public entry points: ``init_params``, ``param_count``, ``forward``,
``loss_fn``, ``init_decode_state``, ``decode_step``, ``layer_windows``.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models.layers import (
    embed,
    embed_init,
    rms_norm,
    rms_norm_init,
    softcap,
    swiglu,
    swiglu_init,
    torch_dtype,
)
from repro_torch.tree import leaves

__all__ = [
    "init_params",
    "forward",
    "loss_fn",
    "init_decode_state",
    "decode_step",
    "param_count",
    "layer_windows",
]

_FAMILIES = ("dense", "moe", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP A-11); the port has {_FAMILIES}"
        )


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _init_ffn(gen, cfg: ModelConfig, device, dtype):
    if cfg.is_moe:
        return moe_lib.init_moe(gen, cfg, device, dtype)
    return swiglu_init(gen, cfg.d_model, cfg.d_ff, device, dtype)


def _init_attn_block(gen, cfg: ModelConfig, device, dtype):
    return {
        "ln1": rms_norm_init(cfg.d_model, device, dtype),
        "attn": attn_lib.init_attention(gen, cfg, device, dtype),
        "ln2": rms_norm_init(cfg.d_model, device, dtype),
        "ffn": _init_ffn(gen, cfg, device, dtype),
    }


def _init_rglru_block(gen, cfg: ModelConfig, device, dtype):
    return {
        "ln1": rms_norm_init(cfg.d_model, device, dtype),
        "mix": rglru_lib.init_rglru(gen, cfg, device, dtype),
        "ln2": rms_norm_init(cfg.d_model, device, dtype),
        "ffn": swiglu_init(gen, cfg.d_model, cfg.d_ff, device, dtype),
    }


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = full/global) — gemma3's 5:1 pattern:
    layer i is global when ``i % global_period == global_period - 1``."""
    if cfg.global_period > 0:
        return [
            0 if (i % cfg.global_period == cfg.global_period - 1) else cfg.sliding_window
            for i in range(cfg.num_layers)
        ]
    return [cfg.sliding_window] * cfg.num_layers


def init_params(cfg: ModelConfig, seed_or_generator: int | torch.Generator = 0, device=None):
    """Random float32 master parameters, drawn on ``device`` (``None`` means
    the card) from a `torch.Generator` (or one seeded with the int given).
    On ``device="meta"`` nothing is drawn or allocated: the shapes alone,
    for `param_count` of a full config."""
    _check_family(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = None
    elif isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
        if gen.device.type != dev.type:
            raise ValueError(f"the generator lies on {gen.device}, the parameters go to {dev}")
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed_or_generator))
    dtype = torch_dtype(cfg.param_dtype)
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dev, dtype),
        "final_norm": rms_norm_init(cfg.d_model, dev, dtype),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dev, dtype)
    if cfg.family in ("dense", "moe"):
        params["blocks"] = [_init_attn_block(gen, cfg, dev, dtype) for _ in range(cfg.num_layers)]
        return params
    pat = cfg.block_pattern
    params["blocks"] = [
        _init_rglru_block(gen, cfg, dev, dtype)
        if pat[i % len(pat)] == "rglru"
        else _init_attn_block(gen, cfg, dev, dtype)
        for i in range(cfg.num_layers)
    ]
    return params


def param_count(params) -> int:
    return int(sum(t.numel() for t in leaves(params)))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _attn_ffn_block(p, x, positions, cfg: ModelConfig, window: int, generator=None):
    """Self-attention then FFN (SwiGLU, or the MoE drawing from
    ``generator``), each a residual branch: (x, the MoE's aux loss or None)."""
    x = x + attn_lib.attention(p["attn"], rms_norm(p["ln1"], x), positions, cfg, window)
    y = rms_norm(p["ln2"], x)
    if cfg.is_moe:
        out, aux = moe_lib.moe_ffn(p["ffn"], y, cfg, generator)
        return x + out, aux
    return x + swiglu(p["ffn"], y, x.dtype), None


def _logits(params, x, cfg: ModelConfig, dtype):
    x = rms_norm(params["final_norm"], x)
    unembed = (params["embed"]["w"] if cfg.tie_embeddings else params["unembed"]["w"]).to(dtype)
    logits = torch.einsum("bsd,vd->bsv", x, unembed)
    return softcap(logits.to(torch.float32), cfg.logit_softcap)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *, generator: torch.Generator | None = None,
            last_only: bool = False):
    """tokens (B, S) -> (logits (B, S, V) float32, aux). ``last_only``
    computes logits for the final position only (prefill serving
    semantics: the slice comes before the final norm and the unembed).
    ``aux`` is the sum over layers of the MoE's load-balance loss (0 for
    the other families). The MoE routers draw from ``generator``, layer
    after layer (``None``: a generator seeded 0)."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    s = tokens.shape[1]
    x = embed(params["embed"], tokens, dtype)
    positions = torch.arange(s, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cfg.family in ("dense", "moe"):
        if cfg.is_moe and generator is None:
            generator = torch.Generator(device=tokens.device).manual_seed(0)
        for p, w in zip(params["blocks"], layer_windows(cfg)):
            x, a = _attn_ffn_block(p, x, positions, cfg, w, generator)
            if a is not None:
                aux = aux + a
    else:
        pat = cfg.block_pattern
        for i, p in enumerate(params["blocks"]):
            if pat[i % len(pat)] == "rglru":
                x = x + rglru_lib.rglru_forward(p["mix"], rms_norm(p["ln1"], x), cfg)
                x = x + swiglu(p["ffn"], rms_norm(p["ln2"], x), dtype)
            else:
                x, _ = _attn_ffn_block(p, x, positions, cfg, cfg.sliding_window)
    if last_only:
        x = x[:, -1:, :]
    return _logits(params, x, cfg, dtype), aux


def loss_fn(params, batch, cfg: ModelConfig, generator: torch.Generator | None = None, z_loss: float = 1e-4):
    """Next-token cross entropy + z-loss + ``cfg.aux_loss_weight`` x the
    MoE aux: ``batch = {"tokens": (B, S)}`` -> (total, {"ce", "z_loss",
    "moe_aux"}), 0-dim float32 tensors. ``generator`` feeds `forward`.

    The reference's arithmetic: the LSE is shifted by the row max, whose
    gradient is stopped; the z-loss is ``z_loss * mean(lse^2)``. The
    reference takes the target logit as a masked sum over the vocabulary
    (to suit GSPMD's sharded vocab); a sum of zeros and one logit is that
    logit exactly, so `torch.gather` gives the same bits without the
    (B, S, V) mask.
    """
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens, cfg, generator=generator)
    logits = logits[:, :-1]
    targets = tokens[:, 1:].long()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    tgt_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = torch.mean(lse - tgt_logit)
    zl = z_loss * torch.mean(lse**2)
    total = ce + zl + cfg.aux_loss_weight * aux
    return total, {"ce": ce, "z_loss": zl, "moe_aux": aux}


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, seq: int, dtype=torch.bfloat16, device=None):
    """Zero decode state for ``batch`` sequences of up to ``seq`` tokens,
    in ``dtype`` but for the RG-LRU states (float32); ``device=None`` means
    the card. Dense/moe: ``{"kv": KVCache}`` of (L, B, seq, Hkv, hd)
    tensors, full length in every layer (a windowed layer masks its cache,
    as in the reference). Hybrid: ``{"layers": [...]}``, an `RGLRUState`
    for each RG-LRU layer and a `KVCache` ring of ``min(seq, window)``
    slots for each attention layer."""
    _check_family(cfg)
    if cfg.family in ("dense", "moe"):
        dev = resolve_device(device)
        shape = (cfg.num_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim)
        return {"kv": attn_lib.KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                                       torch.zeros(shape, dtype=dtype, device=dev))}
    pat = cfg.block_pattern
    states = []
    for i in range(cfg.num_layers):
        if pat[i % len(pat)] == "rglru":
            states.append(rglru_lib.init_rglru_state(cfg, batch, torch.float32, device))
        else:
            states.append(attn_lib.init_kv_cache(cfg, batch, seq, cfg.sliding_window, dtype, device))
    return {"layers": states}


def decode_step(params, state, tokens: torch.Tensor, pos: int, cfg: ModelConfig):
    """One new token: tokens (B, 1) at absolute position ``pos`` -> (logits
    (B, 1, V) float32, state'). The attention layers' KV caches are updated
    in place (see `attention_decode`); the RG-LRU states are replaced.

    In the moe family each token is its own routing group of one (capacity
    1, a Sinkhorn router balances over N = 1), as in the reference, so
    decode is not the forward pass's routing; each layer's spar_sink draws
    come from a generator seeded 0."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    x = embed(params["embed"], tokens, dtype)
    if cfg.family in ("dense", "moe"):
        kv = state["kv"]
        for i, (p, w) in enumerate(zip(params["blocks"], layer_windows(cfg))):
            # the layer's cache is a view of the stacked one: written in place
            h, _ = attn_lib.attention_decode(
                p["attn"], rms_norm(p["ln1"], x), attn_lib.KVCache(kv.k[i], kv.v[i]), pos, cfg, window=w
            )
            x = x + h
            y = rms_norm(p["ln2"], x)
            x = x + (moe_lib.moe_ffn(p["ffn"], y, cfg, None)[0] if cfg.is_moe else swiglu(p["ffn"], y, dtype))
        return _logits(params, x, cfg, dtype), {"kv": kv}
    pat = cfg.block_pattern
    new_states = []
    for i, p in enumerate(params["blocks"]):
        st = state["layers"][i]
        if pat[i % len(pat)] == "rglru":
            h, st = rglru_lib.rglru_decode(p["mix"], rms_norm(p["ln1"], x), st, cfg)
        else:
            # hybrid attention caches are sized min(seq, window): always a ring
            h, st = attn_lib.attention_decode(
                p["attn"], rms_norm(p["ln1"], x), st, pos, cfg, window=cfg.sliding_window, ring=True
            )
        x = x + h
        x = x + swiglu(p["ffn"], rms_norm(p["ln2"], x), dtype)
        new_states.append(st)
    return _logits(params, x, cfg, dtype), {"layers": new_states}

