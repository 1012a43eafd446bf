"""Model assembly: the ``hybrid`` family (RecurrentGemma).

The counterpart of the reference's ``repro.models.lm`` for the hybrid
family only: an unrolled (rglru, rglru, window-attn) pattern, each block
followed by a SwiGLU FFN. The other families (dense, moe, ssm, vlm, audio)
raise `NotImplementedError` until they are ported (ROADMAP A-11).

Parameters are plain nested dicts (and a list of blocks) of tensors, with
keys one-to-one with the reference's pytree: ``{"embed": {"w"},
"final_norm": {"scale"}, "unembed": {"w"}, "blocks": [...]}``, each block
``{"ln1", "mix", "ln2", "ffn"}`` (RG-LRU) or ``{"ln1", "attn", "ln2",
"ffn"}`` (attention). They are float32 masters, cast to ``cfg.dtype`` at
use. `repro_torch.interop.lm_params_from_numpy` carries the reference's
parameters over.

Public entry points: ``init_params``, ``param_count``, ``forward``,
``loss_fn``, ``init_decode_state``, ``decode_step``.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
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

__all__ = ["init_params", "param_count", "forward", "loss_fn", "init_decode_state", "decode_step"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP A-11); the port has 'hybrid'"
        )


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _init_attn_block(gen, cfg: ModelConfig, device, dtype):
    return {
        "ln1": rms_norm_init(cfg.d_model, device, dtype),
        "attn": attn_lib.init_attention(gen, cfg, device, dtype),
        "ln2": rms_norm_init(cfg.d_model, device, dtype),
        "ffn": swiglu_init(gen, cfg.d_model, cfg.d_ff, device, dtype),
    }


def _init_rglru_block(gen, cfg: ModelConfig, device, dtype):
    return {
        "ln1": rms_norm_init(cfg.d_model, device, dtype),
        "mix": rglru_lib.init_rglru(gen, cfg, device, dtype),
        "ln2": rms_norm_init(cfg.d_model, device, dtype),
        "ffn": swiglu_init(gen, cfg.d_model, cfg.d_ff, device, dtype),
    }


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


def _attn_ffn_block(p, x, positions, cfg: ModelConfig, window: int):
    """Self-attention then FFN, each a residual branch."""
    x = x + attn_lib.attention(p["attn"], rms_norm(p["ln1"], x), positions, cfg, window)
    return x + swiglu(p["ffn"], rms_norm(p["ln2"], x), x.dtype)


def _logits(params, x, cfg: ModelConfig, dtype):
    x = rms_norm(params["final_norm"], x)
    unembed = (params["embed"]["w"] if cfg.tie_embeddings else params["unembed"]["w"]).to(dtype)
    logits = torch.einsum("bsd,vd->bsv", x, unembed)
    return softcap(logits.to(torch.float32), cfg.logit_softcap)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *, last_only: bool = False):
    """tokens (B, S) -> (logits (B, S, V) float32, aux). ``last_only``
    computes logits for the final position only (prefill serving
    semantics: the slice comes before the final norm and the unembed).
    ``aux`` is the reference's MoE auxiliary loss, 0 for this family."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    s = tokens.shape[1]
    x = embed(params["embed"], tokens, dtype)
    positions = torch.arange(s, device=tokens.device)
    pat = cfg.block_pattern
    for i, p in enumerate(params["blocks"]):
        if pat[i % len(pat)] == "rglru":
            x = x + rglru_lib.rglru_forward(p["mix"], rms_norm(p["ln1"], x), cfg)
            x = x + swiglu(p["ffn"], rms_norm(p["ln2"], x), dtype)
        else:
            x = _attn_ffn_block(p, x, positions, cfg, cfg.sliding_window)
    if last_only:
        x = x[:, -1:, :]
    return _logits(params, x, cfg, dtype), torch.zeros((), dtype=torch.float32, device=tokens.device)


def loss_fn(params, batch, cfg: ModelConfig, z_loss: float = 1e-4):
    """Next-token cross entropy + z-loss (+ the MoE aux, 0 here): ``batch =
    {"tokens": (B, S)}`` -> (total, {"ce", "z_loss", "moe_aux"}), 0-dim
    float32 tensors.

    The reference's arithmetic: the LSE is shifted by the row max, whose
    gradient is stopped; the z-loss is ``z_loss * mean(lse^2)``. The
    reference takes the target logit as a masked sum over the vocabulary
    (to suit GSPMD's sharded vocab); a sum of zeros and one logit is that
    logit exactly, so `torch.gather` gives the same bits without the
    (B, S, V) mask.
    """
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens, cfg)
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
    """Zero decode state for ``batch`` sequences of up to ``seq`` tokens:
    ``{"layers": [...]}``, an `RGLRUState` (float32) for each RG-LRU layer
    and a `KVCache` of ``min(seq, window)`` slots in ``dtype`` for each
    attention layer. ``device=None`` means the card."""
    _check_family(cfg)
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
    in place (see `attention_decode`); the RG-LRU states are replaced."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    x = embed(params["embed"], tokens, dtype)
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

