"""Model assembly for all ten of the reference's architectures.

The counterpart of the reference's ``repro.models.lm``: one functional LM
with a block layout per family. The reference scans stacked blocks; the
port loops over lists of per-layer dicts.

* dense / moe : uniform decoder blocks (attention + SwiGLU or MoE FFN);
                gemma3's 5:1 local:global pattern is a per-layer window
                (`layer_windows`, 0 = global).
* ssm         : Mamba-2 blocks (norm -> SSD -> residual; `models.ssm`).
* hybrid      : an unrolled (rglru, rglru, window-attn) pattern, each block
                followed by a SwiGLU FFN (RecurrentGemma).
* vlm         : groups of (period - 1) self-attention blocks and one
                cross-attention block (SwiGLU FFN) over image patch
                embeddings, a stub input ``extras={"images": (B, M, D)}``.
* audio       : Whisper's encoder-decoder: a bidirectional encoder over stub
                frame embeddings (``extras={"frames": (B, F, D)}``), then
                decoder blocks with cross-attention to its output.

In the audio family the reference's `forward` runs a decoder block's
self-attention, FFN, then cross-attention, and its `decode_step`
self-attention, cross-attention, then FFN (Whisper's order). The port
copies both as they are, so its decode differs from its forward as the
reference's does (ROADMAP C-15).

Parameters are plain nested dicts and lists of tensors, with keys one-to-one
with the reference's pytree: ``{"embed": {"w"}, "final_norm": {"scale"},
"unembed": {"w"}, "blocks": [...]}``; a block is ``{"ln1", "attn", "ln2",
"ffn"}`` (attention; ``ffn`` holds the MoE's ``router``, ``wi``, ``wg``,
``wo`` in the moe family), ``{"ln1", "mix", "ln2", "ffn"}`` (RG-LRU) or
``{"ln1", "ssm"}``. The vlm family's ``blocks`` is a list of groups, each a
list of ``period - 1`` attention blocks, beside ``cross_blocks``; the audio
family's decoder blocks add ``ln_x`` and ``cross``, beside ``encoder`` and
``enc_norm``. They are float32 masters, cast to ``cfg.dtype`` at use.
`repro_torch.interop.lm_params_from_numpy` carries the reference's
parameters over (its stacked blocks split along their layer axes).

Where the reference takes a PRNG key (the MoE routers' draws), the port
takes ``generator=``, a `torch.Generator` on the tokens' device. `forward`
draws every layer from it in turn (``None``: one generator seeded 0, as
the reference splits ``PRNGKey(0)``); `decode_step` gives each layer a
generator seeded 0, as the reference passes each layer no key.

``cfg.remat`` recomputes each layer body in the backward pass where the
reference's ``_maybe_ckpt`` does (`_remat`): the dense, moe, ssm, vlm (a
group at a time) and audio bodies and the encoder's, not the hybrid's.

Public entry points: ``init_params``, ``param_count``, ``forward``,
``loss_fn``, ``init_decode_state``, ``fill_cross_cache``, ``decode_step``,
``layer_windows``.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch._device import generator_at, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import KVCache
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
    "decode_step",
    "fill_cross_cache",
    "forward",
    "init_decode_state",
    "init_params",
    "layer_windows",
    "loss_fn",
    "param_count",
]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _init_ffn(gen, cfg: ModelConfig, device, dtype):
    if cfg.is_moe:
        return moe_lib.init_moe(gen, cfg, device, dtype)
    return swiglu_init(gen, cfg.d_model, cfg.d_ff, device, dtype)


def _init_attn_block(gen, cfg: ModelConfig, device, dtype, cross: bool = False):
    return {
        "ln1": rms_norm_init(cfg.d_model, device, dtype),
        "attn": attn_lib.init_attention(gen, cfg, device, dtype, cross=cross),
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


def _init_decoder_block(gen, cfg: ModelConfig, device, dtype):
    """The audio family's decoder block: an attention block plus ``ln_x``
    and its cross-attention."""
    p = _init_attn_block(gen, cfg, device, dtype)
    p["ln_x"] = rms_norm_init(cfg.d_model, device, dtype)
    p["cross"] = attn_lib.init_attention(gen, cfg, device, dtype, cross=True)
    return p


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = full/global) — gemma3's 5:1 pattern:
    layer i is global when ``i % global_period == global_period - 1``."""
    if cfg.global_period > 0:
        return [
            0 if (i % cfg.global_period == cfg.global_period - 1) else cfg.sliding_window
            for i in range(cfg.num_layers)
        ]
    return [cfg.sliding_window] * cfg.num_layers


def init_params(cfg: ModelConfig, seed_or_generator: int | torch.Generator = 0, device=None, place=None):
    """Random float32 master parameters, drawn on ``device`` (``None`` means
    the card) from a `torch.Generator` (or one seeded with the int given).
    On ``device="meta"`` nothing is drawn or allocated: the shapes alone,
    for `param_count` of a full config.

    ``place(path, subtree)``, if given, receives each top-level entry and
    each layer's block as soon as it is drawn (``path`` its keys and list
    indices from the root) and returns what the tree keeps in its place:
    the sharded init lays each one out on its mesh and frees the drawn
    whole, so that no more than one entry is ever whole on the device.
    The draws are the same with or without it."""
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
    put = place or (lambda path, tree: tree)
    params = {
        "embed": put(("embed",), embed_init(gen, cfg.vocab_size, cfg.d_model, dev, dtype)),
        "final_norm": put(("final_norm",), rms_norm_init(cfg.d_model, dev, dtype)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = put(("unembed",), embed_init(gen, cfg.vocab_size, cfg.d_model, dev, dtype))
    fam = cfg.family
    if fam in ("dense", "moe"):
        params["blocks"] = [put(("blocks", i), _init_attn_block(gen, cfg, dev, dtype)) for i in range(cfg.num_layers)]
    elif fam == "ssm":
        params["blocks"] = [
            put(("blocks", i), {"ln1": rms_norm_init(cfg.d_model, dev, dtype),
                                "ssm": ssm_lib.init_ssm(gen, cfg, dev, dtype)})
            for i in range(cfg.num_layers)
        ]
    elif fam == "hybrid":
        pat = cfg.block_pattern
        params["blocks"] = [
            put(("blocks", i), _init_rglru_block(gen, cfg, dev, dtype)
                if pat[i % len(pat)] == "rglru"
                else _init_attn_block(gen, cfg, dev, dtype))
            for i in range(cfg.num_layers)
        ]
    elif fam == "vlm":
        period = cfg.cross_attn_period
        n_groups = cfg.num_layers // period
        params["blocks"] = [
            [put(("blocks", g, i), _init_attn_block(gen, cfg, dev, dtype)) for i in range(period - 1)]
            for g in range(n_groups)
        ]
        params["cross_blocks"] = [put(("cross_blocks", g), _init_attn_block(gen, cfg, dev, dtype, cross=True))
                                  for g in range(n_groups)]
    elif fam == "audio":
        params["encoder"] = [put(("encoder", i), _init_attn_block(gen, cfg, dev, dtype))
                             for i in range(cfg.encoder_layers)]
        params["enc_norm"] = put(("enc_norm",), rms_norm_init(cfg.d_model, dev, dtype))
        params["blocks"] = [put(("blocks", i), _init_decoder_block(gen, cfg, dev, dtype))
                            for i in range(cfg.num_layers)]
    else:
        raise ValueError(fam)
    return params


def param_count(params) -> int:
    return int(sum(t.numel() for t in leaves(params)))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

# the matrix products without batch dimensions: what "dots" saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``: keep
    the outputs of 2-d matrix products (a ``x @ w`` of any rank lowers to
    one); batched products (``bmm``, the attention's) and the rest are
    recomputed."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn, *args, generator: torch.Generator | None = None):
    """``fn(*args)``, or ``fn(*args, generator)``, under ``cfg.remat`` (the
    reference's ``_maybe_ckpt``). ``"none"``, or no gradient being
    recorded, calls it. ``"full"`` keeps its inputs and recomputes the
    rest in the backward pass (`torch.utils.checkpoint`, non-reentrant);
    ``"dots"`` also keeps what `_save_dots` names.

    The recomputation must draw what the first run drew: the checkpoint
    restores the global RNG, not an explicit generator. So the first run
    draws from ``generator`` itself, which advances as without remat, and
    the recomputation from a copy at the state ``generator`` had before
    the first run (`generator_at`)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args) if generator is None else fn(*args, generator)
    run = fn
    if generator is not None:
        state = generator.get_state()
        runs = []

        def run(*a):
            runs.append(None)
            return fn(*a, generator if len(runs) == 1 else generator_at(generator, state))

    context = {}
    if cfg.remat == "dots":
        context["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(run, *args, use_reentrant=False, **context)


def _attn_ffn_block(p, x, positions, cfg: ModelConfig, window: int, generator=None, causal: bool = True):
    """Self-attention then FFN (SwiGLU, or the MoE drawing from
    ``generator``), each a residual branch: (x, the MoE's aux loss or None)."""
    x = x + attn_lib.attention(p["attn"], rms_norm(p["ln1"], x), positions, cfg, window, causal)
    y = rms_norm(p["ln2"], x)
    if cfg.is_moe:
        out, aux = moe_lib.moe_ffn(p["ffn"], y, cfg, generator)
        return x + out, aux
    return x + swiglu(p["ffn"], y, x.dtype), None


def _ssm_block(p, x, cfg: ModelConfig):
    return x + ssm_lib.ssm_forward(p["ssm"], rms_norm(p["ln1"], x), cfg)


def _cross_block(p, x, memory, cfg: ModelConfig):
    """The vlm family's image layer: cross-attention, then SwiGLU."""
    x = x + attn_lib.cross_attention(p["attn"], rms_norm(p["ln1"], x), memory, cfg)
    return x + swiglu(p["ffn"], rms_norm(p["ln2"], x), x.dtype)


def _vlm_group(p_self, p_cross, x, memory, positions, cfg: ModelConfig):
    for p in p_self:
        x, _ = _attn_ffn_block(p, x, positions, cfg, 0)
    return _cross_block(p_cross, x, memory, cfg)


def _decoder_block(p, x, enc, positions, cfg: ModelConfig):
    """The audio family's decoder block as the reference's `forward` runs
    it: self-attention, FFN, then cross-attention (C-15)."""
    x, _ = _attn_ffn_block(p, x, positions, cfg, 0)
    return x + attn_lib.cross_attention(p["cross"], rms_norm(p["ln_x"], x), enc, cfg)


def _encoder_block(p, x, positions, cfg: ModelConfig):
    return _attn_ffn_block(p, x, positions, cfg, 0, causal=False)[0]


def _sinusoidal(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[:, None].to(torch.float32) * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _encode_audio(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, F, D)."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    x = frames + _sinusoidal(positions, cfg.d_model, frames.dtype)[None]
    for p in params["encoder"]:
        x = _remat(cfg, _encoder_block, p, x, positions, cfg)
    return rms_norm(params["enc_norm"], x)


def _logits(params, x, cfg: ModelConfig, dtype):
    x = rms_norm(params["final_norm"], x)
    unembed = (params["embed"]["w"] if cfg.tie_embeddings else params["unembed"]["w"]).to(dtype)
    logits = torch.einsum("bsd,vd->bsv", x, unembed)
    return softcap(logits.to(torch.float32), cfg.logit_softcap)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, extras=None, *,
            generator: torch.Generator | None = None, last_only: bool = False):
    """tokens (B, S) -> (logits (B, S, V) float32, aux). ``extras`` carries
    the stub modality inputs: ``{"images": (B, M, D)}`` (vlm) or
    ``{"frames": (B, F, D)}`` (audio). ``last_only`` computes logits for
    the final position only (prefill serving semantics: the slice comes
    before the final norm and the unembed). ``aux`` is the sum over layers
    of the MoE's load-balance loss (0 for the other families). The MoE
    routers draw from ``generator``, layer after layer (``None``: a
    generator seeded 0)."""
    dtype = torch_dtype(cfg.dtype)
    s = tokens.shape[1]
    x = embed(params["embed"], tokens, dtype)
    # re-assert the batch sharding after the embedding gather (the
    # reference's G5): without it the activations run unsharded on the batch
    x = constrain(x, ("dp", None, None))
    positions = torch.arange(s, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    fam = cfg.family
    if fam in ("dense", "moe"):
        if cfg.is_moe and generator is None and tokens.device.type != "meta":
            generator = torch.Generator(device=tokens.device).manual_seed(0)
        for p, w in zip(params["blocks"], layer_windows(cfg)):
            x, a = _remat(cfg, _attn_ffn_block, p, x, positions, cfg, w,
                          generator=generator if cfg.is_moe else None)
            if a is not None:
                aux = aux + a
    elif fam == "ssm":
        for p in params["blocks"]:
            x = _remat(cfg, _ssm_block, p, x, cfg)
    elif fam == "hybrid":
        pat = cfg.block_pattern
        for i, p in enumerate(params["blocks"]):
            if pat[i % len(pat)] == "rglru":
                x = x + rglru_lib.rglru_forward(p["mix"], rms_norm(p["ln1"], x), cfg)
                x = x + swiglu(p["ffn"], rms_norm(p["ln2"], x), dtype)
            else:
                x, _ = _attn_ffn_block(p, x, positions, cfg, cfg.sliding_window)
    elif fam == "vlm":
        memory = extras["images"].to(dtype)
        for p_self, p_cross in zip(params["blocks"], params["cross_blocks"]):
            x = _remat(cfg, _vlm_group, p_self, p_cross, x, memory, positions, cfg)
    elif fam == "audio":
        enc = _encode_audio(params, extras["frames"].to(dtype), cfg)
        x = x + _sinusoidal(positions, cfg.d_model, dtype)[None]
        for p in params["blocks"]:
            x = _remat(cfg, _decoder_block, p, x, enc, positions, cfg)
    else:
        raise ValueError(fam)
    if last_only:
        x = x[:, -1:, :]
    return _logits(params, x, cfg, dtype), aux


def loss_fn(params, batch, cfg: ModelConfig, generator: torch.Generator | None = None, z_loss: float = 1e-4):
    """Next-token cross entropy + z-loss + ``cfg.aux_loss_weight`` x the
    MoE aux: ``batch = {"tokens": (B, S), ...}`` -> (total, {"ce",
    "z_loss", "moe_aux"}), 0-dim float32 tensors. The batch's other keys go
    to `forward` as ``extras``; ``generator`` feeds `forward`.

    The reference's arithmetic: the LSE is shifted by the row max, whose
    gradient is stopped; the z-loss is ``z_loss * mean(lse^2)``. The
    reference takes the target logit as a masked sum over the vocabulary
    (to suit GSPMD's sharded vocab); a sum of zeros and one logit is that
    logit exactly, so `torch.gather` gives the same bits without the
    (B, S, V) mask. DTensor logits (under a mesh) take the masked sum.
    """
    tokens = batch["tokens"]
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    logits, aux = forward(params, tokens, cfg, extras or None, generator=generator)
    logits = logits[:, :-1]
    targets = tokens[:, 1:].long()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    if isinstance(logits, DTensor):
        # the reference's iota mask summed over the (model-sharded) vocab:
        # DTensor has no sound rule for a gather along a sharded vocab
        vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
        tgt_logit = torch.sum(torch.where(vocab_iota == targets[..., None], logits, 0.0), dim=-1)
    else:
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
    in ``dtype`` but for the recurrent states (float32); ``device=None``
    means the card.

    * dense/moe: ``{"kv": KVCache}`` of (L, B, seq, Hkv, hd) tensors, full
      length in every layer (a windowed layer masks its cache, as in the
      reference);
    * ssm: ``{"ssm": SSMState}`` stacked on a leading layer axis;
    * hybrid: ``{"layers": [...]}``, an `RGLRUState` for each RG-LRU layer
      and a `KVCache` ring of ``min(seq, window)`` slots for each attention
      layer;
    * vlm: ``{"kv"}`` of (n_groups, period - 1, B, seq, Hkv, hd) tensors;
      audio: ``{"kv"}`` of (L, B, seq, Hkv, hd). With
      ``cfg.decode_cross_cache`` also ``{"cross"}``, the memory's K/V a
      cross-attention layer, (n_groups, B, M, Hkv, hd) or (L, B, F, Hkv,
      hd), which `fill_cross_cache` fills.
    """
    dev = resolve_device(device)

    def cache(*shape):
        return KVCache(torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev))

    heads = (cfg.num_kv_heads, cfg.head_dim)
    fam = cfg.family
    if fam in ("dense", "moe"):
        return {"kv": cache(cfg.num_layers, batch, seq, *heads)}
    if fam == "ssm":
        st = ssm_lib.init_ssm_state(cfg, batch, torch.float32, dev)
        return {"ssm": ssm_lib.SSMState(*(t.new_zeros((cfg.num_layers,) + t.shape) for t in st))}
    if fam == "hybrid":
        pat = cfg.block_pattern
        return {"layers": [
            rglru_lib.init_rglru_state(cfg, batch, torch.float32, dev)
            if pat[i % len(pat)] == "rglru"
            else attn_lib.init_kv_cache(cfg, batch, seq, cfg.sliding_window, dtype, dev)
            for i in range(cfg.num_layers)
        ]}
    if fam == "vlm":
        period = cfg.cross_attn_period
        n_groups = cfg.num_layers // period
        state = {"kv": cache(n_groups, period - 1, batch, seq, *heads)}
        if cfg.decode_cross_cache:
            state["cross"] = cache(n_groups, batch, cfg.num_image_tokens, *heads)
        return state
    if fam == "audio":
        state = {"kv": cache(cfg.num_layers, batch, seq, *heads)}
        if cfg.decode_cross_cache:
            state["cross"] = cache(cfg.num_layers, batch, cfg.num_frames, *heads)
        return state
    raise ValueError(fam)


def fill_cross_cache(params, cfg: ModelConfig, state, extras, dtype=torch.bfloat16):
    """``state`` with ``state["cross"]`` replaced by the memory's K/V in
    ``dtype`` (once a request): ``extras["images"]`` through each
    ``cross_blocks`` layer (vlm), ``extras["enc_out"]`` through each
    decoder block's ``cross`` (audio). A state without ``"cross"`` is
    returned as it is."""
    if "cross" not in state:
        return state
    if cfg.family == "vlm":
        pairs = [attn_lib.cross_kv(p["attn"], extras["images"], cfg, dtype) for p in params["cross_blocks"]]
    else:
        pairs = [attn_lib.cross_kv(p["cross"], extras["enc_out"], cfg, dtype) for p in params["blocks"]]
    state = dict(state)
    state["cross"] = KVCache(torch.stack([k for k, _ in pairs]), torch.stack([v for _, v in pairs]))
    return state


def _cross(p, y, state, i, memory, cfg: ModelConfig):
    """Layer i's cross-attention from ``y``: against the cached K/V when
    the state holds them, else against ``memory``."""
    if "cross" in state:
        return attn_lib.cross_attention_cached(p, y, state["cross"].k[i], state["cross"].v[i], cfg)
    return attn_lib.cross_attention(p, y, memory.to(y.dtype), cfg)


def decode_step(params, state, tokens: torch.Tensor, pos: int, cfg: ModelConfig, extras=None):
    """One new token: tokens (B, 1) at absolute position ``pos`` -> (logits
    (B, 1, V) float32, state'). The KV caches and the stacked SSM state are
    updated in place (see `attention_decode`); the RG-LRU states are
    replaced. Without a cross cache, the vlm and audio families attend to
    ``extras["images"]`` or ``extras["enc_out"]``.

    In the moe family each token is its own routing group of one (capacity
    1, a Sinkhorn router balances over N = 1), as in the reference, so
    decode is not the forward pass's routing; each layer's spar_sink draws
    come from a generator seeded 0. In the audio family a block runs
    cross-attention before its FFN, as in the reference's `decode_step`
    and unlike its `forward` (C-15)."""
    dtype = torch_dtype(cfg.dtype)
    x = embed(params["embed"], tokens, dtype)
    x = constrain(x, ("dp", None, None))  # see forward(): G5
    fam = cfg.family
    if fam in ("dense", "moe"):
        kv = state["kv"]
        for i, (p, w) in enumerate(zip(params["blocks"], layer_windows(cfg))):
            # the layer's cache is a view of the stacked one: written in place
            h, _ = attn_lib.attention_decode(
                p["attn"], rms_norm(p["ln1"], x), KVCache(kv.k[i], kv.v[i]), pos, cfg, window=w
            )
            x = x + h
            y = rms_norm(p["ln2"], x)
            x = x + (moe_lib.moe_ffn(p["ffn"], y, cfg, None)[0] if cfg.is_moe else swiglu(p["ffn"], y, dtype))
        return _logits(params, x, cfg, dtype), {"kv": kv}
    if fam == "ssm":
        st = state["ssm"]
        for i, p in enumerate(params["blocks"]):
            h, new = ssm_lib.ssm_decode(p["ssm"], rms_norm(p["ln1"], x), ssm_lib.SSMState(st.h[i], st.conv[i]), cfg)
            st.h[i].copy_(new.h)
            st.conv[i].copy_(new.conv)
            x = x + h
        return _logits(params, x, cfg, dtype), {"ssm": st}
    if fam == "hybrid":
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
    kv = state["kv"]
    if fam == "vlm":
        memory = None if "cross" in state else extras["images"]
        for g, (p_self, p_cross) in enumerate(zip(params["blocks"], params["cross_blocks"])):
            for j, p in enumerate(p_self):
                h, _ = attn_lib.attention_decode(
                    p["attn"], rms_norm(p["ln1"], x), KVCache(kv.k[g, j], kv.v[g, j]), pos, cfg
                )
                x = x + h
                x = x + swiglu(p["ffn"], rms_norm(p["ln2"], x), dtype)
            x = x + _cross(p_cross["attn"], rms_norm(p_cross["ln1"], x), state, g, memory, cfg)
            x = x + swiglu(p_cross["ffn"], rms_norm(p_cross["ln2"], x), dtype)
    elif fam == "audio":
        memory = None if "cross" in state else extras["enc_out"]
        x = x + _sinusoidal(torch.full((1,), pos, device=x.device), cfg.d_model, dtype)[None]
        for i, p in enumerate(params["blocks"]):
            h, _ = attn_lib.attention_decode(p["attn"], rms_norm(p["ln1"], x), KVCache(kv.k[i], kv.v[i]), pos, cfg)
            x = x + h
            x = x + _cross(p["cross"], rms_norm(p["ln_x"], x), state, i, memory, cfg)
            x = x + swiglu(p["ffn"], rms_norm(p["ln2"], x), dtype)
    else:
        raise ValueError(fam)
    return _logits(params, x, cfg, dtype), state
