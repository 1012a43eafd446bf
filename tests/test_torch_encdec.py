"""Port parity: the ``vlm`` and ``audio`` families (Llama-3.2-Vision's
cross-attention groups, Whisper's encoder-decoder) and their attention
(the bidirectional encoder mask, `cross_attention`, `cross_kv`,
`cross_attention_cached`), held against the JAX package on
``llama32_vision_11b:smoke`` and ``whisper_large_v3:smoke``, with the
reference's parameters carried over by `interop.lm_params_from_numpy`
(the vlm family's blocks are stacked on two axes there) and the same
numpy inputs; plus the three new configs.

Tolerances, as tests/test_torch_lm.py and tests/test_torch_ssm.py state
them: float32 modules at rtol 1e-5 / atol 1e-6, float32 logits at rtol
1e-4 / atol 1e-5, losses at rtol 1e-5, gradients at rtol 1e-4 and an atol
of 1e-5 times the leaf's largest entry; bf16 logits at atol 5e-2 and an
RMS difference of 1e-2; the port's decode against its own forward at the
reference test's rtol 2e-2 / atol 2e-3.

The audio family's decode does not match its forward in either package
(ROADMAP C-15): the reference's `forward` runs a decoder block's FFN
before its cross-attention, its `decode_step` after. The port copies both;
`test_audio_decode_differs_from_forward_as_the_reference_does` pins that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers, and
# torch's default of one thread a core would put 48 threads on 8 cores
torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch import configs, interop
from repro_torch.configs import TrainConfig
from repro_torch.launch.serve import prefill_step, serve
from repro_torch.launch.train import train_loop
from repro_torch.models import attention, lm, ssm
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import leaves

VLM, AUDIO = "llama32_vision_11b:smoke", "whisper_large_v3:smoke"
NEW_ARCHS = ("mamba2_130m", "whisper_large_v3", "llama32_vision_11b")
# jax.eval_shape of the reference's init_params on each published config
FULL_PARAM_COUNTS = {"mamba2_130m": 128_940_480, "whisper_large_v3": 2_020_421_120,
                     "llama32_vision_11b": 9_775_157_248}
F32 = dict(rtol=1e-5, atol=1e-6)
F32_LOGITS = dict(rtol=1e-4, atol=1e-5)
DECODE_TOL = dict(rtol=2e-2, atol=2e-3)
B, S = 2, 16


def _cfgs(arch, **kw):
    return jconfigs.get(arch).replace(**kw), configs.get(arch).replace(**kw)


_PARAMS = {}


def _params(arch):
    """The reference's smoke parameters (PRNGKey(0)) and the port's copy."""
    if arch not in _PARAMS:
        jcfg, cfg = _cfgs(arch)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        _PARAMS[arch] = jp, interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return _PARAMS[arch]


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().to(torch.float32)), np.asarray(want, np.float32), **tol)


def _tokens(cfg, seed, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s))


def _memory(cfg, seed):
    """The stub modality input of the forward pass, numpy float32."""
    m = cfg.num_image_tokens if cfg.family == "vlm" else cfg.num_frames
    return _normal((B, m, cfg.d_model), seed)


def _forward_extras(cfg, mem, to):
    return {"images" if cfg.family == "vlm" else "frames": to(mem)}


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", [a + s for a in NEW_ARCHS for s in ("", ":smoke")])
def test_config_matches_the_reference(name):
    j, t = jconfigs.get(name), configs.get(name)
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == {f: getattr(j, f) for f in j.__dataclass_fields__}


def test_get_resolves_every_architecture():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        assert configs.get(arch).name == jconfigs.get(arch).name
        assert configs.get(arch + ":smoke").name == jconfigs.get(arch + ":smoke").name


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_parameter_count_on_meta(arch):
    cfg = configs.get(arch)
    p = lm.init_params(cfg, 0, device="meta")
    assert lm.param_count(p) == FULL_PARAM_COUNTS[arch]
    assert all(t.device.type == "meta" for t in leaves(p))
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jconfigs.get(arch)), jax.random.PRNGKey(0))
    assert jlm.param_count(shapes) == FULL_PARAM_COUNTS[arch]


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_init_params_layout_matches_the_reference(arch):
    jp, tp = _params(arch)
    cfg = configs.get(arch)
    mine = lm.init_params(cfg, 0, device="cpu")
    assert [p.shape for p in leaves(mine)] == [p.shape for p in leaves(tp)]
    assert lm.param_count(mine) == jlm.param_count(jp)
    if cfg.family == "vlm":
        n_groups = cfg.num_layers // cfg.cross_attn_period
        assert len(mine["blocks"]) == n_groups and len(mine["blocks"][0]) == cfg.cross_attn_period - 1
        assert len(mine["cross_blocks"]) == n_groups
    else:
        assert len(mine["encoder"]) == cfg.encoder_layers and len(mine["blocks"]) == cfg.num_layers
        assert set(mine["blocks"][0]) == {"ln1", "attn", "ln2", "ffn", "ln_x", "cross"}


def test_vlm_group_order_survives_the_carry_over():
    """Each (group, layer) of the reference's two-level stack lands at the
    port's blocks[group][layer]: the leaves differ between places, so a
    swap would show."""
    jp, tp = _params(VLM)
    wq = np.asarray(jp["blocks"]["attn"]["wq"]["w"])  # (groups, period - 1, d, q)
    for g, group in enumerate(tp["blocks"]):
        for j, block in enumerate(group):
            assert np.array_equal(block["attn"]["wq"]["w"].numpy(), wq[g, j])
    for g, block in enumerate(tp["cross_blocks"]):
        assert np.array_equal(block["ffn"]["wo"]["w"].numpy(), np.asarray(jp["cross_blocks"]["ffn"]["wo"]["w"])[g])


def test_cross_attention_init_drops_the_qk_norm():
    cfg = configs.get(VLM).replace(qk_norm=True)
    assert set(attention.init_attention(None, cfg, "meta")) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    assert set(attention.init_attention(None, cfg, "meta", cross=True)) == {"wq", "wk", "wv", "wo"}


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk", [(24, 8), (20, 8), (16, 1024)], ids=["three_chunks", "fallback", "one_chunk"])
def test_bidirectional_attention_matches_the_reference(s, chunk):
    """The Whisper encoder's mask (RoPE applied, every position visible)."""
    jp, tp = _params(AUDIO)
    jcfg, cfg = _cfgs(AUDIO, dtype="float32", attn_chunk=chunk)
    x = _normal((B, s, cfg.d_model), 1)
    jparams = jax.tree.map(lambda a: a[0], jp["encoder"]["attn"])
    want = jattn.attention(jparams, jnp.asarray(x), jnp.arange(s), jcfg, 0, causal=False)
    got = attention.attention(tp["encoder"][0]["attn"], torch.tensor(x), torch.arange(s), cfg, 0, causal=False)
    _close(got, want, **F32)
    causal = attention.attention(tp["encoder"][0]["attn"], torch.tensor(x), torch.arange(s), cfg, 0)
    assert not torch.allclose(causal[:, :-1], got[:, :-1])  # the mask did change


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_cross_attention_matches_the_reference(arch):
    """`cross_attention`, `cross_kv` and `cross_attention_cached` (GQA in the
    vlm smoke config: 4 heads over 2 K/V heads)."""
    jp, tp = _params(arch)
    jcfg, cfg = _cfgs(arch, dtype="float32")
    if cfg.family == "vlm":
        jparams = jax.tree.map(lambda a: a[0], jp["cross_blocks"]["attn"])
        params = tp["cross_blocks"][0]["attn"]
    else:
        jparams = jax.tree.map(lambda a: a[1], jp["blocks"]["cross"])
        params = tp["blocks"][1]["cross"]
    x, mem = _normal((B, 12, cfg.d_model), 2), _memory(cfg, 3)
    want = jattn.cross_attention(jparams, jnp.asarray(x), jnp.asarray(mem), jcfg)
    _close(attention.cross_attention(params, torch.tensor(x), torch.tensor(mem), cfg), want, **F32)
    jk, jv = jattn.cross_kv(jparams, jnp.asarray(mem), jcfg, jnp.float32)
    k, v = attention.cross_kv(params, torch.tensor(mem), cfg, torch.float32)
    assert k.shape == (B, mem.shape[1], cfg.num_kv_heads, cfg.head_dim)
    _close(k, jk, **F32)
    _close(v, jv, **F32)
    cached = attention.cross_attention_cached(params, torch.tensor(x), k, v, cfg)
    _close(cached, jattn.cross_attention_cached(jparams, jnp.asarray(x), jk, jv, jcfg), **F32)
    _close(cached, want, **F32)


def test_cross_kv_defaults_to_bf16_as_the_reference():
    jp, tp = _params(VLM)
    jcfg, cfg = _cfgs(VLM)
    mem = _memory(cfg, 4)
    jk, _ = jattn.cross_kv(jax.tree.map(lambda a: a[0], jp["cross_blocks"]["attn"]), jnp.asarray(mem), jcfg)
    k, _ = attention.cross_kv(tp["cross_blocks"][0]["attn"], torch.tensor(mem), cfg)
    assert k.dtype == torch.bfloat16 and jk.dtype == jnp.bfloat16
    np.testing.assert_allclose(k.float().numpy(), np.asarray(jk, np.float32), rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forward_matches_the_reference_in_float32(arch):
    jp, tp = _params(arch)
    jcfg, cfg = _cfgs(arch, dtype="float32")
    tokens, mem = _tokens(cfg, 5), _memory(cfg, 6)
    want, _ = jlm.forward(jp, jnp.asarray(tokens), jcfg, _forward_extras(cfg, mem, jnp.asarray))
    got, aux = lm.forward(tp, torch.tensor(tokens), cfg, _forward_extras(cfg, mem, torch.tensor))
    _close(got, want, **F32_LOGITS)
    assert float(aux) == 0.0
    last, _ = lm.forward(tp, torch.tensor(tokens), cfg, _forward_extras(cfg, mem, torch.tensor), last_only=True)
    _close(last, want[:, -1:], **F32_LOGITS)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forward_matches_the_reference_in_bf16(arch):
    jp, tp = _params(arch)
    jcfg, cfg = _cfgs(arch)
    tokens, mem = _tokens(cfg, 7), _memory(cfg, 8)
    want = np.asarray(jlm.forward(jp, jnp.asarray(tokens), jcfg, _forward_extras(cfg, mem, jnp.asarray))[0], np.float32)
    got = lm.forward(tp, torch.tensor(tokens), cfg, _forward_extras(cfg, mem, torch.tensor))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    assert float(np.sqrt(np.mean((got - want) ** 2))) < 1e-2


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_loss_and_gradients_match_the_reference(arch):
    """The loss of a batch with its stub input (passed on as ``extras``)
    and its gradient at every parameter, float32."""
    jp, tp = _params(arch)
    jcfg, cfg = _cfgs(arch, dtype="float32")
    tokens, mem = _tokens(cfg, 9), _memory(cfg, 10)
    jbatch = {"tokens": jnp.asarray(tokens), **_forward_extras(cfg, mem, jnp.asarray)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(jp, jbatch)
    batch = {"tokens": torch.tensor(tokens), **_forward_extras(cfg, mem, torch.tensor)}
    grads, metrics = loss_and_grads(tp, batch, cfg)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    want = leaves(interop.lm_params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg, device="cpu"))
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4, atol=1e-5 * float(w.abs().max()))
    # the cross-attention and, for Whisper, the encoder get gradients
    named = dict(zip(map(str, range(len(grads))), grads))
    assert all(float(g.abs().sum()) > 0 for g in named.values() if g.ndim == 2)


def _jdecode_step(jcfg, jex):
    """The reference's decode step, jitted (its eager steps take a second each)."""
    return jax.jit(lambda p, st, tok, i: jlm.decode_step(p, st, tok, i, jcfg, jex))


def _decode_memory(arch, jp, tp, seed):
    """The decode path's memory: the images (vlm), or the encoder's output
    on stub frames (audio), as each package computes it, float32."""
    jcfg, cfg = _cfgs(arch, dtype="float32")
    mem = _memory(cfg, seed)
    if cfg.family == "vlm":
        return {"images": jnp.asarray(mem)}, {"images": torch.tensor(mem)}, mem
    jenc = jlm._encode_audio(jp, jnp.asarray(mem), jcfg)
    enc = lm._encode_audio(tp, torch.tensor(mem), cfg)
    _close(enc, jenc, **F32_LOGITS)
    return {"enc_out": jenc}, {"enc_out": enc}, mem


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_fill_cross_cache_matches_the_reference(arch):
    jp, tp = _params(arch)
    jcfg, cfg = _cfgs(arch, dtype="float32")
    jex, ex, _ = _decode_memory(arch, jp, tp, 11)
    jst = jlm.fill_cross_cache(jp, jcfg, jlm.init_decode_state(jcfg, B, S, jnp.float32), jex, jnp.float32)
    st = lm.init_decode_state(cfg, B, S, dtype=torch.float32, device="cpu")
    assert st["kv"].k.shape == jst["kv"].k.shape and st["cross"].k.shape == jst["cross"].k.shape
    st = lm.fill_cross_cache(tp, cfg, st, ex, torch.float32)
    _close(st["cross"].k, jst["cross"].k, **F32)
    _close(st["cross"].v, jst["cross"].v, **F32)
    plain = lm.init_decode_state(cfg.replace(decode_cross_cache=False), B, S, device="cpu")
    assert "cross" not in plain and lm.fill_cross_cache(tp, cfg, plain, ex) is plain


@pytest.mark.parametrize("cached", [True, False], ids=["cross_cache", "no_cross_cache"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_decode_steps_match_the_reference(arch, cached):
    """Teacher-forced decode of both packages, logits and self-attention
    caches compared step by step, float32, with and without the cross cache."""
    jp, tp = _params(arch)
    jcfg, cfg = _cfgs(arch, dtype="float32", decode_cross_cache=cached)
    jex, ex, _ = _decode_memory(arch, jp, tp, 12)
    tokens = _tokens(cfg, 13, 8)
    jst = jlm.fill_cross_cache(jp, jcfg, jlm.init_decode_state(jcfg, B, 8, jnp.float32), jex, jnp.float32)
    st = lm.fill_cross_cache(tp, cfg, lm.init_decode_state(cfg, B, 8, dtype=torch.float32, device="cpu"), ex,
                             torch.float32)
    jstep = _jdecode_step(jcfg, jex)
    for i in range(tokens.shape[1]):
        jl, jst = jstep(jp, jst, jnp.asarray(tokens[:, i : i + 1]), jnp.int32(i))
        tl, st = lm.decode_step(tp, st, torch.tensor(tokens[:, i : i + 1]), i, cfg, ex)
        _close(tl, jl, **F32_LOGITS)
    # the later layers' K/V carry the residual stream's rounding: the logits' tolerance
    _close(st["kv"].k, jst["kv"].k, **F32_LOGITS)
    _close(st["kv"].v, jst["kv"].v, **F32_LOGITS)


def _decode_all(tp, cfg, tokens, ex):
    st = lm.fill_cross_cache(tp, cfg, lm.init_decode_state(cfg, B, tokens.shape[1], dtype=torch.float32,
                                                           device="cpu"), ex, torch.float32)
    outs = []
    for i in range(tokens.shape[1]):
        lg, st = lm.decode_step(tp, st, tokens[:, i : i + 1], i, cfg, ex)
        outs.append(lg)
    return torch.cat(outs, 1)


@pytest.mark.parametrize("cached", [True, False], ids=["cross_cache", "no_cross_cache"])
def test_vlm_decode_matches_forward(cached):
    _, tp = _params(VLM)
    cfg = configs.get(VLM).replace(dtype="float32", decode_cross_cache=cached)
    tokens, mem = torch.tensor(_tokens(cfg, 14)), torch.tensor(_memory(cfg, 15))
    ref, _ = lm.forward(tp, tokens, cfg, {"images": mem})
    torch.testing.assert_close(_decode_all(tp, cfg, tokens, {"images": mem}), ref, **DECODE_TOL)


def test_audio_decode_differs_from_forward_as_the_reference_does(monkeypatch):
    """C-15: the port's audio decode differs from its forward by what the
    reference's does (its forward applies a decoder block's FFN before the
    cross-attention, its decode_step after), and by far more than
    `DECODE_TOL`; with the forward's block in Whisper's order (self, cross,
    FFN) the two agree. Each matches its reference counterpart."""
    jp, tp = _params(AUDIO)
    jcfg, cfg = _cfgs(AUDIO, dtype="float32")
    jex, ex, frames = _decode_memory(AUDIO, jp, tp, 16)
    tokens = _tokens(cfg, 17)
    jfwd, _ = jlm.forward(jp, jnp.asarray(tokens), jcfg, {"frames": jnp.asarray(frames)})
    jst = jlm.fill_cross_cache(jp, jcfg, jlm.init_decode_state(jcfg, B, S, jnp.float32), jex, jnp.float32)
    jdec, jstep = [], _jdecode_step(jcfg, jex)
    for i in range(S):
        jl, jst = jstep(jp, jst, jnp.asarray(tokens[:, i : i + 1]), jnp.int32(i))
        jdec.append(np.asarray(jl))
    jdec = np.concatenate(jdec, 1)

    fwd, _ = lm.forward(tp, torch.tensor(tokens), cfg, {"frames": torch.tensor(frames)})
    dec = _decode_all(tp, cfg, torch.tensor(tokens), ex)
    _close(fwd, jfwd, **F32_LOGITS)
    _close(dec, jdec, **F32_LOGITS)
    gap, jgap = (dec - fwd).numpy(), jdec - np.asarray(jfwd)
    assert np.abs(gap).max() > 10 * DECODE_TOL["atol"] + DECODE_TOL["rtol"] * float(fwd.abs().max())
    np.testing.assert_allclose(gap, jgap, rtol=0, atol=1e-4)

    def whisper_order(p, x, enc, positions, cfg_):
        x = x + attention.attention(p["attn"], lm.rms_norm(p["ln1"], x), positions, cfg_, 0)
        x = x + attention.cross_attention(p["cross"], lm.rms_norm(p["ln_x"], x), enc, cfg_)
        return x + lm.swiglu(p["ffn"], lm.rms_norm(p["ln2"], x), x.dtype)

    monkeypatch.setattr(lm, "_decoder_block", whisper_order)
    reordered, _ = lm.forward(tp, torch.tensor(tokens), cfg, {"frames": torch.tensor(frames)})
    torch.testing.assert_close(dec, reordered, **DECODE_TOL)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_prefill_and_serve_on_the_cpu(arch, capsys):
    _, tp = _params(arch)
    cfg = configs.get(arch)
    tokens, mem = torch.tensor(_tokens(cfg, 18)), torch.tensor(_memory(cfg, 19))
    extras = _forward_extras(cfg, mem, lambda t: t)
    last = prefill_step(tp, tokens, cfg, extras)
    assert last.shape == (B, cfg.vocab_size) and last.dtype == torch.float32
    torch.testing.assert_close(last, lm.forward(tp, tokens, cfg, extras)[0][:, -1], rtol=0, atol=0)
    a = serve(cfg, batch=2, prompt_len=4, gen=6, seed=3, device="cpu", params=tp)
    b = serve(cfg, batch=2, prompt_len=4, gen=6, seed=3, device="cpu", params=tp)
    assert a.shape == (2, 10) and np.array_equal(a, b) and bool(((a >= 0) & (a < cfg.vocab_size)).all())
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2_130m:smoke", VLM, AUDIO])
def test_entry_points_raise_without_a_card(monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get(arch)
    calls = [
        lambda: lm.init_params(cfg, 0),
        lambda: lm.init_decode_state(cfg, 1, 8),
        lambda: serve(cfg, batch=1, prompt_len=2, gen=2),
        lambda: train_loop(cfg, TrainConfig(total_steps=1)),
    ]
    if cfg.family == "ssm":
        calls.append(lambda: ssm.init_ssm_state(cfg, 1))
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


@pytest.mark.parametrize("fault", ["vlm_groups", "vlm_layers_in_group", "vlm_cross_blocks", "audio_encoder",
                                   "audio_blocks", "ssm_blocks"])
def test_lm_params_from_numpy_refuses_a_wrong_stack(fault):
    """A stacked axis of the wrong length, in either of the vlm family's
    two levels, the cross blocks, Whisper's encoder or decoder, or
    Mamba2's blocks, is refused with its path."""
    family, where = fault.split("_", 1)
    arch = {"vlm": VLM, "audio": AUDIO, "ssm": "mamba2_130m:smoke"}[family]
    cfg = configs.get(arch)
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jconfigs.get(arch)) if family == "ssm"
                      else _params(arch)[0])
    key = {"groups": "blocks", "layers_in_group": "blocks", "cross_blocks": "cross_blocks", "encoder": "encoder",
           "blocks": "blocks"}[where]
    axis = 1 if where == "layers_in_group" else 0
    jp = dict(jp, **{key: jax.tree.map(lambda a: np.delete(a, 0, axis=axis), jp[key])})
    with pytest.raises(ValueError, match=f"params/{key}"):
        interop.lm_params_from_numpy(jp, cfg, device="cpu")
