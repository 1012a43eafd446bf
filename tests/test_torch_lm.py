"""Port parity: the RecurrentGemma serving slice (configs, layers,
attention, RG-LRU, the hybrid LM, prefill and decode) held against the JAX
package on ``recurrentgemma_2b:smoke``, with the reference's parameters
carried over by `interop.lm_params_from_numpy` and the same numpy inputs.

Tolerances:

* float32 (``cfg.replace(dtype="float32")``), where the point is the
  algorithm: modules at rtol 1e-5 / atol 1e-6, the whole model's logits at
  rtol 1e-4 / atol 1e-5 (measured: 1.1e-6 at most, on logits up to 0.62);
  sums in other orders and other transcendental implementations only.
* bf16, the default ``cfg.dtype``: XLA on the CPU and torch round bf16 at
  other places (XLA fuses chains of bf16 elementwise ops in float32), so
  the logits are held at atol 5e-2 and an RMS difference of 1e-2
  (measured over seeds 0-2: max 0.021, RMS 0.0031, on logits up to 0.66
  whose bf16 spacing there is 0.0039; each package's own bf16 logits
  differ from its float32 ones by up to 0.028).
* The port's decode against its own forward: the reference test's
  rtol 2e-2 / atol 2e-3.
"""
import os
import subprocess
import sys
from pathlib import Path

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
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro_torch import configs, interop
from repro_torch.kernels import ops
from repro_torch.launch.serve import prefill_step, serve
from repro_torch.models import attention, layers, lm, rglru

ARCH = "recurrentgemma_2b:smoke"
F32 = dict(rtol=1e-5, atol=1e-6)
FULL_PARAM_COUNT = 3_549_795_840  # jax.eval_shape of the reference's init_params


def _cfgs(**kw):
    return jconfigs.get(ARCH).replace(**kw), configs.get(ARCH).replace(**kw)


@pytest.fixture(scope="module")
def params():
    """The reference's smoke parameters (seed 0), numpy leaves, and the port's copy."""
    jcfg, cfg = _cfgs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().to(torch.float32)), np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


def test_config_matches_the_reference():
    for name in ("recurrentgemma_2b", ARCH):
        j, t = jconfigs.get(name), configs.get(name)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == {
            f: getattr(j, f) for f in j.__dataclass_fields__
        }
        assert (t.q_dim, t.kv_dim, t.is_moe) == (j.q_dim, j.kv_dim, j.is_moe)
    full = configs.get("recurrentgemma_2b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.head_dim) == (26, 2560, 10, 1, 256)
    assert (full.d_ff, full.vocab_size, full.sliding_window, full.rnn_width) == (7680, 256000, 2048, 2560)
    assert full.block_pattern == ("rglru", "rglru", "attn")
    assert (full.rglru_backend, full.rglru_chunk) == ("chunked", 256)
    assert configs.SHAPES == jconfigs.SHAPES and configs.ARCH_IDS == jconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", ["no_such_arch"])
def test_get_of_an_unported_architecture_raises(arch):
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get(arch)
    with pytest.raises(KeyError):
        configs.get(arch + ":smoke")


@pytest.mark.parametrize(
    "arch", ["olmoe_1b_7b", "llama4_scout_17b_a16e", "qwen3_14b", "stablelm_3b", "starcoder2_7b", "gemma3_12b"]
)
def test_get_of_a_ported_architecture_matches_the_reference(arch):
    for name in (arch, arch + ":smoke"):
        j, t = jconfigs.get(name), configs.get(name)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == {
            f: getattr(j, f) for f in j.__dataclass_fields__
        }
        assert (t.q_dim, t.kv_dim, t.is_moe) == (j.q_dim, j.kv_dim, j.is_moe)
        assert t.family in ("dense", "moe") and t.is_moe == (t.family == "moe")


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def test_rms_norm_matches_the_reference():
    x = _normal((2, 5, 64), 0, 3.0)
    scale = 1.0 + _normal((64,), 1, 0.1)
    want = jlayers.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    _close(layers.rms_norm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x)), want, **F32)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["positions_1d", "positions_batched"])
def test_rope_matches_the_reference(lead):
    x = _normal(lead + (7, 4, 16), 2)
    pos = np.arange(3, 10) if not lead else np.stack([np.arange(7), np.arange(100, 107)])
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    _close(layers.rope(torch.as_tensor(x), torch.as_tensor(pos), 10_000.0), want, **F32)


def test_swiglu_matches_the_reference(params):
    jp, tp = params
    x = _normal((2, 5, 64), 3)
    want = jlayers.swiglu(jp["blocks"][0]["ffn"], jnp.asarray(x), jnp.float32)
    _close(layers.swiglu(tp["blocks"][0]["ffn"], torch.as_tensor(x), torch.float32), want, **F32)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "s,chunk,window",
    [(32, 1024, 16), (32, 8, 16), (32, 8, 0), (30, 8, 5)],
    ids=["one_chunk", "chunked_window", "chunked_full", "ragged_fallback"],
)
def test_attention_matches_the_reference(params, s, chunk, window):
    jp, tp = params
    jcfg, cfg = _cfgs(dtype="float32", attn_chunk=chunk)
    x = _normal((2, s, 64), s + chunk)
    want = jattn.attention(jp["blocks"][2]["attn"], jnp.asarray(x), jnp.arange(s), jcfg, window)
    got = attention.attention(tp["blocks"][2]["attn"], torch.as_tensor(x), torch.arange(s), cfg, window)
    _close(got, want, **F32)


@pytest.mark.parametrize(
    "ring,s_cache,pos,window",
    [(True, 16, 5, 16), (True, 16, 37, 16), (False, 32, 10, 0), (False, 32, 20, 8), (False, 8, 12, 0)],
    ids=["ring_filling", "ring_wrapped", "linear_full", "linear_window", "linear_clamped"],
)
def test_attention_decode_matches_the_reference(params, ring, s_cache, pos, window):
    jp, tp = params
    jcfg, cfg = _cfgs(dtype="float32")
    x = _normal((2, 1, 64), pos)
    k = _normal((2, s_cache, 1, 16), pos + 1)
    v = _normal((2, s_cache, 1, 16), pos + 2)
    y_want, cache_want = jattn.attention_decode(
        jp["blocks"][2]["attn"], jnp.asarray(x), jattn.KVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.int32(pos), jcfg, window=window, ring=ring,
    )
    y_got, cache_got = attention.attention_decode(
        tp["blocks"][2]["attn"], torch.as_tensor(x), attention.KVCache(torch.tensor(k), torch.tensor(v)),
        pos, cfg, window=window, ring=ring,
    )
    _close(y_got, y_want, **F32)
    _close(cache_got.k, cache_want.k, **F32)
    _close(cache_got.v, cache_want.v, **F32)


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["assoc", "chunked", "pallas"])
def test_rglru_forward_matches_the_reference(params, backend):
    jp, tp = params
    # chunk 16 over S = 64: the chunked backend really chunks
    jcfg, cfg = _cfgs(dtype="float32", rglru_backend=backend, rglru_chunk=16)
    x = _normal((2, 64, 64), 4)
    want = jrglru.rglru_forward(jp["blocks"][0]["mix"], jnp.asarray(x), jcfg)
    before = dict(ops.LAUNCHES)
    got = rglru.rglru_forward(tp["blocks"][0]["mix"], torch.as_tensor(x), cfg)
    _close(got, want, **F32)
    assert ops.LAUNCHES == before  # on the CPU "pallas" runs the plain scan


def test_rglru_backends_agree_within_the_port(params):
    _, tp = params
    x = torch.as_tensor(_normal((2, 64, 64), 5))
    outs = {
        b: rglru.rglru_forward(tp["blocks"][1]["mix"], x, configs.get(ARCH).replace(
            dtype="float32", rglru_backend=b, rglru_chunk=16))
        for b in ("assoc", "chunked", "pallas")
    }
    # the reference test_rglru_backends_agree's tolerances
    torch.testing.assert_close(outs["chunked"], outs["assoc"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs["pallas"], outs["assoc"], rtol=1e-4, atol=1e-4)


def test_rglru_decode_matches_the_reference(params):
    jp, tp = params
    jcfg, cfg = _cfgs(dtype="float32")
    x = _normal((2, 1, 64), 6)
    h, conv = _normal((2, 64), 7), _normal((2, 3, 64), 8)
    y_want, st_want = jrglru.rglru_decode(jp["blocks"][0]["mix"], jnp.asarray(x),
                                          jrglru.RGLRUState(jnp.asarray(h), jnp.asarray(conv)), jcfg)
    y_got, st_got = rglru.rglru_decode(tp["blocks"][0]["mix"], torch.as_tensor(x),
                                       rglru.RGLRUState(torch.as_tensor(h), torch.as_tensor(conv)), cfg)
    _close(y_got, y_want, **F32)
    _close(st_got.h, st_want.h, **F32)
    _close(st_got.conv, st_want.conv, **F32)


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("last_only", [False, True], ids=["all_logits", "last_only"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_the_reference(params, dtype, last_only):
    jp, tp = params
    jcfg, cfg = _cfgs(dtype=dtype, rglru_backend="pallas")
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 40))
    want, _ = jlm.forward(jp, jnp.asarray(tokens), jcfg, last_only=last_only)
    got, aux = lm.forward(tp, torch.as_tensor(tokens), cfg, last_only=last_only)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    assert float(aux) == 0.0
    if dtype == "float32":
        _close(got, want, rtol=1e-4, atol=1e-5)
    else:
        diff = got.numpy() - np.asarray(want)
        assert np.abs(diff).max() <= 5e-2 and np.sqrt(np.mean(diff**2)) <= 1e-2
    if last_only:
        # the prefill step: the last position's next-token logits, (B, V)
        step = prefill_step(tp, torch.as_tensor(tokens), cfg)
        assert tuple(step.shape) == (2, cfg.vocab_size)
        torch.testing.assert_close(step, got[:, -1, :], rtol=0, atol=0)


def test_decode_steps_match_the_reference(params):
    """24 teacher-forced steps of both packages' decode_step, logits and
    states compared step by step (the window of 16 wraps the ring)."""
    jp, tp = params
    jcfg, cfg = _cfgs(dtype="float32")
    b, s = 2, 24
    tokens = np.random.default_rng(10).integers(0, cfg.vocab_size, (b, s))
    jstate = jlm.init_decode_state(jcfg, b, s, dtype=jnp.float32)
    tstate = lm.init_decode_state(cfg, b, s, dtype=torch.float32, device="cpu")
    for i in range(s):
        want, jstate = jlm.decode_step(jp, jstate, jnp.asarray(tokens[:, i : i + 1]), jnp.int32(i), jcfg)
        got, tstate = lm.decode_step(tp, tstate, torch.as_tensor(tokens[:, i : i + 1]), i, cfg)
        _close(got, want, rtol=1e-4, atol=1e-5)
    for j, t in zip(jstate["layers"], tstate["layers"]):
        for jx, tx in zip(j, t):
            _close(tx, jx, rtol=1e-4, atol=1e-5)


def test_decode_matches_forward():
    """The port's own check (tests/test_models.py::test_decode_matches_forward
    for this arch): tokens fed one by one through decode_step give the
    logits of one parallel forward."""
    cfg = configs.get(ARCH).replace(dtype="float32", rglru_backend="pallas")
    tp = lm.init_params(cfg, 2, device="cpu")
    b, s = 2, 24
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(2))
    ref, _ = lm.forward(tp, tokens, cfg)
    state = lm.init_decode_state(cfg, b, s, dtype=torch.float32, device="cpu")
    outs = []
    for i in range(s):
        lg, state = lm.decode_step(tp, state, tokens[:, i : i + 1], i, cfg)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, dim=1), ref, rtol=2e-2, atol=2e-3)


def test_serve_on_the_cpu_is_deterministic_for_a_seed(capsys):
    cfg = configs.get(ARCH)
    a = serve(cfg, batch=3, prompt_len=5, gen=6, seed=1, device="cpu")
    b = serve(cfg, batch=3, prompt_len=5, gen=6, seed=1, device="cpu")
    c = serve(cfg, batch=3, prompt_len=5, gen=6, seed=2, device="cpu")
    assert a.shape == (3, 11) and a.dtype.kind == "i"
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("decoded 3x11 tokens in ") and lines[0].endswith(" tok/s)")
    assert lines[1] == "sample: " + str(a[0].tolist())


def test_serve_cli_runs_on_the_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--batch", "2",
         "--prompt-len", "4", "--gen", "4", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("sample: [")
    probe = ("import sys, repro_torch.launch.serve, repro_torch.models, repro_torch.configs\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
             "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get(ARCH)
    for call in (
        lambda: lm.init_params(cfg, 0),
        lambda: lm.init_decode_state(cfg, 1, 8),
        lambda: serve(cfg, batch=1, prompt_len=2, gen=2),
        lambda: interop.lm_params_from_numpy({}, cfg),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_full_config_parameter_count_on_meta():
    cfg = configs.get("recurrentgemma_2b")
    p = lm.init_params(cfg, 0, device="meta")
    assert lm.param_count(p) == FULL_PARAM_COUNT
    assert all(t.device.type == "meta" for t in jax.tree.leaves(p))
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jconfigs.get("recurrentgemma_2b")), jax.random.PRNGKey(0))
    assert jlm.param_count(shapes) == FULL_PARAM_COUNT


def test_init_params_is_deterministic_and_matches_the_reference_layout(params):
    jp, _ = params
    cfg = configs.get(ARCH)
    a, b = lm.init_params(cfg, 3, device="cpu"), lm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y) and x.dtype == torch.float32
    # the same keys and shapes as the reference's pytree, leaf for leaf
    assert jax.tree.structure(jax.tree.map(lambda t: 0, a)) == jax.tree.structure(jax.tree.map(lambda t: 0, jp))
    assert [tuple(t.shape) for t in jax.tree.leaves(a)] == [tuple(t.shape) for t in jax.tree.leaves(jp)]
    emb = a["embed"]["w"]
    assert abs(float(emb.std()) - 0.02) < 2e-3  # the reference's init scales
    assert abs(float(a["blocks"][0]["ffn"]["wi"]["w"].std()) - 64**-0.5) < 0.02


@pytest.mark.parametrize("fault", ["missing_key", "extra_key", "wrong_shape", "block_count"])
def test_lm_params_from_numpy_checks_the_tree(params, fault):
    jp, _ = params
    tree = jax.tree.map(np.asarray, jp)
    tree["blocks"] = [dict(blk) for blk in tree["blocks"]]
    if fault == "missing_key":
        del tree["unembed"]
    elif fault == "extra_key":
        tree["blocks"][0]["extra"] = np.zeros(3, np.float32)
    elif fault == "wrong_shape":
        tree["blocks"][2]["attn"] = dict(tree["blocks"][2]["attn"], wq={"w": np.zeros((64, 32), np.float32)})
    else:
        tree["blocks"] = tree["blocks"][:2]
    with pytest.raises(ValueError):
        interop.lm_params_from_numpy(tree, configs.get(ARCH), device="cpu")
