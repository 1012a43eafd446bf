"""Port parity: the ``ssm`` family (Mamba-2's SSD mixer, `models/ssm.py`,
and ``mamba2_130m`` through the LM) held against the JAX package on
``mamba2_130m:smoke`` (d_in 128, 8 heads of 16, state 16, chunk 8), with
the reference's parameters carried over by `interop.lm_params_from_numpy`
and the same numpy inputs.

Tolerances:

* float32, where the point is the algorithm: the mixer at rtol 1e-5 /
  atol 1e-6 (other summation orders in the chunk products and the scan),
  the model's logits at rtol 1e-4 / atol 1e-5 and its loss at rtol 1e-5,
  as tests/test_torch_lm.py holds the hybrid family; the gradients at rtol
  1e-4 and an atol of 1e-5 times the leaf's largest entry, as
  tests/test_torch_lm_families.py holds OLMoE's.
* bf16, the default ``cfg.dtype``: the logits at atol 5e-2 and an RMS
  difference of 1e-2, as tests/test_torch_lm.py states. The causal conv
  sums its products in bf16, left to right, as the reference does.
* The chunked form against a plain token-by-token recurrence, both in
  float64: rtol 1e-10 / atol 1e-12.
* The port's decode against its own forward: the reference test's
  rtol 2e-2 / atol 2e-3 (tests/test_models.py::test_decode_matches_forward).
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
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import configs, interop
from repro_torch.launch.serve import prefill_step, serve
from repro_torch.models import lm, ssm
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import leaves

ARCH = "mamba2_130m:smoke"
F32 = dict(rtol=1e-5, atol=1e-6)
F32_LOGITS = dict(rtol=1e-4, atol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-12)
DECODE_TOL = dict(rtol=2e-2, atol=2e-3)
B = 2


def _cfgs(**kw):
    return jconfigs.get(ARCH).replace(**kw), configs.get(ARCH).replace(**kw)


@pytest.fixture(scope="module")
def params():
    """The reference's smoke parameters (seed 0), numpy leaves, and the port's copy."""
    jcfg, cfg = _cfgs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _layer0(jp):
    """Layer 0's SSD parameters: the reference's (sliced off the stack) and as numpy."""
    return jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"])


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().to(torch.float32)), np.asarray(want, np.float32), **tol)


def _tokens(cfg, seed, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s))


# --------------------------------------------------------------------------
# the mixer
# --------------------------------------------------------------------------


def test_causal_conv_matches_the_reference():
    x, w = _normal((B, 21, 160), 1), _normal((4, 160), 2, 0.1)
    _close(ssm._causal_conv(torch.tensor(x), torch.tensor(w)), jssm._causal_conv(jnp.asarray(x), jnp.asarray(w)), **F32)


@pytest.mark.parametrize("s", [24, 20], ids=["three_chunks", "one_chunk_of_20"])
def test_ssm_forward_matches_the_reference(params, s):
    """S a multiple of the chunk (8) and not one (the one-chunk fallback)."""
    jp, tp = params
    jcfg, cfg = _cfgs(dtype="float32")
    x = _normal((B, s, cfg.d_model), 3)
    want = jssm.ssm_forward(_layer0(jp), jnp.asarray(x), jcfg)
    _close(ssm.ssm_forward(tp["blocks"][0]["ssm"], torch.tensor(x), cfg), want, **F32)


def test_ssm_decode_matches_the_reference_step_by_step(params):
    jp, tp = params
    jcfg, cfg = _cfgs(dtype="float32")
    x = _normal((B, 12, cfg.d_model), 4)
    jst = jssm.init_ssm_state(jcfg, B)
    st = ssm.init_ssm_state(cfg, B, device="cpu")
    for t in range(x.shape[1]):
        jy, jst = jssm.ssm_decode(_layer0(jp), jnp.asarray(x[:, t : t + 1]), jst, jcfg)
        y, st = ssm.ssm_decode(tp["blocks"][0]["ssm"], torch.tensor(x[:, t : t + 1]), st, cfg)
        _close(y, jy, **F32)
        _close(st.h, jst.h, **F32)
        _close(st.conv, jst.conv, **F32)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 32])
def test_assoc_scan_matches_a_sequential_recurrence_in_float64(n):
    """The port's odd/even scan against ``h_c = a_c h_{c-1} + s_c``."""
    rng = np.random.default_rng(n)
    a = torch.tensor(rng.uniform(0.2, 1.0, (2, n, 3, 1, 1)))
    s = torch.tensor(rng.standard_normal((2, n, 3, 4, 5)))
    acc_a, acc_s = ssm._assoc_scan(a, s)
    h, prod = torch.zeros_like(s[:, 0]), torch.ones_like(a[:, 0])
    for c in range(n):
        h, prod = a[:, c] * h + s[:, c], prod * a[:, c]
        torch.testing.assert_close(acc_s[:, c], h, **F64)
        torch.testing.assert_close(acc_a[:, c], prod, **F64)


@pytest.mark.parametrize("s", [24, 20], ids=["three_chunks", "one_chunk_of_20"])
def test_chunked_ssd_matches_a_token_by_token_recurrence_in_float64(params, s):
    """``ssm_forward`` in float64 against the SSD written as its recurrence,
    ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t``, ``y_t = C_t . h_t + D
    x_t``, one token at a time after the same projections and conv."""
    _, tp = params
    cfg = configs.get(ARCH).replace(dtype="float64")
    p = {k: v.to(torch.float64) if isinstance(v, torch.Tensor) else {kk: vv.to(torch.float64) for kk, vv in v.items()}
         for k, v in tp["blocks"][0]["ssm"].items()}
    x = torch.tensor(_normal((B, s, cfg.d_model), 5), dtype=torch.float64)
    d_in, heads, n = ssm._dims(cfg)
    hd = cfg.ssm_head_dim
    z, xbc, dt = ssm._split_proj(p, x, cfg, torch.float64)
    xbc = ssm._causal_conv(xbc, p["conv_w"])
    dt = torch.nn.functional.softplus(dt + p["dt_bias"], threshold=1e9)
    A = -torch.exp(p["A_log"])
    h = torch.zeros((B, heads, n, hd), dtype=torch.float64)
    ys = []
    for t in range(s):
        xt = xbc[:, t, :d_in].reshape(B, heads, hd)
        Bt, Ct = xbc[:, t, d_in : d_in + n], xbc[:, t, d_in + n :]
        h = torch.exp(dt[:, t] * A)[:, :, None, None] * h + (dt[:, t, :, None, None] * Bt[:, None, :, None]
                                                           * xt[:, :, None, :])
        ys.append((Ct[:, None, :, None] * h).sum(2) + p["D"][None, :, None] * xt)
    y = torch.stack(ys, 1).reshape(B, s, d_in)
    y = ssm.rms_norm(p["norm"], y * torch.nn.functional.silu(z)) @ p["out_proj"]["w"]
    torch.testing.assert_close(ssm.ssm_forward(p, x, cfg), y, **F64)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def test_init_params_layout_matches_the_reference(params):
    jp, tp = params
    cfg = configs.get(ARCH)
    mine = lm.init_params(cfg, 0, device="cpu")
    assert [p.shape for p in leaves(mine)] == [p.shape for p in leaves(tp)]
    assert lm.param_count(mine) == jlm.param_count(jp)
    assert len(mine["blocks"]) == cfg.num_layers and set(mine["blocks"][0]) == {"ln1", "ssm"}
    assert "unembed" not in mine  # tied embeddings


@pytest.mark.parametrize("s", [24, 20], ids=["three_chunks", "one_chunk_of_20"])
def test_forward_matches_the_reference_in_float32(params, s):
    jp, tp = params
    jcfg, cfg = _cfgs(dtype="float32")
    tokens = _tokens(cfg, 6, s)
    want, _ = jlm.forward(jp, jnp.asarray(tokens), jcfg)
    got, aux = lm.forward(tp, torch.tensor(tokens), cfg)
    _close(got, want, **F32_LOGITS)
    assert float(aux) == 0.0


def test_forward_matches_the_reference_in_bf16(params):
    jp, tp = params
    jcfg, cfg = _cfgs()
    tokens = _tokens(cfg, 7, 32)
    want = np.asarray(jlm.forward(jp, jnp.asarray(tokens), jcfg)[0], np.float32)
    got = lm.forward(tp, torch.tensor(tokens), cfg)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    assert float(np.sqrt(np.mean((got - want) ** 2))) < 1e-2


def test_loss_and_gradients_match_the_reference(params):
    """The loss and its gradient at every parameter, float32, the
    reference's gradients carried over like its parameters."""
    jp, tp = params
    jcfg, cfg = _cfgs(dtype="float32")
    tokens = _tokens(cfg, 8, 24)
    (jloss, jm), jgrads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    grads, metrics = loss_and_grads(tp, {"tokens": torch.tensor(tokens)}, cfg)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]), rtol=1e-5)
    want = leaves(interop.lm_params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg, device="cpu"))
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4, atol=1e-5 * float(w.abs().max()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_decode_steps_match_the_reference(params):
    """Teacher-forced decode of both packages, logits and the stacked
    state compared step by step, float32."""
    jp, tp = params
    jcfg, cfg = _cfgs(dtype="float32")
    tokens = _tokens(cfg, 9, 10)
    jst = jlm.init_decode_state(jcfg, B, 10, dtype=jnp.float32)
    st = lm.init_decode_state(cfg, B, 10, dtype=torch.float32, device="cpu")
    assert st["ssm"].h.shape == jst["ssm"].h.shape and st["ssm"].conv.shape == jst["ssm"].conv.shape
    for i in range(tokens.shape[1]):
        jl, jst = jlm.decode_step(jp, jst, jnp.asarray(tokens[:, i : i + 1]), jnp.int32(i), jcfg)
        tl, st = lm.decode_step(tp, st, torch.tensor(tokens[:, i : i + 1]), i, cfg)
        _close(tl, jl, **F32_LOGITS)
        _close(st["ssm"].h, jst["ssm"].h, **F32)


def test_decode_matches_forward(params):
    """The port's decode against its own forward over 4 chunks, float32."""
    _, tp = params
    cfg = configs.get(ARCH).replace(dtype="float32")
    tokens = torch.tensor(_tokens(cfg, 10, 32))
    ref, _ = lm.forward(tp, tokens, cfg)
    st = lm.init_decode_state(cfg, B, 32, dtype=torch.float32, device="cpu")
    outs = []
    for i in range(32):
        lg, st = lm.decode_step(tp, st, tokens[:, i : i + 1], i, cfg)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), ref, **DECODE_TOL)


def test_prefill_and_serve_on_the_cpu(params, capsys):
    _, tp = params
    cfg = configs.get(ARCH)
    tokens = torch.tensor(_tokens(cfg, 11, 16))
    last = prefill_step(tp, tokens, cfg)
    assert last.shape == (B, cfg.vocab_size) and last.dtype == torch.float32
    torch.testing.assert_close(last, lm.forward(tp, tokens, cfg)[0][:, -1], rtol=0, atol=0)
    a = serve(cfg, batch=2, prompt_len=4, gen=6, seed=3, device="cpu", params=tp)
    b = serve(cfg, batch=2, prompt_len=4, gen=6, seed=3, device="cpu", params=tp)
    assert a.shape == (2, 10) and np.array_equal(a, b)
    assert "tok/s" in capsys.readouterr().out


# --------------------------------------------------------------------------
# C-16: the intra-chunk exponent is masked before the exp
# --------------------------------------------------------------------------


def _with_dt_bias(jp, value):
    """The reference's parameters with every layer's ``dt_bias`` set to ``value``."""
    jp = jax.tree.map(lambda a: a, jp)
    ssm_p = dict(jp["blocks"]["ssm"])
    ssm_p["dt_bias"] = jnp.full_like(ssm_p["dt_bias"], value)
    jp["blocks"] = dict(jp["blocks"], ssm=ssm_p)
    return jp


def _grads_both(jp, value):
    """Loss gradients of both packages at ``dt_bias = value``, float32, with
    the full config's chunk of 64 over 1 x 128 tokens: (reference leaves
    carried over, port leaves, both losses)."""
    jcfg, cfg = _cfgs(dtype="float32", ssm_chunk=64)
    jp = _with_dt_bias(jp, value)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tokens = np.random.default_rng(16).integers(0, cfg.vocab_size, (1, 128))
    (jloss, _), jgrads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    grads, metrics = loss_and_grads(tp, {"tokens": torch.tensor(tokens)}, cfg)
    want = leaves(interop.lm_params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg, device="cpu"))
    return want, grads, float(jloss), float(metrics["loss"])


def test_c16_gradients_match_the_reference_where_it_is_finite(params):
    """At ``dt_bias`` 0 (the init) both packages' gradients are finite and
    agree at the float32 gradient tolerance."""
    want, grads, jloss, loss = _grads_both(params[0], 0.0)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for got, w in zip(grads, want, strict=True):
        assert bool(torch.isfinite(w).all()) and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4, atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("dt_bias", [1.0, 1.5, 2.0])
def test_c16_port_gradients_stay_finite_where_the_reference_turns_nan(params, dt_bias):
    """Past a chunk decay of ~88 the reference's exp above the diagonal
    overflows and its backward's 0 * inf gives NaN; the port masks first.
    Side by side: the reference NaN, the port finite; wherever the
    reference's gradient is finite the port's agrees with it."""
    want, grads, jloss, loss = _grads_both(params[0], dt_bias)
    assert np.isfinite(jloss) and np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert any(not bool(torch.isfinite(w).all()) for w in want), "the reference no longer turns NaN"
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    for got, w in zip(grads, want, strict=True):
        ok = torch.isfinite(w)
        if bool(ok.any()):
            scale = float(w[ok].abs().max())
            np.testing.assert_allclose(got[ok].numpy(), w[ok].numpy(), rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("dt_bias", [1.0, 1.5, 2.0])
def test_c16_forward_is_bitwise_the_mask_after_exp(params, dt_bias):
    """The mixer's forward at the overflowing ``dt_bias``: equal to the
    reference's at the float32 tolerance, and its intra-chunk decay
    ``exp(where(causal, rel, -inf))`` bitwise the reference's
    ``where(causal, exp(rel), 0)`` on the layer's own exponents, so masking
    first changes no bit of the forward."""
    jcfg, cfg = _cfgs(dtype="float32", ssm_chunk=64)
    jp = _with_dt_bias(params[0], dt_bias)
    p = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")["blocks"][0]["ssm"]
    x = _normal((1, 128, cfg.d_model), 17)
    want = jssm.ssm_forward(_layer0(jp), jnp.asarray(x), jcfg)
    got = ssm.ssm_forward(p, torch.tensor(x), cfg)
    # chunks of 64 sum eight times the smoke's terms: atol 1e-5, not 1e-6
    _close(got, want, rtol=1e-5, atol=1e-5)
    _, _, dt = ssm._split_proj(p, torch.tensor(x), cfg, torch.float32)
    d = ssm._softplus(dt + p["dt_bias"]) * -torch.exp(p["A_log"])
    cum = torch.cumsum(d.reshape(1, 2, 64, -1), dim=2)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.tril(torch.ones((64, 64), dtype=torch.bool))[None, None, :, :, None]
    assert bool(torch.isinf(torch.exp(rel)).any()), "no exponent overflows at this dt_bias"
    masked_first = torch.exp(torch.where(causal, rel, float("-inf")))
    masked_after = torch.where(causal, torch.exp(rel), 0.0)
    assert torch.equal(masked_first, masked_after)
