"""Port parity: the dense and MoE LM families (Qwen3, StableLM, StarCoder2,
Gemma3, OLMoE, Llama-4-Scout) held against the JAX package on their smoke
configs, with the reference's parameters carried over by
`interop.lm_params_from_numpy` (its stacked blocks split into the port's
per-layer list) and the same numpy tokens.

Random draws: the spar_sink router is held exactly by feeding the port the
reference's own draws (`moe._uniforms` patched): ``jax.random.uniform`` of
each layer's key from ``jax.random.split(rng, num_layers)`` in `forward`,
of ``PRNGKey(0)`` in every layer of `decode_step`.

Tolerances:

* float32 (``dtype="float32"``): the logits at rtol 1e-4 / atol 1e-5, the
  losses at rtol 1e-5, as the hybrid family's tests (tests/test_torch_lm.py).
* bf16, the default: atol 5e-2 and an RMS difference of 1e-2, as
  tests/test_torch_lm.py states. With a Sinkhorn router one more thing
  holds: its exponent is scores / router_eps = 20 x scores, computed from
  bf16 activations that the two packages round at different places, so a
  token whose two best experts are within that rounding can be routed to
  another expert in either package (a flip), and its output, and every
  later position's (causal attention), differ by far more than rounding.
  The test therefore records both packages' routing layer by layer, shows
  that the reference's router given the port's own layer inputs routes
  exactly as the port does (probabilities at rtol 1e-5 / atol 1e-6), and
  holds the positions of each sequence before its first flip at the bf16
  tolerance; it names the flips.
* The port's decode against its own forward: the reference test's
  rtol 2e-2 / atol 2e-3 (tests/test_models.py::test_decode_matches_forward).
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
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import configs, interop
from repro_torch.launch.serve import prefill_step, serve
from repro_torch.models import lm, moe
from repro_torch.models.attention import KVCache
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import unflatten

ARCHS = ("olmoe_1b_7b", "llama4_scout_17b_a16e", "qwen3_14b", "stablelm_3b", "starcoder2_7b", "gemma3_12b")
MOE_ARCHS = ("olmoe_1b_7b", "llama4_scout_17b_a16e")
# jax.eval_shape of the reference's init_params on each published config
FULL_PARAM_COUNTS = {
    "olmoe_1b_7b": 6_919_100_416,
    "llama4_scout_17b_a16e": 101_730_063_360,
    "qwen3_14b": 14_768_307_200,
    "stablelm_3b": 2_795_276_800,
    "starcoder2_7b": 10_116_960_768,
    "gemma3_12b": 12_772_052_736,
}
F32_LOGITS = dict(rtol=1e-4, atol=1e-5)
F32 = dict(rtol=1e-5, atol=1e-6)
B, S = 2, 40


def _cfgs(arch, **kw):
    name = arch + ":smoke"
    return jconfigs.get(name).replace(**kw), configs.get(name).replace(**kw)


_PARAMS = {}


def _params(arch):
    """The reference's smoke parameters (PRNGKey(0)) and the port's copy."""
    if arch not in _PARAMS:
        jcfg, cfg = _cfgs(arch)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        _PARAMS[arch] = jp, interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return _PARAMS[arch]


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().to(torch.float32)), np.asarray(want, np.float32), **tol)


def _layer_draws(monkeypatch, keys, shape):
    """The port's router draws the reference's ``uniform(key, shape)``, one
    key after another (one a layer, in order)."""
    draws = iter([torch.tensor(np.asarray(jax.random.uniform(k, shape))) for k in keys])
    monkeypatch.setattr(moe, "_uniforms", lambda shape_, generator, device: next(draws))


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_full_parameter_count_on_meta(arch):
    cfg = configs.get(arch)
    p = lm.init_params(cfg, 0, device="meta")
    assert lm.param_count(p) == FULL_PARAM_COUNTS[arch]
    assert all(t.device.type == "meta" for t in jax.tree.leaves(p)) and len(p["blocks"]) == cfg.num_layers
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jconfigs.get(arch)), jax.random.PRNGKey(0))
    assert jlm.param_count(shapes) == FULL_PARAM_COUNTS[arch]


@pytest.mark.parametrize("name", ["gemma3_12b", "gemma3_12b:smoke", "qwen3_14b", "olmoe_1b_7b:smoke"])
def test_layer_windows_match_the_reference(name):
    windows = lm.layer_windows(configs.get(name))
    assert windows == np.asarray(jlm.layer_windows(jconfigs.get(name))).tolist()
    if name == "gemma3_12b":
        assert windows[:6] == [1024] * 5 + [0] and windows.count(0) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_the_reference(arch):
    jp, _ = _params(arch)
    cfg = configs.get(arch + ":smoke")
    a = lm.init_params(cfg, 3, device="cpu")
    b = lm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y) and x.dtype == torch.float32
    # the reference's stacked blocks: the port's per-layer leaves stacked
    stacked = dict(a, blocks=jax.tree.map(lambda *ts: torch.stack(ts), *a["blocks"]))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, stacked)) == jax.tree.structure(jax.tree.map(lambda _: 0, jp))
    assert [tuple(t.shape) for t in jax.tree.leaves(stacked)] == [t.shape for t in jax.tree.leaves(jp)]


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------


def _kept(keep_idx, s):
    """(B, E, cap) kept slots -> (B, S, E): token s kept by expert e."""
    keep_idx = np.asarray(keep_idx)
    b, e, _ = keep_idx.shape
    kept = np.zeros((b, s, e), bool)
    for i in range(b):
        for j in range(e):
            kept[i, keep_idx[i, j], j] = True
    return kept


def _jax_routing(probs, cfg, cap):
    topk_w, topk_idx = jax.lax.top_k(probs, cfg.experts_per_token)
    topk_w = topk_w / jnp.maximum(topk_w.sum(-1, keepdims=True), 1e-9)
    gate_e = jnp.einsum("bske,bsk->bse", jax.nn.one_hot(topk_idx, cfg.num_experts, dtype=jnp.float32), topk_w)
    _, keep_idx = jax.lax.top_k(gate_e.swapaxes(1, 2), cap)
    return np.sort(np.asarray(topk_idx), -1), _kept(keep_idx, probs.shape[1])


def _bf16_moe_forward(monkeypatch, arch, jp, tp, jcfg, cfg, tokens):
    """Both packages' bf16 logits with their routing recorded layer by
    layer; returns (got, want, held (B, S) bool, flips)."""
    want, _ = jlm.forward(jp, jnp.asarray(tokens), jcfg)
    # the reference's MoE inputs, layer by layer, from inside its scan
    ref_inputs = []
    orig = jmoe.moe_ffn

    def recording(params, x, cfg_, rng=None):
        jax.debug.callback(lambda a: ref_inputs.append(np.asarray(a)), x.astype(jnp.float32), ordered=True)
        return orig(params, x, cfg_, rng)

    monkeypatch.setattr(jmoe, "moe_ffn", recording)
    again, _ = jlm.forward(jp, jnp.asarray(tokens), jcfg)
    monkeypatch.setattr(jmoe, "moe_ffn", orig)
    np.testing.assert_array_equal(np.asarray(again), np.asarray(want))  # the recording changed nothing
    # the port's MoE inputs, probabilities and routing
    port = []
    o_probs, o_route = moe._router_probs, moe._route

    def router_probs(params, x, cfg_, generator):
        port.append([x, params["router"]["w"], o_probs(params, x, cfg_, generator)])
        return port[-1][2]

    def route(probs, cfg_, cap):
        port[-1].append(o_route(probs, cfg_, cap))
        return port[-1][3]

    monkeypatch.setattr(moe, "_router_probs", router_probs)
    monkeypatch.setattr(moe, "_route", route)
    got, _ = lm.forward(tp, torch.as_tensor(tokens), cfg)
    assert len(ref_inputs) == len(port) == cfg.num_layers

    s = tokens.shape[1]
    cap = max(1, int(cfg.capacity_factor * cfg.experts_per_token * s / cfg.num_experts))
    first_flip = np.full(tokens.shape[0], s)
    flips = []
    for layer, (x_ref, (x, w, probs, (topk_idx, _, keep_idx))) in enumerate(zip(ref_inputs, port)):
        port_routing = np.sort(topk_idx.numpy(), -1), _kept(keep_idx, s)
        w = jnp.asarray(w.numpy())

        def reference_router(x_bf16):
            scores = jnp.einsum("bsd,de->bse", x_bf16, w.astype(jnp.bfloat16)).astype(jnp.float32)
            return jmoe.sinkhorn_router_probs(scores, jcfg, None)

        # the reference's router on the port's own inputs routes as the port
        on_port = reference_router(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
        _close(probs, on_port, **F32)
        for mine, theirs in zip(port_routing, _jax_routing(on_port, jcfg, cap)):
            np.testing.assert_array_equal(mine, theirs)
        # the reference's routing on its own inputs: where it differs, a flip
        ref_routing = _jax_routing(reference_router(jnp.asarray(x_ref).astype(jnp.bfloat16)), jcfg, cap)
        differ = (ref_routing[0] != port_routing[0]).any(-1) | (ref_routing[1] != port_routing[1]).any(-1)
        for bi, si in zip(*np.nonzero(differ)):
            flips.append((layer, int(bi), int(si)))
            first_flip[bi] = min(first_flip[bi], si)
    held = np.arange(s)[None, :] < first_flip[:, None]
    return got, want, held, flips


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(monkeypatch, arch, dtype):
    jp, tp = _params(arch)
    jcfg, cfg = _cfgs(arch, dtype=dtype)
    tokens = _tokens(cfg, 9)
    if dtype == "bfloat16" and arch in MOE_ARCHS:
        got, want, held, flips = _bf16_moe_forward(monkeypatch, arch, jp, tp, jcfg, cfg, tokens)
        print(f"{arch} bf16: flips (layer, sequence, position) {flips}; {int(held.sum())} of {held.size} "
              f"positions held")
        assert held[:, 0].all()
    else:
        want, want_aux = jlm.forward(jp, jnp.asarray(tokens), jcfg)
        got, aux = lm.forward(tp, torch.as_tensor(tokens), cfg)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5 if dtype == "float32" else 1e-2)
        assert (float(aux) == 0.0) == (arch not in MOE_ARCHS)
        held = np.ones(tokens.shape, bool)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape) == (B, S, cfg.vocab_size)
    if dtype == "float32":
        _close(got, want, **F32_LOGITS)
    else:
        diff = (got.numpy() - np.asarray(want))[held]
        assert np.abs(diff).max() <= 5e-2 and np.sqrt(np.mean(diff**2)) <= 1e-2


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "gemma3_12b"])
def test_prefill_step_is_the_last_position_of_forward(arch):
    jp, tp = _params(arch)
    jcfg, cfg = _cfgs(arch, dtype="float32")
    tokens = _tokens(cfg, 11)
    want, _ = jlm.forward(jp, jnp.asarray(tokens), jcfg, last_only=True)
    got, _ = lm.forward(tp, torch.as_tensor(tokens), cfg, last_only=True)
    _close(got, want, **F32_LOGITS)
    step = prefill_step(tp, torch.as_tensor(tokens), cfg)
    assert tuple(step.shape) == (B, cfg.vocab_size)
    torch.testing.assert_close(step, got[:, -1, :], rtol=0, atol=0)


def test_spar_sink_forward_and_loss_on_the_reference_draws(monkeypatch):
    """OLMoE with the spar_sink router: each layer draws from its own key of
    ``jax.random.split(rng, num_layers)``, in the reference and (fed those
    draws) in the port; logits, the summed aux and every loss term."""
    jp, tp = _params("olmoe_1b_7b")
    jcfg, cfg = _cfgs("olmoe_1b_7b", dtype="float32", router="spar_sink")
    tokens = _tokens(cfg, 12)
    key = jax.random.PRNGKey(5)
    layer_keys = jax.random.split(key, cfg.num_layers)
    want, want_aux = jlm.forward(jp, jnp.asarray(tokens), jcfg, rng=key)
    _layer_draws(monkeypatch, layer_keys, (B, S, cfg.num_experts))
    got, aux = lm.forward(tp, torch.as_tensor(tokens), cfg)
    _close(got, want, **F32_LOGITS)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    jtotal, jm = jlm.loss_fn(jp, {"tokens": jnp.asarray(tokens)}, jcfg, key)
    _layer_draws(monkeypatch, layer_keys, (B, S, cfg.num_experts))
    total, m = lm.loss_fn(tp, {"tokens": torch.as_tensor(tokens)}, cfg)
    assert float(m["moe_aux"]) > 0
    for k in ("ce", "z_loss", "moe_aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_scout_17b_a16e", "gemma3_12b"])
def test_loss_fn_matches_the_reference(arch):
    jp, tp = _params(arch)
    jcfg, cfg = _cfgs(arch, dtype="float32")
    tokens = _tokens(cfg, 13)
    jtotal, jm = jlm.loss_fn(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    total, m = lm.loss_fn(tp, {"tokens": torch.as_tensor(tokens)}, cfg)
    for k in ("ce", "z_loss", "moe_aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    assert (float(m["moe_aux"]) > 0) == (arch in MOE_ARCHS)


def test_loss_gradients_match_the_reference():
    """OLMoE (the sinkhorn router) in float32: the gradient of the loss at
    every parameter, the router's included, at rtol 1e-4 and an atol of
    1e-5 times the leaf's largest entry (sums over tokens and layers in
    other orders; a leaf's small entries are differences of large terms)."""
    jp, tp = _params("olmoe_1b_7b")
    jcfg, cfg = _cfgs("olmoe_1b_7b", dtype="float32")
    tokens = _tokens(cfg, 14)
    (jloss, _), jgrads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    grads, metrics = loss_and_grads(tp, {"tokens": torch.as_tensor(tokens)}, cfg)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    # the port's gradients (per-layer blocks) stacked like the reference's
    g = unflatten(tp, grads)
    g = dict(g, blocks=jax.tree.map(lambda *ts: torch.stack(ts), *g["blocks"]))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, g)) == jax.tree.structure(jax.tree.map(lambda _: 0, jgrads))
    for got, want in zip(jax.tree.leaves(g), jax.tree.leaves(jgrads)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))
    assert float(g["blocks"]["ffn"]["router"]["w"].abs().sum()) > 0


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,router", [("olmoe_1b_7b", "softmax"), ("olmoe_1b_7b", "spar_sink"), ("gemma3_12b", None)])
def test_decode_steps_match_the_reference(monkeypatch, arch, router):
    """Teacher-forced steps of both packages' decode_step, logits and
    caches compared step by step (gemma3's window of 16 is passed). MoE
    decode routes each token alone (capacity 1), so it is held against
    the reference's decode, not its forward; the spar_sink router draws
    from ``PRNGKey(0)`` in every layer and step, as the reference's. The
    published sinkhorn router is not held here: on a group of one token
    its plan's row is log(k/E) up to rounding, so its top-k is decided by
    rounding (`test_sinkhorn_router_on_one_token_is_uniform_to_rounding`)."""
    jp, tp = _params(arch)
    kw = dict(dtype="float32") if router is None else dict(dtype="float32", router=router)
    jcfg, cfg = _cfgs(arch, **kw)
    b, s = 2, (12 if cfg.is_moe else 24)  # gemma3 past its window; each JAX MoE step compiles anew
    tokens = _tokens(cfg, 10, (b, s))
    jstate = jlm.init_decode_state(jcfg, b, s, dtype=jnp.float32)
    tstate = lm.init_decode_state(cfg, b, s, dtype=torch.float32, device="cpu")
    assert isinstance(tstate["kv"], KVCache) and tuple(tstate["kv"].k.shape) == jstate["kv"].k.shape
    u0 = torch.tensor(np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (b, 1, cfg.num_experts or 1))))
    monkeypatch.setattr(moe, "_uniforms", lambda shape, generator, device: u0)
    for i in range(s):
        want, jstate = jlm.decode_step(jp, jstate, jnp.asarray(tokens[:, i : i + 1]), jnp.int32(i), jcfg)
        got, tstate = lm.decode_step(tp, tstate, torch.as_tensor(tokens[:, i : i + 1]), i, cfg)
        _close(got, want, **F32_LOGITS)
    _close(tstate["kv"].k, jstate["kv"].k, **F32_LOGITS)
    _close(tstate["kv"].v, jstate["kv"].v, **F32_LOGITS)


def test_sinkhorn_router_on_one_token_is_uniform_to_rounding():
    """In decode each token is its own routing group (N = 1). Balancing one
    row against the expert marginal gives g = log(k/E) - (logK + f), so the
    log plan logK + f + g is log(k/E) in every entry up to the rounding of
    those two sums, and the probabilities are 1/E to within a few ulps: the
    top-k is a choice among ties that rounding decides, in the reference as
    in the port. Every layer and step of the port's OLMoE decode, and the
    reference's router on the same scores, show it."""
    jp, tp = _params("olmoe_1b_7b")
    jcfg, cfg = _cfgs("olmoe_1b_7b", dtype="float32")
    assert cfg.router == "sinkhorn"
    probs = []
    o_probs = moe._router_probs

    def recording(params, x, cfg_, generator):
        scores = (x @ params["router"]["w"].to(x.dtype)).to(torch.float32)
        probs.append((scores, o_probs(params, x, cfg_, generator)))
        return probs[-1][1]

    tokens = _tokens(cfg, 16, (2, 8))
    state = lm.init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "_router_probs", recording)
        for i in range(8):
            _, state = lm.decode_step(tp, state, torch.as_tensor(tokens[:, i : i + 1]), i, cfg)
    assert len(probs) == 8 * cfg.num_layers
    uniform = 1.0 / cfg.num_experts
    for scores, p in probs:
        assert float((p - uniform).abs().max()) <= 4 * np.spacing(np.float32(uniform))
        want = np.asarray(jmoe.sinkhorn_router_probs(jnp.asarray(scores.numpy()), jcfg, None))
        assert np.abs(want - uniform).max() <= 4 * np.spacing(np.float32(uniform))
    # over a group of many tokens (layer 0's eight steps as one sequence) it routes
    many = jmoe.sinkhorn_router_probs(
        jnp.asarray(np.concatenate([s.numpy() for s, _ in probs[:: cfg.num_layers]], axis=1)), jcfg, None)
    assert float(jnp.abs(many - uniform).max()) > 1e-2


@pytest.mark.parametrize("arch", ["qwen3_14b", "gemma3_12b"])
def test_decode_matches_forward(arch):
    """The port's own check (tests/test_models.py::test_decode_matches_forward
    for these archs): tokens fed one by one through decode_step give the
    logits of one parallel forward."""
    cfg = configs.get(arch + ":smoke").replace(dtype="float32")
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


# --------------------------------------------------------------------------
# determinism, interop, entry points
# --------------------------------------------------------------------------


def test_forward_is_deterministic_for_a_seed():
    _, tp = _params("olmoe_1b_7b")
    cfg = configs.get("olmoe_1b_7b:smoke").replace(router="spar_sink")
    tokens = torch.as_tensor(_tokens(cfg, 15))

    def run(generator):
        return lm.forward(tp, tokens, cfg, generator=generator)[0]

    a, b = run(torch.Generator().manual_seed(1)), run(torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, run(torch.Generator().manual_seed(2)))
    # None: one generator seeded 0, drawn layer after layer
    assert torch.equal(run(None), run(torch.Generator().manual_seed(0)))
    state_logits = []
    for _ in range(2):
        state = lm.init_decode_state(cfg, B, 4, device="cpu")
        state_logits.append(lm.decode_step(tp, state, tokens[:, :1], 0, cfg)[0])
    assert torch.equal(*state_logits)


@pytest.mark.parametrize("fault", ["layer_axis", "missing_key", "extra_key", "wrong_shape", "scalar_leaf"])
def test_lm_params_from_numpy_refuses_a_wrong_stacked_tree(fault):
    jp, _ = _params("olmoe_1b_7b")
    tree = jax.tree.map(np.asarray, jp)
    blocks = tree["blocks"]
    ffn = dict(blocks["ffn"])
    if fault == "layer_axis":
        ffn["wi"] = ffn["wi"][:1]
    elif fault == "missing_key":
        del ffn["wg"]
    elif fault == "extra_key":
        ffn["bias"] = np.zeros((2, 3), np.float32)
    elif fault == "wrong_shape":
        ffn["router"] = {"w": np.zeros((2, 64, 4), np.float32)}
    else:
        ffn["wo"] = np.float32(0.0)
    tree["blocks"] = dict(blocks, ffn=ffn)
    with pytest.raises(ValueError):
        interop.lm_params_from_numpy(tree, configs.get("olmoe_1b_7b:smoke"), device="cpu")


def test_serve_of_the_new_families_is_deterministic_for_a_seed():
    for arch in ("olmoe_1b_7b", "gemma3_12b"):
        cfg = configs.get(arch + ":smoke")
        a = serve(cfg, batch=2, prompt_len=4, gen=5, seed=1, device="cpu")
        b = serve(cfg, batch=2, prompt_len=4, gen=5, seed=1, device="cpu")
        assert a.shape == (2, 9) and ((a >= 0) & (a < cfg.vocab_size)).all()
        np.testing.assert_array_equal(a, b)


def test_serve_cli_runs_olmoe_on_the_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "olmoe_1b_7b:smoke", "--batch", "2",
         "--prompt-len", "4", "--gen", "4", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("sample: [")
    probe = ("import sys, repro_torch.models.moe, repro_torch.models.lm, repro_torch.interop\n"
             "import repro_torch.configs as c\n"
             "[c.get(a) for a in ('olmoe_1b_7b', 'qwen3_14b', 'stablelm_3b', 'starcoder2_7b', 'gemma3_12b',"
             " 'llama4_scout_17b_a16e')]\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
             "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("olmoe_1b_7b", "gemma3_12b"):
        cfg = configs.get(arch + ":smoke")
        for call in (
            lambda: lm.init_params(cfg, 0),
            lambda: lm.init_decode_state(cfg, 1, 8),
            lambda: serve(cfg, batch=1, prompt_len=2, gen=2),
            lambda: interop.lm_params_from_numpy({}, cfg),
        ):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()
