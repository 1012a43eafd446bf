"""Port parity: the MoE FFN and its three routers (``repro_torch.models.moe``)
held against the JAX package's ``repro.models.moe`` on
``olmoe_1b_7b:smoke``, with the reference's parameters and the same numpy
inputs.

Random draws: JAX's threefry and torch's Philox give different streams, so
the spar_sink router is held exactly by feeding it the reference's own
``jax.random.uniform(key, shape)`` draws (the private `moe._spar_sink_log_kernel`
takes them as an argument; `moe._uniforms` is patched where the draw sits
inside `moe_ffn`). Under the test suite's x64 those draws are float64, as
the reference's are, so ``u < p*`` compares in float64 in both packages.

Tolerances, float32 (the point is the algorithm): the Sinkhorn potentials'
log plan, the router probabilities and ``moe_ffn``'s output at rtol 1e-5 /
atol 1e-6, its aux loss at rtol 1e-6 (sums in other orders and other
exp/log implementations only); the routing (top-k choices and kept slots)
exactly. Two are wider, each for a stated reason:

* ``moe_ffn``'s output with a Sinkhorn router: atol 2e-6. The routers'
  exponent is scores / router_eps, so the scores' own float32 rounding (a
  64-term product summed in another order: up to 1.8e-7 apart) reaches the
  gates 20-fold. Measured over 12 seeds, the largest excess over rtol 1e-5
  was 9.2e-7 (sinkhorn) and 1.44e-6 (spar_sink); softmax 2.0e-7.
* gradients (of sum(out^2) + aux, entries up to about 30): rtol 1e-4 and
  an atol of 1e-6 times the leaf's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# one intra-op thread a process: the suite runs under six xdist workers, and
# torch's default of one thread a core would put 48 threads on 8 cores
torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe

ARCH = "olmoe_1b_7b:smoke"
F32 = dict(rtol=1e-5, atol=1e-6)
SINKHORN_F32 = dict(rtol=1e-5, atol=2e-6)  # moe_ffn's output with a Sinkhorn router


def _out_tol(router):
    return F32 if router == "softmax" else SINKHORN_F32


def _cfgs(**kw):
    kw.setdefault("dtype", "float32")
    return jconfigs.get(ARCH).replace(**kw), configs.get(ARCH).replace(**kw)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.fixture(scope="module")
def params():
    """The reference's MoE parameters (PRNGKey(2)) and the port's copy."""
    jcfg, _ = _cfgs()
    jp = jmoe.init_moe(jax.random.PRNGKey(2), jcfg)
    return jp, _torch(_numpy(jp))


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().to(torch.float32)), np.asarray(want, np.float32), **tol)


def _reference_draws(monkeypatch, key):
    """Make the port's router draw what ``jax.random.uniform(key, shape)``
    draws, as the reference's router does for one layer."""
    monkeypatch.setattr(moe, "_uniforms", lambda shape, generator, device: torch.tensor(
        np.asarray(jax.random.uniform(key, tuple(shape)))))


def _jax_routing(probs, cfg, cap):
    """The reference's routing, as `moe_ffn` computes it: top-k choices and
    each expert's kept slots."""
    topk_w, topk_idx = jax.lax.top_k(probs, cfg.experts_per_token)
    topk_w = topk_w / jnp.maximum(topk_w.sum(-1, keepdims=True), 1e-9)
    gate_e = jnp.einsum("bske,bsk->bse", jax.nn.one_hot(topk_idx, cfg.num_experts, dtype=jnp.float32), topk_w)
    keep_w, keep_idx = jax.lax.top_k(gate_e.swapaxes(1, 2), cap)
    return np.asarray(topk_idx), np.asarray(keep_w), np.asarray(keep_idx)


# --------------------------------------------------------------------------
# the router
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dropped_row", [False, True], ids=["dense_kernel", "row_all_dropped"])
def test_fixed_sinkhorn_matches_the_reference(dropped_row):
    b, n, e = 2, 24, 8
    logK = _normal((b, n, e), 0, 4.0)
    if dropped_row:
        logK[1, 5] = -1e30  # a spar_sink row with nothing kept
    loga = np.full((b, n), np.log(2 / n), np.float32)
    logb = np.full((b, e), np.log(2 / e), np.float32)
    want = jmoe._fixed_sinkhorn(*(jnp.asarray(a) for a in (logK, loga, logb)), 8)
    got = moe._fixed_sinkhorn(*(torch.as_tensor(a) for a in (logK, loga, logb)), 8)
    # with a dropped row, -1e30 + f cancels exactly: its log plan is g, not NaN
    assert bool(torch.isfinite(got).all()) and bool(jnp.isfinite(want).all())
    _close(got, want, **F32)


def test_sinkhorn_router_probs_matches_the_reference():
    jcfg, cfg = _cfgs(router="sinkhorn")
    scores = _normal((2, 64, cfg.num_experts), 1, 3.0) + np.linspace(0, 4, cfg.num_experts, dtype=np.float32)
    want = jmoe.sinkhorn_router_probs(jnp.asarray(scores), jcfg, None)
    got = moe.sinkhorn_router_probs(torch.as_tensor(scores), cfg, None)
    _close(got, want, **F32)
    _close(got.sum(-1), np.ones((2, 64)), **F32)


def _empty_row_case():
    """The spar_sink router on scores from PRNGKey(3) and the reference's
    draws from PRNGKey(5), (1, 256, 8): rows whose keep mask is empty."""
    jcfg, cfg = _cfgs(router="spar_sink")
    scores = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 256, cfg.num_experts)), np.float32)
    return jcfg, cfg, scores, jax.random.PRNGKey(5)


def test_spar_sink_router_on_the_reference_draws(monkeypatch):
    jcfg, cfg, scores, key = _empty_row_case()
    want = jmoe.sinkhorn_router_probs(jnp.asarray(scores), jcfg, key)
    u = torch.tensor(np.asarray(jax.random.uniform(key, scores.shape)))
    s32 = torch.as_tensor(scores)
    logK = (s32 - s32.amax(-1, keepdim=True)) / cfg.router_eps
    sketch = moe._spar_sink_log_kernel(logK, cfg, u)
    empty = (sketch == -1e30).all(-1)[0]
    # of 256 tokens, as on the reference (under x64, whose draws are float64;
    # its float32 draws leave 25 rows empty)
    assert int(empty.sum()) == 23
    _reference_draws(monkeypatch, key)
    got = moe.sinkhorn_router_probs(s32, cfg, None)
    _close(got, want, **F32)
    # every empty row gets the same probabilities (the softmax of g), in
    # both packages: exact ties for the top-k that follows
    rows = got[0, empty]
    assert torch.equal(rows, rows[:1].expand_as(rows))
    want_rows = np.asarray(want)[0, empty.numpy()]
    assert (want_rows == want_rows[:1]).all()


def test_spar_sink_uniforms_come_from_the_generator():
    _, cfg = _cfgs(router="spar_sink")
    scores = torch.as_tensor(_normal((1, 64, cfg.num_experts), 2))
    a = moe.sinkhorn_router_probs(scores, cfg, torch.Generator().manual_seed(1))
    b = moe.sinkhorn_router_probs(scores, cfg, torch.Generator().manual_seed(1))
    c = moe.sinkhorn_router_probs(scores, cfg, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # None draws from a generator seeded 0
    torch.testing.assert_close(moe.sinkhorn_router_probs(scores, cfg, None),
                               moe.sinkhorn_router_probs(scores, cfg, torch.Generator().manual_seed(0)), rtol=0, atol=0)


def test_top_k_puts_the_lower_index_first_among_ties():
    """600 entries of 0.125 among 4096 zeros: jax.lax.top_k takes the
    ties in index order; torch.topk takes other zeros; `_top_k` is the
    reference's order."""
    x = np.zeros(4096, np.float32)
    x[np.random.default_rng(0).choice(4096, 600, replace=False)] = 0.125
    _, want = jax.lax.top_k(jnp.asarray(x), 1024)
    _, ours = moe._top_k(torch.as_tensor(x), 1024)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
    _, theirs = torch.topk(torch.as_tensor(x), 1024)
    assert not np.array_equal(theirs.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# moe_ffn
# --------------------------------------------------------------------------


@pytest.mark.parametrize("router", ["softmax", "sinkhorn", "spar_sink"])
def test_moe_ffn_matches_the_reference(params, monkeypatch, router):
    jp, tp = params
    jcfg, cfg = _cfgs(router=router)
    x = _normal((2, 64, cfg.d_model), 3)
    key = jax.random.PRNGKey(7)
    want, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, key)
    _reference_draws(monkeypatch, key)
    got, aux = moe.moe_ffn(tp, torch.as_tensor(x), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _close(got, want, **_out_tol(router))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert aux.dtype == torch.float32 and aux.shape == ()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.625], ids=["zero_gates_tie", "empty_rows_tie"])
def test_moe_ffn_spar_sink_ties_are_cut_in_the_reference_order(monkeypatch, capacity_factor):
    """The router scores of `_empty_row_case` as the layer's own. The 23
    tokens with an empty keep mask tie exactly on the two experts they
    choose. At the config's capacity (80 of 256 tokens) those experts have
    room to spare and fill it with unchosen tokens, whose gates tie at 0;
    at half of it (40) the cut falls among the 23. Either way the kept
    tokens depend on the order among ties."""
    jcfg, cfg, scores, key = _empty_row_case()
    jcfg, cfg = jcfg.replace(capacity_factor=capacity_factor), cfg.replace(capacity_factor=capacity_factor)
    d = cfg.d_model
    # x and a router whose product is the case's scores: x = [scores, 0],
    # router = [I; 0]
    x = np.zeros((1, 256, d), np.float32)
    x[..., : cfg.num_experts] = scores
    jp = _numpy(jmoe.init_moe(jax.random.PRNGKey(4), jcfg))
    jp["router"]["w"] = np.eye(d, cfg.num_experts, dtype=np.float32)
    want, want_aux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg, key)
    _reference_draws(monkeypatch, key)
    tp = _torch(jp)
    cap = max(1, int(cfg.capacity_factor * cfg.experts_per_token * 256 / cfg.num_experts))
    probs = moe._router_probs(tp, torch.as_tensor(x), cfg, None)
    topk_idx, keep_w, keep_idx = moe._route(probs, cfg, cap)
    j_topk, j_keep_w, j_keep = _jax_routing(jnp.asarray(probs.numpy()), jcfg, cap)
    np.testing.assert_array_equal(topk_idx.numpy(), j_topk)
    np.testing.assert_array_equal(keep_idx.numpy(), j_keep)
    _close(keep_w, j_keep_w, rtol=0, atol=0)
    # the ties matter: the empty-row tokens choose the same experts, and
    # one of those experts keeps a token whose gate equals a dropped one's
    s32 = torch.as_tensor(scores)
    u = torch.tensor(np.asarray(jax.random.uniform(key, scores.shape)))
    empty = (moe._spar_sink_log_kernel((s32 - s32.amax(-1, keepdim=True)) / cfg.router_eps, cfg, u) == -1e30).all(-1)[0]
    tied = empty.nonzero()[:, 0].tolist()
    assert len(tied) == 23 and len({tuple(topk_idx[0, i].tolist()) for i in tied}) == 1
    topk_w = torch.gather(probs, 2, topk_idx)
    gate = torch.zeros_like(probs).scatter(2, topk_idx, topk_w / topk_w.sum(-1, keepdim=True))[0]
    cut_ties = []
    for e in topk_idx[0, tied[0]].tolist():
        dropped = torch.ones(256, dtype=torch.bool).index_fill_(0, keep_idx[0, e], False)
        cut_ties.append(bool((gate[dropped, e] == keep_w[0, e].min()).any()))
    assert any(cut_ties)
    got, aux = moe.moe_ffn(tp, torch.as_tensor(x), cfg)
    _close(got, want, **SINKHORN_F32)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("router", ["sinkhorn", "spar_sink"])
def test_moe_ffn_on_single_token_groups_matches_the_reference(params, monkeypatch, router):
    """The decode shape: each group is one token, capacity 1, so every
    expert keeps it (with weight 0 where it was not chosen)."""
    jp, tp = params
    jcfg, cfg = _cfgs(router=router)
    x = _normal((3, 1, cfg.d_model), 5)
    want, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, None)
    _reference_draws(monkeypatch, jax.random.PRNGKey(0))
    got, aux = moe.moe_ffn(tp, torch.as_tensor(x), cfg)
    _close(got, want, **SINKHORN_F32)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("router", ["softmax", "sinkhorn", "spar_sink"])
def test_moe_ffn_bf16_matches_the_reference(params, monkeypatch, router):
    """bf16 on the same bf16 input: the routing is the reference's exactly
    (the router runs in float32 on the bf16 scores), the output within the
    bf16 rounding of the expert products (atol 5e-2, RMS 1e-2, as the
    whole-model bf16 tests)."""
    jp, tp = params
    jcfg, cfg = _cfgs(router=router, dtype="bfloat16")
    x = np.asarray(jnp.asarray(_normal((2, 64, cfg.d_model), 6)).astype(jnp.bfloat16).astype(jnp.float32))
    key = jax.random.PRNGKey(8)
    want, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), jcfg, key)
    _reference_draws(monkeypatch, key)
    got, aux = moe.moe_ffn(tp, torch.tensor(x).to(torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16
    diff = got.float().numpy() - np.asarray(want.astype(jnp.float32))
    assert np.abs(diff).max() <= 5e-2 and np.sqrt(np.mean(diff**2)) <= 1e-2
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append((str(func.overloadpacket), args, kwargs or {}))
        return func(*args, **(kwargs or {}))


def test_moe_ffn_combines_without_an_accumulating_scatter(params):
    """Each token adds its experts' outputs by gathers in expert order: no
    ``index_add``/``scatter_add``/``scatter_reduce`` and no accumulating
    ``index_put``, which run as atomics on CUDA (results that change from
    run to run); repeated calls are bitwise equal."""
    _, tp = params
    _, cfg = _cfgs(router="sinkhorn")
    x = torch.as_tensor(_normal((2, 64, cfg.d_model), 9))
    with torch.no_grad(), _Ops() as ops:
        out, _ = moe.moe_ffn(tp, x, cfg)
    names = [name for name, _, _ in ops.calls]
    assert not [n for n in names if "index_add" in n or "scatter_add" in n or "scatter_reduce" in n]
    for name, args, kwargs in ops.calls:
        if "index_put" in name:
            assert not (kwargs.get("accumulate") or (len(args) > 3 and args[3])), name
    again, _ = moe.moe_ffn(tp, x, cfg)
    assert torch.equal(out, again)


@pytest.mark.parametrize("router", ["sinkhorn", "spar_sink"])
def test_moe_ffn_gradients_match_the_reference(params, monkeypatch, router):
    """The router is differentiable (the spar_sink draw and p* stopped), as
    in the reference's test_moe_router_is_differentiable: the gradients of
    sum(out^2) + aux at every parameter."""
    jp, tp = params
    jcfg, cfg = _cfgs(router=router)
    x = _normal((1, 32, cfg.d_model), 10)
    key = jax.random.PRNGKey(3)

    def f(p):
        out, aux = jmoe.moe_ffn(p, jnp.asarray(x), jcfg, key)
        return jnp.sum(out.astype(jnp.float32) ** 2) + aux

    want = jax.grad(f)(jp)
    _reference_draws(monkeypatch, key)
    leaves = {k: (v if k != "router" else v["w"]).clone().requires_grad_(True) for k, v in tp.items()}
    p = {**leaves, "router": {"w": leaves["router"]}}
    out, aux = moe.moe_ffn(p, torch.as_tensor(x), cfg)
    (out.float().pow(2).sum() + aux).backward()
    assert float(leaves["router"].grad.abs().sum()) > 0
    for k, t in leaves.items():
        w = want[k]["w"] if k == "router" else want[k]
        assert bool(torch.isfinite(t.grad).all())
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6 * float(np.abs(w).max()))


def test_init_moe_layout_and_scales():
    jcfg, cfg = _cfgs()
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    tp = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, tp)) == jax.tree.structure(jax.tree.map(lambda _: 0, jp))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    d, f = cfg.d_model, cfg.d_ff
    assert abs(float(tp["router"]["w"].std()) - 0.02) < 0.004
    assert abs(float(tp["wi"].std()) - d**-0.5) < 0.01 and abs(float(tp["wo"].std()) - f**-0.5) < 0.01
    meta = moe.init_moe(None, cfg, "meta")
    assert all(t.device.type == "meta" for t in jax.tree.leaves(meta))
