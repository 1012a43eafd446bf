"""Port parity: the RecurrentGemma training slice (``loss_fn`` and its
gradients, AdamW, the schedule, int8 error feedback, the token pipeline,
the train step, checkpoints and the train loop) held against the JAX
package on ``recurrentgemma_2b:smoke``, with the reference's parameters
and optimizer state carried over by `interop.train_state_from_numpy` and
the same numpy tokens.

Tolerances:

* float32 (``dtype="float32"``), where the point is the algorithm: the
  loss at rtol 1e-6, each gradient at rtol 1e-4 / atol 1e-6 (measured: the
  loss within 1.0e-6 and the gradients within 4.3e-7 on entries up to
  0.33); sums in other orders only.
* bf16, the default ``cfg.dtype``: XLA on the CPU and torch round bf16 at
  other places, so the loss is held at atol 2e-3 and the gradients at a
  relative L2 error of 0.06 over all leaves and 0.03 in any entry (measured
  over seeds 0-2: loss 4.7e-4, relative L2 0.031, largest entry 0.0127 on
  gradients up to 0.33).
* Three float32 train steps (lr 1e-3 after a 2-step warmup), alone and
  with ``microbatch=2``: the metrics at rtol 1e-5 (measured 1.7e-7),
  params at atol 2e-6,
  ``m`` at atol 1e-7, ``v`` at atol 1e-8 (measured: 2.4e-7, 2.9e-8,
  1.4e-9). With ``grad_compression=True`` the int8 rounding is a step
  function: an entry whose scaled target lies within rounding noise of a
  half-integer can round the other way in either package, moving that
  entry by one quantum (``amax / 127`` of its leaf). That is held as such:
  at most 1 % of the residuals differ (measured 0.39 %), each by at most
  one quantum, params within 5e-4 (measured 1.5e-4; the learning rate,
  one step's largest move, is 1e-3) and the metrics at rtol 1e-4 (the
  gradient norm after compression: measured 1.4e-5).
* The optimizer pieces on the same inputs: rtol 1e-6.
* The token pipeline, a checkpoint restored in the other package, and a
  resumed run against an uninterrupted one: bitwise.
"""
import json
import os
import signal
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
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro.train import checkpoint as jckpt
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs, interop
from repro_torch.configs import TrainConfig
from repro_torch.data import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    compress_int8,
    cosine_schedule,
    decompress_int8,
    ef_update,
    global_norm,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import leaves, leaves_with_paths, unflatten

ARCH = "recurrentgemma_2b:smoke"
STEP_KW = dict(seq_len=32, global_batch=4, lr=1e-3, warmup_steps=2, total_steps=10)


def _cfgs(**kw):
    return jconfigs.get(ARCH).replace(**kw), configs.get(ARCH).replace(**kw)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_params(jax.random.PRNGKey(0), jconfigs.get(ARCH))


@pytest.fixture
def sigterm():
    """`train_loop` installs a SIGTERM handler; put the old one back."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _port_grads(tparams, tokens, cfg, dtype):
    """loss_fn's value and gradients at the casts of every leaf to ``dtype``,
    as the train step takes them."""
    work = [p.detach().to(dtype).requires_grad_() for p in leaves(tparams)]
    loss, metrics = lm.loss_fn(unflatten(tparams, work), {"tokens": torch.as_tensor(tokens)}, cfg)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, [w.grad for w in work]


# --------------------------------------------------------------------------
# loss_fn and its gradients
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["chunked", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_the_reference(jparams, dtype, backend):
    # chunk 8 over S = 32: the chunked backend really chunks
    jcfg, cfg = _cfgs(dtype=dtype, rglru_backend=backend, rglru_chunk=8)
    tokens = _tokens((2, 32), 0)

    def jloss(p):
        p = jax.tree.map(lambda x: x.astype(jnp.dtype(dtype)), p)
        return jlm.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg, None, z_loss=1e-4)

    (want, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    before = dict(ops.LAUNCHES)
    got, metrics, grads = _port_grads(tparams, tokens, cfg, getattr(torch, dtype))
    assert ops.LAUNCHES == before
    assert set(metrics) == set(jmetrics) and float(metrics["moe_aux"]) == 0.0
    assert [tuple(g.shape) for g in grads] == [tuple(g.shape) for g in jax.tree.leaves(jgrads)]
    if dtype == "float32":
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        np.testing.assert_allclose(float(metrics["z_loss"]), float(jmetrics["z_loss"]), rtol=1e-5)
        for g, jg in zip(grads, jax.tree.leaves(jgrads)):
            np.testing.assert_allclose(_np(g), _np(jg), rtol=1e-4, atol=1e-6)
    else:
        assert abs(float(got) - float(want)) <= 2e-3
        a = np.concatenate([_np(g).ravel() for g in grads])
        b = np.concatenate([_np(g).ravel() for g in jax.tree.leaves(jgrads)])
        assert np.linalg.norm(a - b) <= 0.06 * np.linalg.norm(b)
        assert np.abs(a - b).max() <= 0.03


def test_loss_fn_is_the_shifted_lse_cross_entropy():
    """Against the definition in float64 on the port's own logits: mean of
    (lse - target logit) plus z_loss * mean(lse^2)."""
    cfg = configs.get(ARCH).replace(dtype="float32")
    params = lm.init_params(cfg, 1, device="cpu")
    tokens = torch.as_tensor(_tokens((2, 24), 1))
    total, m = lm.loss_fn(params, {"tokens": tokens}, cfg, z_loss=0.5)
    logits = lm.forward(params, tokens, cfg)[0][:, :-1].double()
    lse = torch.logsumexp(logits, -1)
    tgt = torch.gather(logits, -1, tokens[:, 1:, None].long())[..., 0]
    np.testing.assert_allclose(float(m["ce"]), float(torch.mean(lse - tgt)), rtol=1e-6)
    np.testing.assert_allclose(float(m["z_loss"]), 0.5 * float(torch.mean(lse**2)), rtol=1e-6)
    np.testing.assert_allclose(float(total), float(m["ce"] + m["z_loss"]), rtol=1e-7)


# --------------------------------------------------------------------------
# optimizer, schedule, compression, pipeline
# --------------------------------------------------------------------------


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"b": {"w": scale * rng.standard_normal((6, 5)).astype(np.float32)},
            "a": [scale * rng.standard_normal(7).astype(np.float32), np.float32(scale) * np.ones(3, np.float32)]}


def _as_torch(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


@pytest.mark.parametrize("grad_clip", [1.0, 0.0], ids=["clipped", "no_clip"])
def test_adamw_update_matches_the_reference(grad_clip):
    params, grads = _tree(0), [_tree(1 + i, 3.0) for i in range(3)]
    jp, jstate = jax.tree.map(jnp.asarray, params), jadamw.adamw_init(jax.tree.map(jnp.asarray, params))
    tp = _as_torch(params)
    tstate = adamw_init(tp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, jstate, jm = jadamw.adamw_update(jax.tree.map(jnp.asarray, g), jstate, jp, lr=lr, grad_clip=grad_clip)
        tp, tstate, tm = adamw_update(_as_torch(g), tstate, tp, lr=lr, grad_clip=grad_clip)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == np.float32(lr)
    assert int(tstate.step) == int(jstate.step) == 3 and tstate.step.dtype == torch.int32
    for got, want in ((tp, jp), (tstate.m, jstate.m), (tstate.v, jstate.v)):
        for x, y in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-9)


def test_adamw_update_clips_and_decays_every_leaf():
    """grad_clip / max(gnorm, 1e-9), not clip_grad_norm_'s norm + 1e-6; and
    weight decay on every leaf: at g = 0 the first step moves each p by
    exactly lr * wd * p (m = v = 0)."""
    p = {"scale": torch.ones(4), "w": torch.full((2, 2), 2.0)}
    state = adamw_init(p)
    zero = {"scale": torch.zeros(4), "w": torch.zeros(2, 2)}
    _, _, m = adamw_update(zero, state, p, lr=0.5, weight_decay=0.1)
    assert float(m["grad_norm"]) == 0.0
    torch.testing.assert_close(p["scale"], torch.full((4,), 1.0 - 0.5 * 0.1), rtol=0, atol=0)
    torch.testing.assert_close(p["w"], torch.full((2, 2), 2.0 - 0.5 * 0.1 * 2.0), rtol=0, atol=0)


def test_cosine_schedule_matches_the_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray([jadamw.cosine_schedule(jnp.int32(s), 3e-4, 10, 120) for s in steps])
    got = np.asarray([float(cosine_schedule(torch.tensor(int(s), dtype=torch.int32), 3e-4, 10, 120)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and got[10] == np.float32(3e-4)  # lr = 0 at step 0 under warmup
    np.testing.assert_allclose(got[-1], 3e-5, rtol=1e-6)


def test_global_norm_matches_the_reference():
    tree = _tree(5, 2.0)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    np.testing.assert_allclose(float(global_norm(_as_torch(tree))), want, rtol=1e-6)
    bf = jax.tree.map(lambda x: torch.tensor(np.asarray(x)).bfloat16(), tree)
    assert global_norm(bf).dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_error_feedback_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    grad = (rng.standard_normal(1000) * 10 ** rng.uniform(-3, 0)).astype(np.float32)
    res = (0.01 * rng.standard_normal(1000)).astype(np.float32)
    jq, js = jcompression.compress_int8(jnp.asarray(grad))
    q, s = compress_int8(torch.as_tensor(grad))
    assert q.dtype == torch.int8 and float(s) == float(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(decompress_int8(q, s).numpy(), np.asarray(jcompression.decompress_int8(jq, js)))
    jd, jr = jcompression.ef_update(jnp.asarray(grad), jnp.asarray(res))
    d, r = ef_update(torch.as_tensor(grad), torch.as_tensor(res))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


@pytest.mark.parametrize("host_count", [1, 2])
def test_token_pipeline_is_bitwise_the_references(host_count):
    for host in range(host_count):
        want = JTokenPipeline(256, 48, 8, seed=3, host_index=host, host_count=host_count)
        got = TokenPipeline(256, 48, 8, seed=3, host_index=host, host_count=host_count)
        for step in (0, 1, 17):
            a, b = got.batch(step), want.batch(step)
            assert a.dtype == b.dtype == np.int32 and a.shape == (8 // host_count, 48)
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TokenPipeline(256, 48, 6, host_count=4)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


def _ref_state(jcfg, jt):
    return jinit_train_state(jax.random.PRNGKey(0), jcfg, jt)


@pytest.mark.parametrize("variant", ["plain", "microbatch", "grad_compression"])
def test_train_steps_match_the_reference(variant):
    kw = dict(STEP_KW)
    if variant == "microbatch":
        kw["microbatch"] = 2
    elif variant == "grad_compression":
        kw["grad_compression"] = True
    jcfg, cfg = _cfgs(dtype="float32", rglru_backend="pallas")
    jt, tt = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = _ref_state(jcfg, jt)
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, tt, device="cpu")
    jstep, step = jax.jit(jmake_train_step(jcfg, jt)), make_train_step(cfg, tt)
    pipe = TokenPipeline(cfg.vocab_size, tt.seq_len, tt.global_batch, seed=0)
    rtol = 1e-4 if tt.grad_compression else 1e-5
    for i in range(3):
        tokens = pipe.batch(i)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)}, jax.random.PRNGKey(i))
        state, m = step(state, {"tokens": torch.as_tensor(tokens)})
        assert set(m) == set(jm) == {"loss", "ce", "z_loss", "moe_aux", "grad_norm", "lr"}
        assert all(v.ndim == 0 for v in m.values())
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, atol=1e-9, err_msg=f"step {i} {k}")
        if i == 0:
            assert float(m["lr"]) == 0.0  # warmup: step 0 has lr = 0
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    if variant != "grad_compression":
        for got, want, atol in ((state.params, jstate.params, 2e-6), (state.opt.m, jstate.opt.m, 1e-7),
                                (state.opt.v, jstate.opt.v, 1e-8)):
            for x, y in zip(leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=atol)
        assert state.ef is None
        return
    for x, y in zip(leaves(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=5e-4)
    differ = total = 0
    for x, y in zip(leaves(state.ef), jax.tree.leaves(jstate.ef)):
        x, y = x.numpy(), np.asarray(y)
        # a residual lies within half a quantum of 0, so a quantum is at most
        # twice the largest residual of its leaf
        quantum = 2 * max(np.abs(x).max(), np.abs(y).max())
        assert np.abs(x - y).max() <= 1.01 * quantum + 1e-6
        differ += int((np.abs(x - y) > 1e-6).sum())
        total += x.size
    assert differ <= 0.01 * total  # measured: 0.39 %


def test_train_step_moves_parameters_after_the_warmup_step():
    cfg = configs.get(ARCH).replace(rglru_backend="pallas")
    tt = TrainConfig(**STEP_KW)
    state = init_train_state(cfg, tt, 0, device="cpu")
    step = make_train_step(cfg, tt)
    pipe = TokenPipeline(cfg.vocab_size, tt.seq_len, tt.global_batch, seed=0)
    before = [p.clone() for p in leaves(state.params)]
    state, m = step(state, {"tokens": torch.as_tensor(pipe.batch(0))})
    assert float(m["lr"]) == 0.0 and all(torch.equal(a, b) for a, b in zip(before, leaves(state.params)))
    assert any(bool(v.abs().max() > 0) for v in leaves(state.opt.m))
    state, m = step(state, {"tokens": torch.as_tensor(pipe.batch(1))})
    assert float(m["lr"]) > 0 and all(not torch.equal(a, b) for a, b in zip(before, leaves(state.params)))
    assert all(bool(torch.isfinite(v)) for v in m.values())


def test_training_reduces_loss():
    """60 steps on the structured synthetic stream cut the loss, as
    tests/test_models.py::test_training_reduces_loss asks of the reference."""
    cfg = configs.get(ARCH).replace(rglru_backend="pallas")
    tt = TrainConfig(seq_len=64, global_batch=8, lr=3e-3, warmup_steps=5, total_steps=60, z_loss=0.0)
    state = init_train_state(cfg, tt, 0, device="cpu")
    step = make_train_step(cfg, tt)
    pipe = TokenPipeline(cfg.vocab_size, tt.seq_len, tt.global_batch, seed=0)
    losses = []
    for i in range(60):
        state, m = step(state, {"tokens": torch.as_tensor(pipe.batch(i))})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:5]) - 0.5, losses[::10]


# --------------------------------------------------------------------------
# train_state_from_numpy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["missing_moment_key", "wrong_moment_shape", "ef_without_compression",
                                   "step_not_scalar", "not_a_state"])
def test_train_state_from_numpy_refuses_a_wrong_tree(fault):
    jcfg, cfg = _cfgs()
    jstate = jax.tree.map(np.asarray, _ref_state(jcfg, JTrainConfig()))
    params, (stp, m, v), ef = jstate
    m = dict(m)
    tt = TrainConfig()
    if fault == "missing_moment_key":
        del m["final_norm"]
    elif fault == "wrong_moment_shape":
        m["embed"] = {"w": np.zeros((3, 3), np.float32)}
    elif fault == "ef_without_compression":
        ef = v
    elif fault == "step_not_scalar":
        stp = np.zeros(2, np.int32)
    tree = (params, (stp, m, v), ef) if fault != "not_a_state" else params
    with pytest.raises(ValueError):
        interop.train_state_from_numpy(tree, cfg, tt, device="cpu")


# --------------------------------------------------------------------------
# checkpoints (the counterparts of tests/test_checkpoint.py)
# --------------------------------------------------------------------------


def _ttree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.as_tensor(rng.standard_normal((8, 4))), "b": torch.as_tensor(rng.standard_normal(4))},
        "opt": [torch.as_tensor(rng.standard_normal(3)), torch.zeros((), dtype=torch.int32)],
    }


def test_checkpoint_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _ttree()
    ckpt.save_checkpoint(d, 10, tree)
    assert ckpt.latest_step(d) == 10
    target = jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    back = ckpt.restore_checkpoint(d, 10, target, device="cpu")
    for a, b in zip(leaves(tree), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a concrete target keeps its leaves' device
    back2 = ckpt.restore_checkpoint(d, 10, _ttree(1))
    assert all(torch.equal(a, b) for a, b in zip(leaves(tree), leaves(back2)))


def test_checkpoint_retention_keeps_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(d, step, _ttree(step), keep=2)
    assert sorted(int(n[5:]) for n in os.listdir(d) if n.startswith("step_")) == [4, 5]


def test_checkpoint_torn_ignored(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 7, _ttree())
    torn = os.path.join(d, "step_00000009")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        json.dump({"step": 9, "complete": False}, f)
    assert ckpt.latest_step(d) == 7
    bad = os.path.join(d, "step_00000011")
    os.makedirs(bad)
    with open(os.path.join(bad, "manifest.json"), "w") as f:
        f.write("garbage{{{")
    assert ckpt.latest_step(d) == 7
    assert ckpt.latest_step(str(tmp_path / "nothing_here")) is None


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 3, _ttree())
    target = _ttree()
    target["params"]["w"] = torch.zeros(9, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(d, 3, target)
    target = _ttree()
    target["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore_checkpoint(d, 3, target)


@pytest.mark.parametrize("grad_compression", [False, True], ids=["plain", "ef"])
def test_checkpoints_cross_between_the_packages(tmp_path, grad_compression):
    """A reference checkpoint of a TrainState restores in the port (the same
    flat keys), bitwise; and the port's restores in the reference."""
    jcfg, cfg = _cfgs()
    jt, tt = JTrainConfig(grad_compression=grad_compression), TrainConfig(grad_compression=grad_compression)
    jstate = _ref_state(jcfg, jt)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 4, jstate)
    target = init_train_state(cfg, tt, device="meta")
    got = ckpt.restore_checkpoint(str(tmp_path / "jax"), 4, target, device="cpu")
    want = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, tt, device="cpu")
    assert [p for p, _ in leaves_with_paths(got)] == [p for p, _ in leaves_with_paths(want)]
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ckpt.save_checkpoint(str(tmp_path / "torch"), 4, got)
    jtarget = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    back = jckpt.restore_checkpoint(str(tmp_path / "torch"), 4, jtarget)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------
# the train loop and its CLI
# --------------------------------------------------------------------------


def test_train_loop_resumed_from_its_checkpoint_continues_exactly(tmp_path, monkeypatch, sigterm):
    """A run stopped at step 3 (as SIGTERM stops it: a checkpoint, then
    exit) and rerun to step 6 ends bitwise where one uninterrupted run does."""
    cfg = configs.get(ARCH).replace(rglru_backend="pallas")

    def tcfg(d):
        return TrainConfig(seq_len=16, global_batch=2, lr=1e-3, warmup_steps=2, total_steps=6,
                           checkpoint_every=100, checkpoint_dir=str(tmp_path / d))

    ref, _ = launch_train.train_loop(cfg, tcfg("a"), device="cpu", log_every=1)
    assert ckpt.latest_step(str(tmp_path / "a")) == 6
    calls = iter(range(100))
    monkeypatch.setattr(ckpt, "preempted", lambda: next(calls) == 2)  # after steps 0, 1, 2
    stopped, _ = launch_train.train_loop(cfg, tcfg("b"), device="cpu")
    assert int(stopped.opt.step) == 3 and ckpt.latest_step(str(tmp_path / "b")) == 3
    monkeypatch.setattr(ckpt, "preempted", lambda: False)
    resumed, history = launch_train.train_loop(cfg, tcfg("b"), device="cpu", log_every=1)
    assert [s for s, _ in history] == [3, 4, 5]
    assert int(resumed.opt.step) == 6
    for a, b in zip(leaves(ref), leaves(resumed)):
        assert torch.equal(a, b)


def test_train_cli_runs_on_the_cpu(tmp_path):
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--steps", "3", "--seq", "16",
         "--batch", "2", "--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("step     0  loss ") and lines[-1].startswith("step     2  loss ")
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 3
    probe = ("import sys, repro_torch.launch.train, repro_torch.train, repro_torch.optim, repro_torch.interop\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
             "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_train_cli_takes_only_a_1x1_mesh():
    """``--mesh`` is DATAxMODEL of positive sizes (any such mesh now runs:
    tests/test_torch_distributed.py drives 2x4); anything else raises."""
    for bad in ("2x", "0x4", "2x4x2", "two"):
        with pytest.raises(ValueError, match="DATAxMODEL|at least 1"):
            launch_train.main(["--arch", ARCH, "--mesh", bad, "--device", "cpu"])


@pytest.mark.parametrize("cli", ["train", "serve"])
def test_cli_under_a_launcher_runs_as_its_rank(cli, monkeypatch, tmp_path):
    """Under ``torchrun`` (``WORLD_SIZE`` and the env:// variables set) each
    process is one rank: the CLI joins the launcher's group and starts no
    ranks of its own. Here a launcher's world of 1: ``--mesh 2x4`` then
    meets a group of 1 rank and says so; ``--mesh 1x1`` trains or serves."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import serve as launch_serve

    def refuse(*args):
        raise AssertionError("a rank of a launcher started ranks of its own")

    monkeypatch.setattr(launch_mesh, "launch_ranks", refuse)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    if cli == "train":
        run = lambda shape: launch_train.main(  # noqa: E731
            ["--arch", ARCH, "--mesh", shape, "--device", "cpu", "--steps", "2", "--seq", "16", "--batch", "2",
             "--ckpt-dir", str(tmp_path / shape)])
    else:
        run = lambda shape: launch_serve.main(  # noqa: E731
            ["--arch", ARCH, "--mesh", shape, "--device", "cpu", "--batch", "1", "--prompt-len", "2", "--gen", "2"])
    try:
        with pytest.raises(RuntimeError, match="the process group has 1 ranks; the mesh needs 8"):
            run("2x4")
        assert dist.is_initialized() and dist.get_world_size() == 1
        run("1x1")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if cli == "train":
        assert ckpt.latest_step(str(tmp_path / "1x1")) == 2


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path, sigterm):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, tt = configs.get(ARCH), TrainConfig(checkpoint_dir=str(tmp_path / "ckpt"), total_steps=1)
    ckpt.save_checkpoint(str(tmp_path / "c"), 1, {"w": torch.zeros(2)})
    for call in (
        lambda: init_train_state(cfg, tt),
        lambda: launch_train.train_loop(cfg, tt),
        lambda: interop.train_state_from_numpy(None, cfg, tt),
        lambda: ckpt.restore_checkpoint(str(tmp_path / "c"), 1, {"w": torch.empty(2, device="meta")}),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
