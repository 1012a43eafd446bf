"""``cfg.remat``, `make_serve_step` and ``train_loop(extras_fn=...)`` in
the port, on the smoke configs of every family whose layer bodies the
reference's ``_maybe_ckpt`` wraps: dense (``qwen3_14b``), moe
(``olmoe_1b_7b`` with the spar_sink router, whose layers draw from one
`torch.Generator` in turn), ssm (``mamba2_130m``), vlm
(``llama32_vision_11b``) and audio (``whisper_large_v3``, its encoder
included).

Recomputing a layer body runs the same operations on the same inputs, so
``"full"`` and ``"dots"`` must give the bits of ``"none"``: the losses and
every gradient are compared for exact equality, in the default bf16 with
the parameters cast once (``cast_params_once``), as a train step takes
them.
"""
import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers, and
# torch's default of one thread a core would put 48 threads on 8 cores
torch.set_num_threads(1)

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.train import train_loop
from repro_torch.models import lm
from repro_torch.train import make_serve_step, make_train_step
from repro_torch.train.step import init_train_state, loss_and_grads

ARCHS = ("qwen3_14b", "olmoe_1b_7b", "mamba2_130m", "llama32_vision_11b", "whisper_large_v3")
B, S = 2, 16


def _cfg(arch, **kw):
    cfg = configs.get(arch + ":smoke")
    if cfg.is_moe:
        kw.setdefault("router", "spar_sink")
    return cfg.replace(**kw)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "vlm":
        batch["images"] = torch.tensor(rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "audio":
        batch["frames"] = torch.tensor(rng.standard_normal((B, cfg.num_frames, cfg.d_model)), dtype=torch.float32)
    return batch


def _loss_and_grads(arch, remat, seed=0):
    cfg = _cfg(arch, remat=remat)
    params = lm.init_params(cfg, 0, device="cpu")
    return loss_and_grads(params, _batch(cfg, seed), cfg)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_bits_of_no_remat(arch, remat):
    want_g, want_m = _loss_and_grads(arch, "none")
    got_g, got_m = _loss_and_grads(arch, remat)
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), k
    assert len(got_g) == len(want_g)
    differ = [i for i, (g, w) in enumerate(zip(got_g, want_g)) if not torch.equal(g, w)]
    assert not differ, f"{arch} remat={remat}: gradients {differ} differ"
    assert all(bool(torch.isfinite(g).all()) for g in got_g)


def test_remat_is_the_reference_default():
    assert all(configs.get(a).remat == "full" for a in configs.ARCH_IDS)


def test_recomputation_without_the_generator_state_changes_the_gradients(monkeypatch):
    """The trap that `lm._remat` avoids: the spar_sink router draws from an
    explicit generator, which `torch.utils.checkpoint` does not restore.
    With the recomputation handed the live generator (advanced past every
    layer), its draws differ from the first run's, and so do the
    gradients; the test of bitwise equality above would catch it."""
    want_g, _ = _loss_and_grads("olmoe_1b_7b", "none")
    monkeypatch.setattr(lm, "generator_at", lambda generator, state: generator)
    got_g, _ = _loss_and_grads("olmoe_1b_7b", "full")
    assert any(not torch.equal(g, w) for g, w in zip(got_g, want_g))


def test_no_remat_when_no_gradient_is_recorded(monkeypatch):
    """Prefill and decode run under ``no_grad``: no checkpoint is taken."""
    calls = []
    monkeypatch.setattr(lm, "checkpoint", lambda *a, **k: calls.append(1))
    cfg = _cfg("mamba2_130m", remat="full")
    params = lm.init_params(cfg, 0, device="cpu")
    with torch.no_grad():
        lm.forward(params, _batch(cfg, 1)["tokens"], cfg)
    assert not calls


@pytest.mark.parametrize("arch", ["mamba2_130m", "llama32_vision_11b", "whisper_large_v3"])
def test_make_serve_step_is_decode_step(arch):
    cfg = _cfg(arch)
    params = lm.init_params(cfg, 0, device="cpu")
    key = {"vlm": "images", "audio": "enc_out"}.get(cfg.family)
    m = cfg.num_image_tokens if cfg.family == "vlm" else cfg.num_frames
    extras = None if key is None else {key: torch.randn((B, m, cfg.d_model), generator=torch.Generator().manual_seed(2))}
    step = make_serve_step(cfg)
    states = [lm.fill_cross_cache(params, cfg, lm.init_decode_state(cfg, B, 6, device="cpu"), extras) if extras
              else lm.init_decode_state(cfg, B, 6, device="cpu") for _ in range(2)]
    tokens = _batch(cfg, 3)["tokens"]
    with torch.no_grad():
        for i in range(6):
            got, states[0] = step(params, states[0], tokens[:, i : i + 1], i, extras)
            want, states[1] = lm.decode_step(params, states[1], tokens[:, i : i + 1], i, cfg, extras)
            assert torch.equal(got, want)


def test_microbatches_split_the_extras():
    """A step of two microbatches of one row: its loss is the mean of each
    row's loss with that row's frames."""
    cfg = _cfg("whisper_large_v3")
    tcfg = TrainConfig(seq_len=S, global_batch=B, microbatch=1, total_steps=4, warmup_steps=1)
    state = init_train_state(cfg, tcfg, 0, device="cpu")
    batch = _batch(cfg, 4)
    rows = [loss_and_grads(state.params, {k: v[i : i + 1] for k, v in batch.items()}, cfg)[1]["loss"] for i in range(B)]
    _, metrics = make_train_step(cfg, tcfg)(state, batch)
    assert torch.equal(metrics["loss"], (rows[0] + rows[1]) / 2)


def test_train_loop_takes_extras_fn(tmp_path, capsys):
    """Two steps of Whisper's smoke config with stub frames each step."""
    cfg = _cfg("whisper_large_v3")
    tcfg = TrainConfig(seq_len=S, global_batch=B, total_steps=2, warmup_steps=1, checkpoint_every=0,
                       checkpoint_dir=str(tmp_path))
    seen = []

    def extras_fn(step):
        seen.append(step)
        rng = np.random.default_rng(step)
        return {"frames": rng.standard_normal((B, cfg.num_frames, cfg.d_model)).astype(np.float32)}

    state, history = train_loop(cfg, tcfg, device="cpu", log_every=1, extras_fn=extras_fn)
    assert seen == [0, 1] and [s for s, _ in history] == [0, 1]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for _, m in history)
    assert int(state.opt.step) == 2 and "step     1" in capsys.readouterr().out


@pytest.mark.parametrize("arch,bodies", [("qwen3_14b", 2), ("mamba2_130m", 2), ("llama32_vision_11b", 1),
                                         ("whisper_large_v3", 4)])
def test_each_layer_body_is_checkpointed_once(monkeypatch, arch, bodies):
    """One checkpoint a layer body: a vlm group, each of Whisper's encoder
    and decoder layers."""
    real, calls = lm.checkpoint, []
    monkeypatch.setattr(lm, "checkpoint", lambda fn, *a, **k: calls.append(fn) or real(fn, *a, **k))
    _loss_and_grads(arch, "full")
    assert len(calls) == bodies


def test_dots_saves_the_unbatched_products_and_recomputes_the_rest(monkeypatch):
    seen = {}

    def policy(ctx, op, *args, **kwargs):
        decision = lm_policy(ctx, op, *args, **kwargs)
        seen.setdefault(str(op), set()).add(decision)
        return decision

    lm_policy = lm._save_dots
    monkeypatch.setattr(lm, "_save_dots", policy)
    _loss_and_grads("qwen3_14b", "dots")
    must = {op for op, d in seen.items() if lm.CheckpointPolicy.MUST_SAVE in d}
    assert must == {"aten.mm.default"}
    assert lm.CheckpointPolicy.PREFER_RECOMPUTE in seen["aten.bmm.default"]
