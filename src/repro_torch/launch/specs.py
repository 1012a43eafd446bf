"""Abstract inputs for the dry-run: every model input as a DTensor on the
``meta`` device (shapes, dtypes and placements; nothing allocated), and the
placements beside them.

The counterpart of the reference's ``repro.launch.specs``. Where the
reference builds ``ShapeDtypeStruct``s with ``jax.eval_shape`` and returns
``NamedSharding``s for ``jit``'s ``in_shardings``, the port draws the
parameters with ``init_params(cfg, device="meta")``, lays each leaf out by
the sharding rules (`distribute_tensor`, no communication), and returns
``(args, placements)``: the step runs eagerly on those DTensors under
`use_mesh`. Buffer donation has no counterpart. The train step takes no
PRNG key (its draws come from generators), so its arguments are
``(state, batch)``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig, shape_of
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.train.step import init_train_state, make_serve_step, make_train_step
from repro_torch.tree import tree_map

__all__ = ["abstract_prefill_args", "abstract_serve_args", "abstract_train_args", "step_for"]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras_abstract(cfg: ModelConfig, batch: int):
    ex = {}
    if cfg.family == "vlm":
        ex["images"] = _meta((batch, cfg.num_image_tokens, cfg.d_model), torch.bfloat16)
    if cfg.family == "audio":
        ex["frames"] = _meta((batch, cfg.num_frames, cfg.d_model), torch.bfloat16)
    return ex


def _placements(tree):
    return tree_map(lambda t: tuple(t.placements), tree)


def abstract_train_args(cfg: ModelConfig, shape_name: str, mesh, tcfg: TrainConfig | None = None):
    """``((state, batch), placements)`` for ``train_step(state, batch)``:
    the state (parameters, both moments, residuals) placed by `param_specs`,
    the batch by `batch_specs`; the step counter is a plain tensor."""
    seq, gb, kind = shape_of(shape_name)
    assert kind == "train"
    tcfg = tcfg or TrainConfig(seq_len=seq, global_batch=gb)
    state = init_train_state(cfg, tcfg, device="meta", mesh=mesh)
    batch = {"tokens": _meta((gb, seq), torch.int64), **_extras_abstract(cfg, gb)}
    batch = shd.distribute(batch, mesh, shd.batch_specs(cfg, mesh, batch))
    state_pl = type(state)(_placements(state.params), type(state.opt)(None, _placements(state.opt.m),
                                                                        _placements(state.opt.v)),
                           None if state.ef is None else _placements(state.ef))
    return (state, batch), (state_pl, _placements(batch))


def abstract_prefill_args(cfg: ModelConfig, shape_name: str, mesh):
    """``((params, tokens, extras), placements)`` for the prefill step."""
    seq, gb, kind = shape_of(shape_name)
    params = lm.init_params(cfg, device="meta")
    params = shd.distribute(params, mesh, shd.param_specs(params, cfg, mesh))
    inputs = {"tokens": _meta((gb, seq), torch.int64), **_extras_abstract(cfg, gb)}
    inputs = shd.distribute(inputs, mesh, shd.batch_specs(cfg, mesh, inputs))
    tokens = inputs.pop("tokens")
    args = (params, tokens, inputs)
    return args, (_placements(params), tuple(tokens.placements), _placements(inputs))


def abstract_serve_args(cfg: ModelConfig, shape_name: str, mesh):
    """``((params, state, tokens, pos, extras), placements)`` for one decode
    step at the shape's cache length: the cache placed by
    `decode_state_specs`; with ``cfg.decode_cross_cache`` the vlm and audio
    cross K/V live in the state and ``extras`` is empty."""
    seq, gb, kind = shape_of(shape_name)
    assert kind == "decode"
    params = lm.init_params(cfg, device="meta")
    params = shd.distribute(params, mesh, shd.param_specs(params, cfg, mesh))
    state = lm.init_decode_state(cfg, gb, seq, device="meta")
    state = shd.distribute(state, mesh, shd.decode_state_specs(cfg, mesh, state, gb))
    extras = _extras_abstract(cfg, gb)
    if cfg.family == "audio":
        extras = {"enc_out": _meta((gb, cfg.num_frames, cfg.d_model), torch.bfloat16)}
    if cfg.decode_cross_cache and cfg.family in ("vlm", "audio"):
        extras = {}  # cross K/V live in the (precomputed) decode state
    inputs = {"tokens": _meta((gb, 1), torch.int64), **extras}
    inputs = shd.distribute(inputs, mesh, shd.batch_specs(cfg, mesh, inputs))
    tokens = inputs.pop("tokens")
    args = (params, state, tokens, 0, inputs)
    return args, (_placements(params), _placements(state), tuple(tokens.placements), None, _placements(inputs))


def step_for(cfg: ModelConfig, shape_name: str, tcfg: TrainConfig | None = None):
    """``(step, name)``: the function the dry-run runs for this shape kind.
    Run it under ``use_mesh(mesh)`` on the abstract arguments."""
    seq, gb, kind = shape_of(shape_name)
    if kind == "train":
        tcfg = tcfg or TrainConfig(seq_len=seq, global_batch=gb)
        return make_train_step(cfg, tcfg), "train_step"
    if kind == "prefill":

        def prefill_step(params, tokens, extras):
            # serving semantics: next-token logits for the last position only
            logits, _ = lm.forward(params, tokens, cfg, extras or None, last_only=True)
            return logits[:, -1, :]

        return prefill_step, "prefill_step"
    serve = make_serve_step(cfg)

    def serve_step(params, state, tokens, pos, extras):
        return serve(params, state, tokens, pos, extras or None)

    return serve_step, "serve_step"
