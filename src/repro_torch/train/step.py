"""The train step: loss, gradients, optional accumulation and compression, AdamW.

The counterpart of the reference's ``repro.train.step`` (``TrainState``,
``init_train_state``, ``make_train_step``, ``make_serve_step``). The step is eager PyTorch: the
gradients come from ``loss.backward()``, and the parameters and moments are
updated in place under ``torch.no_grad()``, so a step returns the state it
was given. Its metrics are 0-dim tensors on the device; nothing reads them
back to the host.

As in the reference, with ``cfg.cast_params_once`` (the default) every
float32 leaf, norm scales and ``lam`` included, is cast to ``cfg.dtype``
once before the loss, and the gradients are taken at those casts. The
gradient at a cast is the reference's float32 gradient rounded to
``cfg.dtype`` and back, exactly, so the step keeps it in ``cfg.dtype``
(7.1 GB instead of 14.2 at full width) and widens one leaf at a time.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule, ef_update
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["TrainState", "init_train_state", "loss_and_grads", "make_serve_step", "make_train_step", "place_batch"]

_METRICS = ("loss", "ce", "z_loss", "moe_aux")


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    ef: dict | None  # error-feedback residuals (grad compression) or None


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed_or_generator: int | torch.Generator = 0,
                     device=None, mesh=None) -> TrainState:
    """Parameters drawn as `lm.init_params` draws them (``device=None`` means
    the card; ``"meta"`` allocates nothing), zero moments, step 0, and zero
    residuals if ``tcfg.grad_compression``.

    With a ``mesh`` the parameters, both moments and the residuals are
    DTensors placed by `param_specs` (the reference's state shardings):
    each rank draws the tree from the same seed, one top-level entry or
    layer at a time, keeps its shard of it and frees the rest before the
    next draw, so the device holds the shards and at most one whole entry
    (an embedding table or a layer). The step counter stays a plain
    tensor, the same on every rank."""
    place = None
    if mesh is not None:
        specs = shd.param_specs(lm.init_params(cfg, device="meta"), cfg, mesh)

        def place(path, tree):
            sub = specs
            for key in path:
                sub = sub[key]
            return shd.distribute(tree, mesh, sub)

    params = lm.init_params(cfg, seed_or_generator, device=device, place=place)
    ef = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params) if tcfg.grad_compression else None
    return TrainState(params, adamw_init(params), ef)


def place_batch(batch, cfg: ModelConfig, mesh):
    """A batch of tensors laid out by `batch_specs` on ``mesh`` (each rank
    holds the whole batch and keeps its rows); DTensors and ``mesh=None``
    pass as they are."""
    if mesh is None:
        return batch
    plain = {k: v for k, v in batch.items() if not isinstance(v, DTensor)}
    placed = shd.distribute(plain, mesh, shd.batch_specs(cfg, mesh, plain))
    return {k: placed.get(k, v) for k, v in batch.items()}


def loss_and_grads(params, batch, cfg: ModelConfig, z_loss: float = 1e-4):
    """``(grads, metrics)``: the gradient of `lm.loss_fn` at each leaf of
    ``params`` (a list in `leaves` order; taken at the leaf's cast to
    ``cfg.dtype`` under ``cfg.cast_params_once``, so in that dtype), and the
    loss and its parts as 0-dim tensors. Reads nothing back to the host."""
    compute = torch_dtype(cfg.dtype)
    work = [
        (p.detach().to(compute) if cfg.cast_params_once and p.dtype == torch.float32 else p.detach())
        .requires_grad_(True)
        for p in leaves(params)
    ]
    with torch.enable_grad():
        loss, metrics = lm.loss_fn(unflatten(params, work), batch, cfg, z_loss=z_loss)
        loss.backward()
    grads = [_placed_as(w.grad, p) for w, p in zip(work, leaves(params))]
    return grads, {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}


def _on(mesh):
    """`use_mesh` for a step built with a mesh; without one the step runs in
    the caller's context (the dry-run calls it under its own `use_mesh`)."""
    return shd.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def _placed_as(grad, param):
    """A DTensor gradient redistributed to its parameter's placements (the
    data-parallel reduction of its partial sums, and a reshard where the
    backward left another layout); a plain gradient as it is."""
    if isinstance(grad, DTensor) and grad.placements != param.placements:
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``, ``batch =
    {"tokens": (B, S) integer tensor}`` plus the family's stub inputs
    (``"images"``, ``"frames"``), which go to `lm.forward` as ``extras``;
    microbatches split every entry along its batch axis. ``state`` is
    updated in place.

    With a ``mesh`` (a state from ``init_train_state(..., mesh=mesh)``) the
    step runs under `use_mesh`: each (micro)batch is placed by
    `batch_specs`, the gradients are reduced to their parameters'
    placements, and the norm, the compression and AdamW run on DTensors
    (the norm's sum over shards is a full reduction)."""

    def train_step(state: TrainState, batch):
        with _on(mesh):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch):
        if tcfg.microbatch and tcfg.microbatch > 0:
            # gradient accumulation over microbatches of tcfg.microbatch rows, in float32
            rows = batch["tokens"].shape[0]
            if rows % tcfg.microbatch:
                raise ValueError(f"batch of {rows} rows is not a multiple of microbatch {tcfg.microbatch}")
            n_micro = rows // tcfg.microbatch
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(state.params)]
            metrics = None
            for i in range(n_micro):
                mb = place_batch({k: v[i * tcfg.microbatch:(i + 1) * tcfg.microbatch] for k, v in batch.items()},
                                 cfg, mesh)
                g, m = loss_and_grads(state.params, mb, cfg, tcfg.z_loss)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in _METRICS}
            for acc in grads:
                acc.div_(n_micro)
            metrics = {k: metrics[k] / n_micro for k in _METRICS}
        else:
            grads, metrics = loss_and_grads(state.params, place_batch(batch, cfg, mesh), cfg, tcfg.z_loss)

        if state.ef is not None:
            with torch.no_grad():
                for i, res in enumerate(leaves(state.ef)):
                    grads[i], new_res = ef_update(grads[i].to(torch.float32), res)
                    res.copy_(new_res)

        lr = cosine_schedule(state.opt.step, tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
        _, _, om = adamw_update(
            grads,
            state.opt,
            state.params,
            lr=lr,
            b1=tcfg.b1,
            b2=tcfg.b2,
            weight_decay=tcfg.weight_decay,
            grad_clip=tcfg.grad_clip,
        )
        metrics.update(om)
        return state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig, mesh=None):
    """Returns ``serve_step(params, state, tokens, pos, extras=None) ->
    (logits, state)``: one `lm.decode_step`, under `use_mesh` with a
    ``mesh``."""

    def serve_step(params, state, tokens, pos, extras=None):
        with _on(mesh):
            return lm.decode_step(params, state, tokens, pos, cfg, extras)

    return serve_step
