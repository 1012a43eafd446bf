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

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import lm
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule, ef_update
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["TrainState", "init_train_state", "loss_and_grads", "make_serve_step", "make_train_step"]

_METRICS = ("loss", "ce", "z_loss", "moe_aux")


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    ef: dict | None  # error-feedback residuals (grad compression) or None


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed_or_generator: int | torch.Generator = 0,
                     device=None) -> TrainState:
    """Parameters drawn as `lm.init_params` draws them (``device=None`` means
    the card; ``"meta"`` allocates nothing), zero moments, step 0, and zero
    residuals if ``tcfg.grad_compression``."""
    params = lm.init_params(cfg, seed_or_generator, device=device)
    ef = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params) if tcfg.grad_compression else None
    return TrainState(params, adamw_init(params), ef)


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
    grads = [w.grad for w in work]
    return grads, {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``, ``batch =
    {"tokens": (B, S) integer tensor}`` plus the family's stub inputs
    (``"images"``, ``"frames"``), which go to `lm.forward` as ``extras``;
    microbatches split every entry along its batch axis. ``state`` is
    updated in place."""

    def train_step(state: TrainState, batch):
        if tcfg.microbatch and tcfg.microbatch > 0:
            # gradient accumulation over microbatches of tcfg.microbatch rows, in float32
            rows = batch["tokens"].shape[0]
            if rows % tcfg.microbatch:
                raise ValueError(f"batch of {rows} rows is not a multiple of microbatch {tcfg.microbatch}")
            n_micro = rows // tcfg.microbatch
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(state.params)]
            metrics = None
            for i in range(n_micro):
                mb = {k: v[i * tcfg.microbatch:(i + 1) * tcfg.microbatch] for k, v in batch.items()}
                g, m = loss_and_grads(state.params, mb, cfg, tcfg.z_loss)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in _METRICS}
            for acc in grads:
                acc.div_(n_micro)
            metrics = {k: metrics[k] / n_micro for k in _METRICS}
        else:
            grads, metrics = loss_and_grads(state.params, batch, cfg, tcfg.z_loss)

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


def make_serve_step(cfg: ModelConfig):
    """Returns ``serve_step(params, state, tokens, pos, extras=None) ->
    (logits, state)``: one `lm.decode_step`."""

    def serve_step(params, state, tokens, pos, extras=None):
        return lm.decode_step(params, state, tokens, pos, cfg, extras)

    return serve_step
