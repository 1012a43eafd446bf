"""AdamW, global-norm clipping and the cosine schedule, on trees of tensors.

The counterpart of the reference's ``repro.optim.adamw``, with its
arithmetic: clipping by ``grad_clip / max(gnorm, 1e-9)`` (not
``clip_grad_norm_``'s ``norm + 1e-6``), weight decay on every leaf (norm
scales and ``lam`` included), bias corrections in float32. Unlike the
reference, `adamw_update` updates the parameters and moments in place, one
leaf at a time, so the only temporaries are a few of one leaf's size (at
full width the state alone is 42.6 GB; a functional copy does not fit
beside it). Nothing in it reads a value back to the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule", "global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict  # first moment, mirrors params
    v: dict  # second moment, mirrors params


def adamw_init(params) -> AdamWState:
    """Zero moments (float32, like each leaf) and step 0, on the params' device."""
    device = leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's float32 sum of squares; a 0-dim float32 tensor."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def cosine_schedule(step, lr: float, warmup: int, total: int, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup from 0 (so lr = 0 at step 0 when ``warmup > 0``), then
    a cosine from ``lr`` down to ``min_frac * lr`` at ``total``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
):
    """One AdamW step. ``grads`` mirrors ``params`` (a tree, or the list of
    its leaves in `leaves` order), in any float dtype. Updates ``params``,
    ``state.m``, ``state.v`` and ``state.step`` in place and returns them,
    as the reference returns its new ones: ``(params, state, metrics)``
    with ``metrics = {"grad_norm", "lr"}`` 0-dim tensors."""
    g_leaves = leaves(grads)
    gnorm = global_norm(g_leaves)
    if grad_clip > 0:
        scale = torch.clamp(gnorm.new_tensor(grad_clip) / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = torch.ones_like(gnorm)
    state.step.add_(1)
    stepf = state.step.to(torch.float32)
    b1c = 1.0 - b1 ** stepf
    b2c = 1.0 - b2 ** stepf
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    for p, m, v, g in zip(leaves(params), leaves(state.m), leaves(state.v), g_leaves, strict=True):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_(g * (1 - b1))
        sq = g * (1 - b2)
        v.mul_(b2).add_(sq.mul_(g))
        # step = m / b1c / (sqrt(v / b2c) + eps) + wd * p, in two leaf-sized buffers
        den = torch.div(v, b2c, out=sq).sqrt_().add_(eps)
        upd = torch.div(m, b1c, out=g).div_(den)
        upd.add_(torch.mul(p, weight_decay, out=den))
        p.sub_(upd.mul_(lr_t))
    return params, state, {"grad_norm": gnorm, "lr": lr_t}
