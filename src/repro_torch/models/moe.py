"""Mixture-of-Experts FFN with three routers:

* ``softmax``    — standard top-k token-choice routing;
* ``sinkhorn``   — balanced assignment as *entropic OT* between tokens and
                   experts (a fixed, differentiable number of log-domain
                   Sinkhorn iterations on the token-expert affinity kernel);
* ``spar_sink``  — the paper's technique as an LM feature: the affinity
                   kernel is importance-sparsified with the UOT
                   probabilities of eq. (11) before the Sinkhorn
                   iterations. Sampling is stop-gradient (like dropout);
                   kept entries are rescaled by 1/p* so the sketched kernel
                   stays unbiased (eq. 7).

The counterpart of the reference's ``repro.models.moe``, in plain torch
(the reference's is plain XLA: no hand kernel on this path). Dispatch is
the capacity-bounded gather/scatter formulation: per sequence (the routing
group) each expert keeps its top-C tokens.

Where the reference takes a PRNG key, the port takes ``generator=``, a
`torch.Generator` on the data's device; ``None`` draws from a generator
seeded 0, as the reference draws from ``PRNGKey(0)``. Two choices keep
the reference's results and make them repeatable on the card:

* every top-k is a stable descending sort cut to k (`_top_k`), so among
  equal values the lower index comes first, as ``jax.lax.top_k`` puts it;
  ``torch.topk`` promises no order among ties, and ties are real (the gates
  of unchosen tokens are exactly 0, and spar_sink rows whose keep mask is
  empty get identical probabilities);
* the combine adds each token's kept expert outputs in expert order, the
  order of the reference's scatter-add, through a gather a chosen expert
  (`_combine`): no atomic scatter, so a repeated call gives the same bits.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.layout import local_apply
from repro_torch.models.layers import _normal, dense_init

__all__ = ["init_moe", "moe_ffn", "sinkhorn_router_probs"]

# the logK of a dropped entry: the reference's float32 arithmetic depends on
# it (a row with nothing kept gives the softmax of g; -inf would give NaN)
_DROPPED = -1e30


def init_moe(gen, cfg: ModelConfig, device, dtype=torch.float32):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": dense_init(gen, d, e, device, dtype, scale=0.02),
        "wi": _normal(gen, (e, d, f), d**-0.5, device, dtype),
        "wg": _normal(gen, (e, d, f), d**-0.5, device, dtype),
        "wo": _normal(gen, (e, f, d), f**-0.5, device, dtype),
    }


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis and their indices, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _logsumexp(z: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """The reference's logsumexp (``jax.scipy.special.logsumexp``): the
    max, gradient stopped (0 where it is not finite), shifted out of
    ``log(sum(exp(z - max))) + max``. Its gradient is the softmax of z on
    every row, also on a row of -1e30 entries, where `torch.logsumexp`'s
    backward, exp(z - lse) with lse rounded to -1e30, weights each entry 1."""
    amax = torch.amax(z, dim=dim, keepdim=True).detach()
    amax = torch.where(torch.isfinite(amax), amax, 0.0)
    out = torch.log(torch.sum(torch.exp(z - amax), dim=dim, keepdim=True)) + amax
    return out if keepdim else out.squeeze(dim)


def _fixed_sinkhorn(logK: torch.Tensor, loga: torch.Tensor, logb: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-iteration log-domain Sinkhorn on (B, N, E) kernels from zero
    potentials, f then g each iteration (differentiable); the log plan."""
    f = torch.zeros(logK.shape[:2], dtype=logK.dtype, device=logK.device)
    g = torch.zeros((logK.shape[0], logK.shape[2]), dtype=logK.dtype, device=logK.device)
    for _ in range(iters):
        f = loga - _logsumexp(logK + g[:, None, :], dim=2)  # (B, N)
        g = logb - _logsumexp(logK + f[:, :, None], dim=1)  # (B, E)
    return logK + f[:, :, None] + g[:, None, :]


def _uniforms(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """The spar_sink router's U[0, 1) draws, float32, from ``generator``
    (``None``: a new generator on ``device`` seeded 0). On ``meta`` (the
    dry-run) an empty tensor: shapes only, nothing drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.rand(shape, generator=generator, dtype=torch.float32, device=device)


def _spar_sink_log_kernel(logK: torch.Tensor, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """The sketched log kernel of the spar_sink router on the uniforms
    ``u`` (shape of ``logK``): eq. (11)'s probabilities with uniform
    marginals (the a_i b_j factor is constant, so the mass comes from the
    kernel term), an entry kept where ``u < p*``, ``logK - log p*`` on kept
    entries and -1e30 on dropped ones."""
    n, e = logK.shape[1], logK.shape[2]
    eps = cfg.router_eps
    lam = 1.0
    c_k = eps / (2.0 * lam + eps)
    logp = c_k * logK
    logp = logp - _logsumexp(logp, dim=(1, 2), keepdim=True)
    s_budget = cfg.router_sample_frac * n * e
    p_star = torch.clamp(s_budget * torch.exp(logp), max=1.0).detach()
    keep = u < p_star
    return torch.where(keep, logK - torch.log(torch.clamp(p_star, min=1e-30)), _DROPPED)


def sinkhorn_router_probs(
    scores: torch.Tensor,  # (B, N, E) raw affinities
    cfg: ModelConfig,
    generator: torch.Generator | None,
) -> torch.Tensor:
    """Balanced routing probabilities via (Spar-)Sinkhorn.

    Marginals: each token emits k/N mass, each expert absorbs k/E — the
    balanced-assignment OT problem, solved with ``cfg.router_iters``
    entropic iterations at temperature ``router_eps``. The spar_sink
    router draws its uniforms from ``generator`` (``None``: seeded 0).
    """
    b, n, e = scores.shape
    k = cfg.experts_per_token
    s32 = scores.to(torch.float32)
    logK = (s32 - s32.detach().amax(dim=-1, keepdim=True)) / cfg.router_eps
    if cfg.router == "spar_sink":
        logK = _spar_sink_log_kernel(logK, cfg, _uniforms(logK.shape, generator, logK.device))
    loga = torch.full((b, n), math.log(k / n), dtype=torch.float32, device=scores.device)
    logb = torch.full((b, e), math.log(k / e), dtype=torch.float32, device=scores.device)
    log_plan = _fixed_sinkhorn(logK, loga, logb, cfg.router_iters)
    # rows rescaled to probabilities over experts for the top-k choice
    return torch.softmax(log_plan, dim=-1)


def _router_probs(params, x: torch.Tensor, cfg: ModelConfig, generator) -> torch.Tensor:
    """(B, S, D) -> the router's (B, S, E) float32 probabilities."""
    scores = (x @ params["router"]["w"].to(x.dtype)).to(torch.float32)
    if cfg.router in ("sinkhorn", "spar_sink"):
        return sinkhorn_router_probs(scores, cfg, generator)
    return torch.softmax(scores, dim=-1)


def _route(probs: torch.Tensor, cfg: ModelConfig, cap: int):
    """Token-choice top-k, renormalised, then each expert keeps its top
    ``cap`` tokens by gate: ``(topk_idx (B, S, k), keep_w (B, E, cap),
    keep_idx (B, E, cap))``."""
    topk_w, topk_idx = _top_k(probs, cfg.experts_per_token)
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    # gate (B, S, E): each token's weight on its chosen experts, 0 elsewhere
    gate_e = torch.zeros_like(probs).scatter(2, topk_idx, topk_w)
    keep_w, keep_idx = _top_k(gate_e.transpose(1, 2), cap)
    return topk_idx, keep_w, keep_idx


def _combine(y, topk_idx, keep_idx, s: int):
    """`_combine_local`, on each rank's sequences for DTensors
    (`local_apply`): every expert's output gathered to its tokens' ranks
    (the combine's all-to-all), the batch kept on its shards where it
    divides."""
    return local_apply(functools.partial(_combine_local, s=s), y, topk_idx, keep_idx,
                       axes=(("b", None, None, None), ("b", None, None), ("b", None, None)), out=("b", None, None))


def _combine_local(y: torch.Tensor, topk_idx: torch.Tensor, keep_idx: torch.Tensor, s: int) -> torch.Tensor:
    """The reference's scatter-add of expert outputs ``y`` (B, E, cap, D)
    back to token slots, with no atomics: each token gathers the slot of
    each expert it chose (if that expert kept it) and adds them in expert
    order, from 0, as the scatter adds them. An expert that keeps a token it
    was not chosen by (it had spare capacity) weights it by 0, a term of
    +-0 that adds nothing and is left out."""
    b, e, cap, d = y.shape
    dev = y.device
    slot = torch.full((b, e, s), -1, dtype=torch.long, device=dev)
    slot.scatter_(2, keep_idx, torch.arange(cap, device=dev).expand(b, e, cap))
    experts = torch.sort(topk_idx, dim=-1).values  # (B, S, k), expert order
    slots = torch.gather(slot.transpose(1, 2), 2, experts)  # (B, S, k), -1 = not kept
    flat = y.reshape(b, e * cap, d)
    rows = torch.arange(b, device=dev)[:, None]
    out = torch.zeros((b, s, d), dtype=y.dtype, device=dev)
    for j in range(experts.shape[-1]):
        c = slots[..., j]
        term = flat[rows, experts[..., j] * cap + torch.clamp(c, min=0)]  # (B, S, D)
        out = out + torch.where((c >= 0)[..., None], term, 0)
    return out


def _expert_products(wi, wg, wo, xe):
    h = torch.einsum("becd,edf->becf", xe, wi)
    g = torch.einsum("becd,edf->becf", xe, wg)
    return torch.einsum("becf,efd->becd", h * F.silu(g), wo)


def _experts(xe, wi, wg, wo):
    """The expert SwiGLU on the dispatched tokens xe (B, E, cap, D) ->
    (B, E, cap, D). DTensors run expert-parallel (`local_apply`): the
    experts sharded where ``wi`` shards them (EP, the weights first so
    that their layout leads), the tokens on their batch shards and those
    experts, the weights' FSDP shards gathered; each rank computes its own
    experts for its own sequences."""
    w_axes = ("e", None, None)
    return local_apply(_expert_products, wi, wg, wo, xe, axes=(w_axes, w_axes, w_axes, ("b", "e", None, None)),
                       out=("b", "e", None, None))


def moe_ffn(
    params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), aux load-balance loss, a 0-dim float32
    tensor). ``generator`` feeds the spar_sink router's draws."""
    dtype = x.dtype
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = max(1, int(cfg.capacity_factor * k * s / e))

    probs = _router_probs(params, x, cfg, generator)
    topk_idx, keep_w, keep_idx = _route(probs, cfg, cap)

    xe = x[torch.arange(b, device=x.device)[:, None, None], keep_idx]  # (B, E, cap, D)
    y = _experts(xe, params["wi"].to(dtype), params["wg"].to(dtype), params["wo"].to(dtype))
    y = y * keep_w[..., None].to(dtype)
    out = _combine(y, topk_idx, keep_idx, s)

    # Switch-style load-balance aux: E * sum_e f_e * P_e
    chosen = torch.zeros_like(probs).scatter(2, topk_idx, 1.0)  # (B, S, E): the one-hots summed over k
    f_e = torch.mean(chosen, dim=1)  # (B, E) fraction routed
    p_e = torch.mean(probs, dim=1)  # (B, E) mean prob
    aux = e * torch.mean(torch.sum(f_e * p_e, dim=-1)) / k
    return out, aux.to(torch.float32)
