"""Inexact proximal point method for unregularized OT, accelerated with
Spar-Sink (the paper's Sec. 7 future work; an extension beyond the paper).

The port of ``repro.core.proximal``. The proximal iteration solves a
sequence of entropic problems whose kernel is reweighted by the previous
plan,

    T^{(t+1)} = argmin_{T in U(a,b)} <T, C> + eps * KL(T || T^{(t)}),

the Sinkhorn fixed point of ``G^{(t)} = K o T^{(t)}`` with ``K =
exp(-C/eps)``; ``T^{(t)}`` tends to an unregularized OT plan even at
moderate ``eps`` (Xie et al., 2020).

``prox_sinkhorn``   the dense reference (inner Algorithm 1 on ``K o T``).
``prox_spar_sink``  one eq. (9) sketch support, drawn once and reused by
                    every outer step: only the kept values are reweighted by
                    the running sparse plan, so every inner iteration is O(s).
                    The segment offsets and the column layout of that one
                    support are computed once, outside the outer loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import make_generator
from repro_torch.core import sparsify
from repro_torch.core.sinkhorn import generic_scaling_loop

__all__ = ["ProxResult", "prox_sinkhorn", "prox_spar_sink"]


class ProxResult(NamedTuple):
    cost: torch.Tensor  # <T, C> (unregularized objective of the final plan)
    marginal_err: torch.Tensor  # L1 violation of both marginals
    n_outer: torch.Tensor


def _gibbs(C: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.isinf(C), 0.0, torch.exp(-C / eps))


def prox_sinkhorn(
    C: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    eps: float,
    *,
    n_outer: int = 20,
    inner_tol: float = 1e-8,
    inner_iters: int = 500,
) -> tuple[ProxResult, torch.Tensor]:
    """Dense proximal-point OT. Returns ``(result, plan)``."""
    K = _gibbs(C, eps)
    T = a[:, None] * b[None, :]  # feasible start: the independent coupling
    for _ in range(n_outer):
        G = K * T
        res = generic_scaling_loop(lambda v: G @ v, lambda u: G.T @ u, a, b, tol=inner_tol, max_iter=inner_iters)
        T = res.u[:, None] * G * res.v[None, :]
    cost = torch.sum(torch.where(T > 0, T * torch.where(torch.isinf(C), 0.0, C), 0.0))
    merr = torch.abs(T.sum(1) - a).sum() + torch.abs(T.sum(0) - b).sum()
    return ProxResult(cost, merr, torch.tensor(n_outer, device=C.device)), T


def prox_spar_sink(
    C: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    eps: float,
    s: float,
    *,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    n_outer: int = 20,
    inner_tol: float = 1e-8,
    inner_iters: int = 500,
    cap: int | None = None,
) -> ProxResult:
    """Sparse proximal-point OT: O(s) inner iterations and plan updates.

    The eq. (7)/(9) sketch support is drawn once, from ``generator`` (or a
    new one seeded with ``seed``, on ``C``'s device); the support of ``K o
    T^(t)`` lies in that of ``K``, so the outer steps reweight the kept
    values and never sample again.
    """
    from repro_torch.core.spar_sink import default_cap

    gen = make_generator(C.device, generator, seed)
    cap = default_cap(s) if cap is None else cap
    sk = sparsify.sparsify_coo(gen, _gibbs(C, eps), sparsify.ot_sampling_probs(a, b), s, cap)
    return _prox_spar_sink_on(sk, C, a, b, n_outer=n_outer, inner_tol=inner_tol, inner_iters=inner_iters)


def _prox_spar_sink_on(sk: sparsify.SparseKernelCOO, C: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                       n_outer: int, inner_tol: float, inner_iters: int) -> ProxResult:
    """Everything of `prox_spar_sink` after the sketch."""
    c_raw = C[sk.rows, sk.cols]
    c_e = torch.where(torch.isinf(c_raw), 0.0, c_raw)
    row_off, col_layout = sparsify.row_offsets(sk), sparsify.col_layout(sk)
    # sparse feasible start on the kept support, t_e = a_i b_j (the first
    # inner kernel is then the sketch of K o T0)
    t_e = a[sk.rows] * b[sk.cols]
    for _ in range(n_outer):
        g = sk._replace(vals=sk.vals * t_e)
        res = generic_scaling_loop(
            lambda v: sparsify.coo_matvec(g, v, row_off), lambda u: sparsify.coo_rmatvec(g, u, col_layout),
            a, b, tol=inner_tol, max_iter=inner_iters,
        )
        t_e = res.u[sk.rows] * g.vals * res.v[sk.cols]
    cost = torch.sum(t_e * c_e)
    csort, col_offsets = col_layout
    row = sparsify.segment_sum(t_e, row_off)
    col = sparsify.segment_sum(t_e[csort], col_offsets)
    merr = torch.abs(row - a).sum() + torch.abs(col - b).sum()
    return ProxResult(cost, merr, torch.tensor(n_outer, device=C.device))
