"""Spar-Sink sizing helpers and the O(s) sparse objectives (paper Alg. 3/4).

The main-path part of ``repro.core.spar_sink``: ``s0``/``default_cap`` and
the entropic objective evaluated on the sketch's entries from gathered
costs, in the scaling domain (scalings ``u, v``) and the log domain
(potentials ``f, g``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import sparsify
from repro_torch.core.sinkhorn import SinkhornResult, kl_divergence

__all__ = [
    "coo_objective_ot_entries",
    "coo_objective_ot_log_entries",
    "coo_objective_uot_entries",
    "coo_objective_uot_log_entries",
    "default_cap",
    "log_plan_entries",
    "s0",
]


def s0(n: int) -> float:
    """Paper's pilot subsample size ``s0(n) = 1e-3 * n * log^4(n)`` (Sec. 5.1)."""
    return 1e-3 * n * math.log(n) ** 4


def default_cap(s: float) -> int:
    """Static COO capacity: E[nnz] <= s, Poisson tail ~ sqrt(s)."""
    return int(s + 6.0 * math.sqrt(s) + 16)


def _elem_entropy(t: torch.Tensor) -> torch.Tensor:
    pos = t > 0
    logt = torch.log(torch.where(pos, t, 1.0))
    return -torch.where(pos, t * (logt - 1.0), 0.0)


def _transport(t_e: torch.Tensor, c_e: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.where(t_e > 0, t_e * torch.where(torch.isinf(c_e), 0.0, c_e), 0.0))


def _objective_ot_from_te(t_e, c_e, eps: float) -> torch.Tensor:
    return _transport(t_e, c_e) - eps * torch.sum(_elem_entropy(t_e))


def _objective_uot_from_te(t_e, c_e, sk, a, b, lam: float, eps: float) -> torch.Tensor:
    csort, col_offsets = sparsify.col_layout(sk)
    row = sparsify.segment_sum(t_e, sparsify.row_offsets(sk))
    col = sparsify.segment_sum(t_e[csort], col_offsets)
    return (
        _transport(t_e, c_e)
        + lam * kl_divergence(row, a)
        + lam * kl_divergence(col, b)
        - eps * torch.sum(_elem_entropy(t_e))
    )


def log_plan_entries(sk: sparsify.LogSparseKernelCOO, res: SinkhornResult, eps: float) -> torch.Tensor:
    """Plan entries of a log-domain sparse solve,
    ``t_e = exp((f_i + g_j - C_e)/eps - log rate_e)``, the exponents summed
    in log space first; dead atoms and padded slots come out exactly 0."""
    logt = sk.logvals + res.u[sk.rows] / eps + res.v[sk.cols] / eps
    return torch.where(torch.isneginf(logt) | torch.isnan(logt), 0.0, torch.exp(logt))


def coo_objective_ot_entries(sk: sparsify.SparseKernelCOO, c_e, res: SinkhornResult, eps: float) -> torch.Tensor:
    """``<T~,C> - eps H(T~)`` from gathered costs ``c_e = C[rows, cols]``."""
    t_e = res.u[sk.rows] * sk.vals * res.v[sk.cols]
    return _objective_ot_from_te(t_e, c_e, eps)


def coo_objective_ot_log_entries(sk: sparsify.LogSparseKernelCOO, c_e, res: SinkhornResult, eps: float) -> torch.Tensor:
    """OT objective of a log-domain sparse solve (potentials in ``res``)."""
    return _objective_ot_from_te(log_plan_entries(sk, res, eps), c_e, eps)


def coo_objective_uot_entries(sk, c_e, res: SinkhornResult, a, b, lam: float, eps: float) -> torch.Tensor:
    """Eq. (10) objective on the sparse plan from gathered costs."""
    t_e = res.u[sk.rows] * sk.vals * res.v[sk.cols]
    return _objective_uot_from_te(t_e, c_e, sk, a, b, lam, eps)


def coo_objective_uot_log_entries(sk, c_e, res: SinkhornResult, a, b, lam: float, eps: float) -> torch.Tensor:
    """Eq. (10) objective of a log-domain sparse solve (potentials in ``res``)."""
    return _objective_uot_from_te(log_plan_entries(sk, res, eps), c_e, sk, a, b, lam, eps)
