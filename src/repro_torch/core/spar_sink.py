"""Spar-Sink sizing helpers, the O(s) sparse objectives and the legacy
front ends (paper Alg. 3/4).

The port of ``repro.core.spar_sink``:

* ``s0``, ``default_cap``, ``default_max_blocks``;
* the entropic objective evaluated on the sketch's entries, from gathered
  costs (``*_entries``) or from a dense cost matrix (`coo_objective_ot`,
  `coo_objective_uot`), in the scaling domain (scalings ``u, v``) and the
  log domain (potentials ``f, g``);
* ``spar_sink_ot`` / ``spar_sink_uot``, deprecated wrappers over
  ``solve()`` that return a `SparSinkSolution` with the same results.
"""
from __future__ import annotations

import math
import warnings
from typing import Literal, NamedTuple

import torch

from repro_torch.core import sparsify
from repro_torch.core.sinkhorn import SinkhornResult, kl_divergence

__all__ = [
    "SparSinkSolution",
    "coo_objective_ot",
    "coo_objective_ot_entries",
    "coo_objective_ot_log_entries",
    "coo_objective_uot",
    "coo_objective_uot_entries",
    "coo_objective_uot_log_entries",
    "default_cap",
    "default_max_blocks",
    "log_plan_entries",
    "s0",
    "spar_sink_ot",
    "spar_sink_uot",
]

Method = Literal["dense", "coo", "block_ell"]

# legacy method name -> registry solver name
_METHOD_TO_REGISTRY = {
    "dense": "spar_sink_dense",
    "coo": "spar_sink_coo",
    "block_ell": "spar_sink_block_ell",
}


def s0(n: int) -> float:
    """Paper's pilot subsample size ``s0(n) = 1e-3 * n * log^4(n)`` (Sec. 5.1)."""
    return 1e-3 * n * math.log(n) ** 4


def default_cap(s: float) -> int:
    """Static COO capacity: E[nnz] <= s, Poisson tail ~ sqrt(s)."""
    return int(s + 6.0 * math.sqrt(s) + 16)


def default_max_blocks(n: int, s: float, block: int) -> int:
    """Static ELL width of the block-ELL sketch: about 4x the expected kept
    tiles per row-block (+4 slack), floored at 4, capped at the full block
    row (the cap applies after the floor, so it holds for n // block < 4)."""
    nrb = max(n // block, 1)
    want = int(4 * s / (block * block) / nrb) + 4
    return max(1, min(nrb, max(4, want)))


class SparSinkSolution(NamedTuple):
    value: torch.Tensor  # estimated OT_eps / UOT_{lam,eps}
    result: SinkhornResult  # scalings on the sketch
    nnz: torch.Tensor  # realized sketch size


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


def coo_objective_ot(sk: sparsify.SparseKernelCOO, C: torch.Tensor, res: SinkhornResult, eps: float) -> torch.Tensor:
    """``<T~,C> - eps H(T~)`` reading only the kept entries of the dense cost."""
    return coo_objective_ot_entries(sk, C[sk.rows, sk.cols], res, eps)


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


def coo_objective_uot(sk: sparsify.SparseKernelCOO, C: torch.Tensor, res: SinkhornResult, a, b, lam: float,
                      eps: float) -> torch.Tensor:
    """Eq. (10) objective reading only the kept entries of the dense cost."""
    return coo_objective_uot_entries(sk, C[sk.rows, sk.cols], res, a, b, lam, eps)


# --------------------------------------------------------------------------
# Deprecated front ends (Algorithms 3 and 4): thin wrappers over solve()
# --------------------------------------------------------------------------


def _legacy_solve(problem, method: str, generator, seed, s, *, cap, block, max_blocks,
                  shrinkage, probs, tol, max_iter) -> SparSinkSolution:
    from repro_torch.core.api import solve  # local import: the API imports this module

    if method not in _METHOD_TO_REGISTRY:
        raise ValueError(f"unknown method {method!r}")
    opts: dict = dict(generator=generator, seed=seed, s=s, shrinkage=shrinkage, probs=probs,
                      tol=tol, max_iter=max_iter)
    if method == "coo":
        opts["cap"] = cap
    elif method == "block_ell":
        opts.update(block=block, max_blocks=max_blocks)
    sol = solve(problem, method=_METHOD_TO_REGISTRY[method], **opts)
    return SparSinkSolution(sol.value, sol.result, sol.nnz)


def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old}() is deprecated; use {new}", DeprecationWarning, stacklevel=3)


def spar_sink_ot(
    C,
    a,
    b,
    eps: float,
    s: float,
    *,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    method: Method = "coo",
    tol: float = 1e-6,
    max_iter: int = 1000,
    cap: int | None = None,
    block: int = 128,
    max_blocks: int | None = None,
    shrinkage: float = 0.0,
    probs: torch.Tensor | None = None,
    device=None,
) -> SparSinkSolution:
    """Algorithm 3. ``probs`` overrides eq. (9) (uniform gives Rand-Sink).
    The random source is ``generator`` or ``seed``; ``device`` places numpy
    data (see `repro_torch._device`).

    .. deprecated:: use ``solve(OTProblem(Geometry(C), a, b, eps),
       method="spar_sink_coo", seed=..., s=s)``, which gives the same result.
    """
    from repro_torch.core.api import Geometry, OTProblem

    _warn_deprecated("spar_sink_ot", "solve(OTProblem(...), method='spar_sink_coo')")
    problem = OTProblem(Geometry(C, device=device), a, b, eps)
    return _legacy_solve(problem, method, generator, seed, s, cap=cap, block=block,
                         max_blocks=max_blocks, shrinkage=shrinkage, probs=probs, tol=tol, max_iter=max_iter)


def spar_sink_uot(
    C,
    a,
    b,
    lam: float,
    eps: float,
    s: float,
    *,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    method: Method = "coo",
    tol: float = 1e-6,
    max_iter: int = 1000,
    cap: int | None = None,
    block: int = 128,
    max_blocks: int | None = None,
    shrinkage: float = 0.0,
    probs: torch.Tensor | None = None,
    device=None,
) -> SparSinkSolution:
    """Algorithm 4. ``probs`` overrides eq. (11); random source and
    ``device`` as in `spar_sink_ot`.

    .. deprecated:: use ``solve(UOTProblem(Geometry(C), a, b, eps, lam=lam),
       method="spar_sink_coo", seed=..., s=s)``, which gives the same result.
    """
    from repro_torch.core.api import Geometry, UOTProblem

    _warn_deprecated("spar_sink_uot", "solve(UOTProblem(...), method='spar_sink_coo')")
    problem = UOTProblem(Geometry(C, device=device), a, b, eps, lam=lam)
    return _legacy_solve(problem, method, generator, seed, s, cap=cap, block=block,
                         max_blocks=max_blocks, shrinkage=shrinkage, probs=probs, tol=tol, max_iter=max_iter)
