"""A posteriori solution-quality certificates, O(nnz + n) per solve.

The port of ``repro.obs.certify``. `repro_torch.obs.trace` reports a
solver's effort; a `Certificate` says how wrong its objective can be,
from the converged potentials, without touching an (n, m) array on a
sketch:

1. **Duality gap**: the raw-cost primal objective of the returned plan
   minus a dual objective at the returned potentials, anchored to the
   dense problem. On a sketch the Horvitz-Thompson kernel entries
   ``k_e = exp((f_i + g_j)/eps) K_e / p_e`` make the sketched kernel sum an
   unbiased estimate of the dense dual's kernel term, so ``value - dual``
   bounds the excess over the dense optimum by weak duality (the UOT dual
   of Pham et al., arXiv 2002.03293, is the balanced one at ``lam = inf``).
2. **Coverage deficit**: ``sum_e t_e (|c_e| + eps)(1 - p_e)``, the
   design-expected objective mass on entries the sketch did not sample.
3. **Marginal violation**: the L1 row/column feasibility error; for
   balanced OT rounding onto the polytope costs at most ``cost_scale *
   (L1_row + L1_col)``; for UOT the term is zero (the KL prices the slack).
4. **Delta-method confidence interval**: the variance of the
   importance-sampled objective, ``sum_e s_e^2 (1 - p_e)`` with ``s_e``
   the entry's objective sensitivity.

``error_bound = gap + coverage_deficit + marginal_term +
dual_noise_halfwidth``. The gap is exact by weak duality in expectation;
the noise and CI terms are asymptotic (finite second moment of the
importance weights, enough effective samples: check ``ess``).

Everything here is tensor math. The marginals of a sketch are sums over
sorted segments (rows ascending, columns through a stable column sort),
never ``index_add_``: on CUDA that sums with atomics in an order that
changes from run to run.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "Certificate",
    "DEFAULT_Z",
    "dense_certificate",
    "importance_ess",
    "sparse_certificate",
]

#: normal critical value of the delta-method CI (z = 2.576 <-> 99% two-sided)
DEFAULT_Z = 2.576


class Certificate(NamedTuple):
    """Solution-quality certificate; every field a 0-d tensor.

    ``gap``/``dual``/``primal`` certify convergence on the problem the
    solver saw (the sketched kernel for sparse methods); ``ci_*``/``ess``
    quantify the sampling error of the sketched estimate (NaN on dense,
    sketch-free solves); ``error_bound`` is the combined additive bound.
    """

    value: torch.Tensor  # objective estimate being certified
    primal: torch.Tensor  # primal objective of the returned plan
    dual: torch.Tensor  # weak-duality lower bound at the returned potentials
    gap: torch.Tensor  # max(primal - dual, 0)
    rel_gap: torch.Tensor  # gap / max(|value|, 1)
    marg_err_row: torch.Tensor  # ||T 1 - a||_1
    marg_err_col: torch.Tensor  # ||T^T 1 - b||_1
    cost_scale: torch.Tensor  # max |cost| on the certified support
    coverage_deficit: torch.Tensor  # est. objective mass on unsampled entries
    error_bound: torch.Tensor  # gap + coverage + marginal term + noise term
    ci_low: torch.Tensor  # delta-method CI (NaN when nothing was sampled)
    ci_high: torch.Tensor
    ess: torch.Tensor  # importance-weight effective sample size (NaN if n/a)

    @property
    def ci_width(self) -> torch.Tensor:
        return self.ci_high - self.ci_low

    def summary(self) -> dict:
        """Small host-side dict (JSON-friendly) for logging and export."""
        return {
            "value": float(self.value),
            "gap": float(self.gap),
            "rel_gap": float(self.rel_gap),
            "marg_err_row": float(self.marg_err_row),
            "marg_err_col": float(self.marg_err_col),
            "coverage_deficit": float(self.coverage_deficit),
            "error_bound": float(self.error_bound),
            "ci_low": float(self.ci_low),
            "ci_high": float(self.ci_high),
            "ci_width": float(self.ci_width),
            "ess": float(self.ess),
        }


# --------------------------------------------------------------------------
# Shared pieces
# --------------------------------------------------------------------------


def _log_ratio(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``log(x/y)``, 0 where either side is non-positive."""
    ok = (x > 0) & (y > 0)
    return torch.where(ok, torch.log(torch.where(ok, x, 1.0) / torch.where(ok, y, 1.0)), 0.0)


def _finite(pot: torch.Tensor) -> torch.Tensor:
    """Potentials with dead atoms (``±inf``/NaN) at 0: still a valid dual
    point by weak duality, only not the tightest one."""
    return torch.where(torch.isfinite(pot), pot, 0.0)


def _dual_marginal_term(pot: torch.Tensor, w: torch.Tensor, lam: float) -> torch.Tensor:
    """One marginal's dual term: ``<w, f>`` balanced (``lam = inf``),
    ``-lam <w, exp(-f/lam) - 1>`` unbalanced."""
    p = _finite(pot)
    if math.isinf(lam):
        return torch.sum(w * p)
    return -lam * torch.sum(w * torch.expm1(-p / lam))


def _max_or_zero(x: torch.Tensor) -> torch.Tensor:
    """``max(x)``, and 0 for an empty ``x`` (the reference's ``initial=0``;
    the entries here are >= 0)."""
    return torch.amax(x) if x.numel() else torch.zeros((), dtype=x.dtype, device=x.device)


def importance_ess(weights: torch.Tensor, log_space: bool = False) -> torch.Tensor:
    """``(sum w)^2 / sum w^2`` over a weight vector (zeros/``-inf`` padding
    is inert); ``log_space=True`` reads log-weights and takes the ratio by
    logsumexp, so small-eps weights do not flush to zero."""
    if log_space:
        lse1 = torch.logsumexp(weights, dim=0)
        lse2 = torch.logsumexp(2.0 * weights, dim=0)
        return torch.where(torch.isneginf(lse1), 0.0, torch.exp(2.0 * lse1 - lse2))
    tot = torch.sum(weights)
    sq = torch.sum(weights * weights)
    return torch.where(sq > 0, tot * tot / torch.where(sq > 0, sq, 1.0), 0.0)


# --------------------------------------------------------------------------
# Certificates
# --------------------------------------------------------------------------


def sparse_certificate(
    *,
    t_e: torch.Tensor,
    c_e: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    n: int,
    m: int,
    a: torch.Tensor,
    b: torch.Tensor,
    f: torch.Tensor,
    g: torch.Tensor,
    eps: float,
    lam: float,
    value: torch.Tensor,
    k_e: torch.Tensor | None = None,
    p_e: torch.Tensor | None = None,
    ess: torch.Tensor | None = None,
    z: float = DEFAULT_Z,
    col_layout: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Certificate:
    """Certificate of a sparse (sketched) solve in O(nnz + n).

    ``t_e`` are the (cap,) plan entries (0 on padding), ``c_e`` the raw
    gathered costs (``±inf`` masked), ``rows``/``cols`` the COO indices
    with **rows ascending** (every sketch of the port keeps them so), ``f``
    and ``g`` the potentials (``-inf`` on dead atoms, masked to 0 here),
    ``lam = inf`` the balanced dual with the rounding term. ``k_e`` are the
    dual's kernel entries at the masked potentials (default ``t_e``, exact
    when no atom died); ``p_e`` the inclusion probabilities, which enable
    the CI and the coverage and noise terms (NaN CI without them); ``ess``
    is surfaced as given (NaN without it). ``col_layout`` is the sketch's
    ``(csort, column offsets)`` (`repro_torch.core.sparsify.col_layout`);
    without it the columns are sorted here.
    """
    from repro_torch.core.sparsify import segment_sum, sorted_offsets

    dt, dev = t_e.dtype, t_e.device
    balanced = math.isinf(lam)
    mask = t_e > 0
    c_fin = torch.where(torch.isfinite(c_e), c_e, 0.0)
    logt = torch.log(torch.where(mask, t_e, 1.0))
    if col_layout is None:
        csort = torch.argsort(cols, stable=True)
        col_layout = csort, sorted_offsets(cols[csort], m)
    csort, col_offsets = col_layout
    row = segment_sum(t_e, sorted_offsets(rows, n))
    col = segment_sum(t_e[csort], col_offsets)
    marg_row = torch.sum(torch.abs(row - a))
    marg_col = torch.sum(torch.abs(col - b))

    # `value` is the raw-cost objective of the returned plan, i.e. the dense
    # problem's primal at T~ (entries off the sketch carry 0 mass), so
    # `value - dual` upper-bounds the excess over the dense optimum
    primal = value
    ke = t_e if k_e is None else k_e
    dual = _dual_marginal_term(f, a, lam) + _dual_marginal_term(g, b, lam) - eps * torch.sum(ke)
    gap = torch.clamp_min(primal - dual, 0.0)
    cost_scale = _max_or_zero(torch.where(mask, torch.abs(c_fin), 0.0))

    if p_e is None:
        half_dual = coverage = torch.zeros((), dtype=dt, device=dev)
        ci_low = ci_high = torch.full((), math.nan, dtype=dt, device=dev)
    else:
        p = torch.clamp(p_e, torch.finfo(dt).tiny, 1.0)
        # each kept entry stands in for (1 - p_e) unsampled siblings of the
        # same plan weight and cost (+ eps entropy scale)
        coverage = torch.sum(torch.where(mask, t_e * (torch.abs(c_fin) + eps) * (1.0 - p), 0.0))
        # objective sensitivity: cost + entropy, plus lam log(marg/target) on UOT
        sens = torch.where(mask, t_e * c_fin + eps * t_e * (logt - 1.0), 0.0)
        if not balanced:
            uot_sens = lam * t_e * (_log_ratio(row, a)[rows] + _log_ratio(col, b)[cols])
            sens = sens + torch.where(mask, uot_sens, 0.0)
        var = torch.sum(sens * sens * (1.0 - p))
        half = z * torch.sqrt(var)
        ci_low = value - half
        ci_high = value + half
        # the dual's kernel term is a Horvitz-Thompson sum of eps * k_e: its
        # sampling noise gets its own z * sd allowance in the bound
        half_dual = z * torch.sqrt(torch.sum((eps * ke) ** 2 * (1.0 - p)))

    # balanced: rounding an infeasible plan onto the polytope moves the
    # objective by at most cost_scale * L1 violation; UOT slack is feasible
    if balanced:
        marg_term = cost_scale * (marg_row + marg_col)
    else:
        marg_term = torch.zeros((), dtype=dt, device=dev)
    return Certificate(
        value=value,
        primal=primal,
        dual=dual,
        gap=gap,
        rel_gap=gap / torch.clamp_min(torch.abs(value), 1.0),
        marg_err_row=marg_row,
        marg_err_col=marg_col,
        cost_scale=cost_scale,
        coverage_deficit=coverage,
        error_bound=gap + coverage + marg_term + half_dual,
        ci_low=ci_low,
        ci_high=ci_high,
        ess=torch.full((), math.nan, dtype=dt, device=dev) if ess is None else torch.as_tensor(ess, dtype=dt,
                                                                                            device=dev),
    )


def dense_certificate(
    *,
    plan: torch.Tensor,
    cost: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    f: torch.Tensor,
    g: torch.Tensor,
    eps: float,
    lam: float,
    value: torch.Tensor,
) -> Certificate:
    """Certificate of a dense solve (no sketch, hence no sampling CI).

    ``primal`` is the raw-cost objective of the plan (= ``value``); the dual
    is taken at the masked potentials against the dense kernel, O(n m),
    which the dense solvers pay every iteration anyway.
    """
    dt, dev = plan.dtype, plan.device
    fh, gh = _finite(f), _finite(g)
    # exp((f~ + g~ - c)/eps) over finite-cost entries: the dual's kernel term
    # at the masked potentials (the plan's mass when nothing died)
    ex = (fh[:, None] + gh[None, :] - torch.where(torch.isinf(cost), math.inf, cost)) / eps
    kernel_mass = torch.sum(torch.where(torch.isneginf(ex), 0.0, torch.exp(ex)))
    dual = _dual_marginal_term(f, a, lam) + _dual_marginal_term(g, b, lam) - eps * kernel_mass
    marg_row = torch.sum(torch.abs(torch.sum(plan, dim=1) - a))
    marg_col = torch.sum(torch.abs(torch.sum(plan, dim=0) - b))
    gap = torch.clamp_min(value - dual, 0.0)
    cost_scale = _max_or_zero(torch.where(torch.isfinite(cost), torch.abs(cost), 0.0))
    if math.isinf(lam):
        marg_term = cost_scale * (marg_row + marg_col)
    else:
        marg_term = torch.zeros((), dtype=dt, device=dev)
    nan = torch.full((), math.nan, dtype=dt, device=dev)
    return Certificate(
        value=value,
        primal=value,
        dual=dual,
        gap=gap,
        rel_gap=gap / torch.clamp_min(torch.abs(value), 1.0),
        marg_err_row=marg_row,
        marg_err_col=marg_col,
        cost_scale=cost_scale,
        coverage_deficit=torch.zeros((), dtype=dt, device=dev),
        error_bound=gap + marg_term,
        ci_low=nan,
        ci_high=nan,
        ess=nan,
    )
