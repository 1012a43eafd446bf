"""The built-in solver registry entries behind ``solve(problem, method=...)``.

Eleven methods, one `Solution` contract (the reference's eleven):

======================= ========================================================
``dense``               Algorithm 1/2 on the dense Gibbs kernel (scaling domain)
``log``                 log-domain Algorithm 1/2 (small-``eps`` safe)
``spar_sink_coo``       paper Algorithms 3/4: the eq. (7) importance sketch of
                        the dense kernel as a padded COO, O(s) per iteration
                        (scaling domain: needs ``eps`` large enough that
                        ``exp(-C/eps) > 0``)
``spar_sink_log``       the same sketch carried as ``logvals = -C_e/eps -
                        log p*_e`` and iterated by segment-logsumexp on
                        potentials (safe for ``eps`` down to 1e-3)
``spar_sink_mf``        matrix-free Algorithms 3/4 on a `PointCloudGeometry`:
                        factorized O(s log n) Poisson sketch + gathered-kernel
                        evaluation (the CUDA kernel on the card), no (n, m)
                        array anywhere; ``stabilize=True`` runs it in the log
                        domain; ``shared_variates=True`` (small-n test mode)
                        draws ``spar_sink_coo``'s (or ``spar_sink_log``'s)
                        sketch instead
``spar_sink_block_ell`` the importance sketch drawn at (Bk x Bk) tile
                        granularity, stored in block-ELL layout with its
                        transpose; both mat-vecs of an iteration are the CUDA
                        block-ELL kernel on the card (scaling domain); builds
                        the dense kernel
``spar_sink_dense``     the exact eq. (7) sketch as a dense masked array
                        (the reference of ``spar_sink_coo``)
``rand_sink``           ``spar_sink_coo`` with uniform probabilities (baseline)
``greenkhorn``          greedy single-row/col updates (Altschuler et al. 2017)
``nys_sink``            Nystrom low-rank kernel + Sinkhorn (Altschuler 2019)
``screenkhorn_lite``    static active-set screening (simplified Alaya 2019)
======================= ========================================================

Every solver takes `OTProblem` and `UOTProblem` (``fe = lam/(lam+eps)``
comes from the problem; ``lam = inf`` degenerates to the balanced form), and
every iterative one defaults to the same stopping tolerance
``DEFAULT_TOL = 1e-6``. The sketching solvers (and ``nys_sink``) take their
random source as ``generator=`` (a `torch.Generator` on the problem's
device) or ``seed=``.
"""
from __future__ import annotations

import math

import torch

from repro_torch._device import make_generator
from repro_torch.core import sparsify
from repro_torch.core.api.geometry import PointCloudGeometry
from repro_torch.core.api.problems import OTProblem, UOTProblem
from repro_torch.core.api.registry import register_solver
from repro_torch.core.api.solution import Solution, SparsePlan, _potentials_from_scalings
from repro_torch.core.baselines import greenkhorn, nys_sink, screenkhorn_lite
from repro_torch.core.sinkhorn import (
    _masked_log,
    generic_scaling_loop,
    generic_sparse_log_loop,
    plan_from_potentials,
    plan_from_scalings,
    sinkhorn,
    sinkhorn_log,
    sinkhorn_uot,
    sinkhorn_uot_log,
)
from repro_torch.core.spar_sink import (
    coo_objective_ot_entries,
    coo_objective_ot_log_entries,
    coo_objective_uot_entries,
    coo_objective_uot_log_entries,
    default_cap,
    default_max_blocks,
    log_plan_entries,
)
from repro_torch.obs.certify import dense_certificate, importance_ess, sparse_certificate
from repro_torch.obs.trace import sketch_diagnostics

__all__ = [
    "DEFAULT_TOL",
    "build_block_ell_sketch",
    "build_coo_log_sketch",
    "build_coo_sketch",
    "build_mf_log_sketch",
    "build_mf_sketch",
    "mix_uniform",
    "sampling_probs",
]

#: shared stopping-tolerance default of every registered iterative method
DEFAULT_TOL = 1e-6


def _generator(problem: OTProblem, generator=None, seed: int | None = None) -> torch.Generator:
    """The sketch's random source on the problem's device (`make_generator`)."""
    return make_generator(problem.device, generator, seed)


# --------------------------------------------------------------------------
# Sampling probabilities shared by the sketch paths
# --------------------------------------------------------------------------


def mix_uniform(probs, shrinkage: float):
    """Thm 1 condition (ii): keep ``p*_ij >= c3 s / n^2`` by uniform mixing.
    Factored ``(fr, fc)`` probabilities pass only unmixed (mixing is rank-2)."""
    if shrinkage <= 0.0:
        return probs
    if isinstance(probs, tuple):
        raise ValueError(
            "uniform mixing (shrinkage > 0) is rank-2 and cannot be applied "
            "to factored probabilities; pass a dense probs array instead"
        )
    n, m = probs.shape
    return (1.0 - shrinkage) * probs + shrinkage / (n * m)


def sampling_probs(problem: OTProblem) -> torch.Tensor:
    """Paper eq. (9) for OT, eq. (11) for UOT (degenerates to (9) at lam=inf)."""
    if _is_uot(problem):
        return sparsify.uot_sampling_probs(
            problem.a, problem.b, problem.log_kernel(), float(problem.lam), float(problem.eps)
        )
    return sparsify.ot_sampling_probs(problem.a, problem.b)


def _resolve_probs(problem: OTProblem, probs: torch.Tensor | None, shrinkage: float) -> torch.Tensor:
    """The probability rule of the dense sketch paths: explicit ``probs``,
    else eq. (9)/(11) by problem type, then uniform mixing."""
    return mix_uniform(probs if probs is not None else sampling_probs(problem), shrinkage)


# --------------------------------------------------------------------------
# The eq. (7) Bernoulli sketches of the dense kernel
# --------------------------------------------------------------------------


def build_coo_sketch(
    problem: OTProblem,
    generator: torch.Generator,
    s: float,
    *,
    cap: int | None = None,
    probs: torch.Tensor | None = None,
    shrinkage: float = 0.0,
) -> sparsify.SparseKernelCOO:
    """Importance-sparsified padded COO sketch of the problem's Gibbs kernel
    (`sparsify.sparsify_coo`; ``cap`` defaults to `default_cap`)."""
    probs = _resolve_probs(problem, probs, shrinkage)
    cap = default_cap(s) if cap is None else cap
    return sparsify.sparsify_coo(generator, problem.kernel(), probs, s, cap)


def build_coo_log_sketch(
    problem: OTProblem,
    generator: torch.Generator,
    s: float,
    *,
    cap: int | None = None,
    probs: torch.Tensor | None = None,
    shrinkage: float = 0.0,
) -> tuple[sparsify.LogSparseKernelCOO, torch.Tensor]:
    """Log-space importance sketch and its index-aligned gathered costs.

    OT (and explicit ``probs``): `build_coo_sketch`'s draw, so the same
    generator state keeps the same support, with ``logvals = -C_e/eps -
    log p*_e``. UOT: the eq. (11) probabilities are computed, normalized,
    mixed with ``shrinkage`` and drawn in log space
    (`sparsify.uot_sampling_logprobs`), so a sharply concentrated
    small-``eps`` distribution keeps its support.
    """
    cap = default_cap(s) if cap is None else cap
    cost = problem.geom.cost
    eps = float(problem.eps)
    if probs is None and _is_uot(problem):
        logp = sparsify.uot_sampling_logprobs(problem.a, problem.b, cost, float(problem.lam), eps)
        if shrinkage > 0.0:  # mix_uniform in log space (Thm 1 condition (ii))
            n, m = problem.shape
            logp = torch.logaddexp(math.log1p(-shrinkage) + logp, math.log(shrinkage) - math.log(float(n * m)))
        return sparsify.sparsify_coo_log(generator, cost, None, eps, s, cap, logprobs=logp)
    probs = _resolve_probs(problem, probs, shrinkage)
    return sparsify.sparsify_coo_log(generator, cost, probs, eps, s, cap)


# --------------------------------------------------------------------------
# Matrix-free sketches
# --------------------------------------------------------------------------


def _mf_geometry(problem: OTProblem) -> PointCloudGeometry:
    geom = problem.geom
    if not isinstance(geom, PointCloudGeometry):
        raise TypeError(
            "the matrix-free path needs support points: build the problem on "
            "a PointCloudGeometry(x, y, cost=...) instead of a dense-cost "
            f"Geometry (got {type(geom).__name__})"
        )
    return geom


def _proposal(problem: OTProblem):
    """``(ra, rb, thin_scale)``: eq. (9) factors for OT; for UOT the rank-1
    ``(a_i b_j)^{lam/(2lam+eps)}`` proposal of eq. (11) and its thinning
    scale ``1/(2lam+eps)``."""
    if _is_uot(problem):
        lam, eps = float(problem.lam), float(problem.eps)
        c_ab = lam / (2.0 * lam + eps)
        qa, qb = problem.a ** c_ab, problem.b ** c_ab
        return qa / torch.sum(qa), qb / torch.sum(qb), 1.0 / (2.0 * lam + eps)
    ra, rb = sparsify.ot_sampling_prob_factors(problem.a, problem.b)
    return ra, rb, None


def build_mf_sketch(
    problem: OTProblem,
    generator: torch.Generator,
    s: float,
    *,
    cap: int | None = None,
    impl: str = "auto",
) -> tuple[sparsify.SparseKernelCOO, torch.Tensor]:
    """Matrix-free importance sketch in O(n + s log n), no (n, m) array.

    OT draws the rank-1 eq. (9) probabilities exactly; UOT proposes from the
    rank-1 part of eq. (11) and thins by ``K^{eps/(2lam+eps)}``, so ``s`` is
    then the proposal budget. Kernel values come from
    `PointCloudGeometry.entries` (``impl``). Returns ``(sketch, C_e)``.
    """
    geom = _mf_geometry(problem)
    eps = float(problem.eps)
    cap = default_cap(s) if cap is None else cap
    ra, rb, thin_scale = _proposal(problem)
    # unchecked: the draw clamps rows to n - 1 and columns to m - 1
    # (sparsify._draw), so no range flag is read and nothing syncs
    return sparsify.sparsify_coo_mf(
        generator, ra, rb, s, cap,
        lambda r, c: geom._entries(r, c, eps, impl, checked=False),
        thin_scale=thin_scale,
    )


def build_mf_log_sketch(
    problem: OTProblem,
    generator: torch.Generator,
    s: float,
    *,
    cap: int | None = None,
) -> tuple[sparsify.LogSparseKernelCOO, torch.Tensor]:
    """Matrix-free log-space importance sketch: `build_mf_sketch`'s draw
    with ``logvals = -C_e/eps - log rate_e`` from gathered raw costs, so
    ``exp(-C/eps)`` is never evaluated; on the card the costs come from the
    float64 cost-only kernel. Returns ``(sketch, C_e)``."""
    geom = _mf_geometry(problem)
    cap = default_cap(s) if cap is None else cap
    ra, rb, thin_scale = _proposal(problem)
    # unchecked, as in build_mf_sketch: the draw's indices are in range
    return sparsify.sparsify_coo_mf_log(
        generator, ra, rb, s, cap, geom._sketch_cost_entries, float(problem.eps), thin_scale=thin_scale
    )


# --------------------------------------------------------------------------
# Sorted-COO iterations
# --------------------------------------------------------------------------


def _coo_scaling_loop(problem: OTProblem, sk, tol: float, max_iter: int, trace: bool | int = False):
    """Scaling-domain Sinkhorn on the sketch: sorted segment sums, with the
    segment offsets computed once for the whole loop."""
    row_off, col_layout = sparsify.row_offsets(sk), sparsify.col_layout(sk)
    return generic_scaling_loop(
        lambda v: sparsify.coo_matvec(sk, v, row_off),
        lambda u: sparsify.coo_rmatvec(sk, u, col_layout),
        problem.a, problem.b, problem.fe,
        tol=tol, max_iter=max_iter, trace=trace,
    )


def _sparse_log_loop(problem: OTProblem, sk, tol: float, max_iter: int, trace: bool | int = False,
                     init: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Log-domain Sinkhorn on a log-space sketch: sorted segment-logsumexps
    driven by `generic_sparse_log_loop`. (The reference runs its batched
    loop at B = 1 here; the two agree at rounding level.)"""
    eps = float(problem.eps)
    row_off, col_layout = sparsify.row_offsets(sk), sparsify.col_layout(sk)
    return generic_sparse_log_loop(
        lambda g: sparsify.coo_lse_row(sk, g / eps, row_off),
        lambda f: sparsify.coo_lse_col(sk, f / eps, col_layout),
        _masked_log(problem.a), _masked_log(problem.b), eps, problem.fe,
        tol=tol, max_iter=max_iter, trace=trace, init=init,
    )


def _is_uot(problem: OTProblem) -> bool:
    return isinstance(problem, UOTProblem) and not problem.is_balanced


def _coo_value(problem: OTProblem, sk, c_e, res) -> torch.Tensor:
    """O(cap) entropic objective of a scaling-domain sketch solve."""
    if _is_uot(problem):
        return coo_objective_uot_entries(
            sk, c_e, res, problem.a, problem.b, float(problem.lam), problem.eps
        )
    return coo_objective_ot_entries(sk, c_e, res, problem.eps)


def _coo_log_value(problem: OTProblem, sk, c_e, res) -> torch.Tensor:
    """O(cap) entropic objective of a log-domain sketch solve."""
    if _is_uot(problem):
        return coo_objective_uot_log_entries(
            sk, c_e, res, problem.a, problem.b, float(problem.lam), problem.eps
        )
    return coo_objective_ot_log_entries(sk, c_e, res, problem.eps)


# --------------------------------------------------------------------------
# Sketch statistics and certificates (only behind trace= / certify=)
# --------------------------------------------------------------------------


def _sketch_stats(sk, trace):
    """The sketch's `SketchStats`, computed only for a traced solve."""
    return sketch_diagnostics(sk) if trace else None


def _problem_lam(problem: OTProblem) -> float:
    """The marginal penalty as a float; ``inf`` selects the balanced dual."""
    return float(problem.lam) if isinstance(problem, UOTProblem) else math.inf


def _kernel_cost(Kt: torch.Tensor, eps: float) -> torch.Tensor:
    """The effective cost ``-eps log Kt`` of a (sketched) dense kernel, with
    zero or negative entries at ``+inf`` (outside the support)."""
    pos = Kt > 0
    return torch.where(pos, -eps * torch.log(torch.where(pos, Kt, 1.0)), math.inf)


def _sparse_cert(problem: OTProblem, sk, res, value, c_e, *, log_domain: bool):
    """Certificate of a sketch solve in O(cap + n): the dense-anchored
    duality gap through the Horvitz-Thompson kernel entries ``k_e``, and the
    delta-method CI from the recovered inclusion probabilities (``p*_e =
    K_e / vals_e``); ``c_e`` are the raw gathered costs. The marginals run
    over the sketch's sorted rows and its own column layout."""
    eps = float(problem.eps)
    if log_domain:
        t_e = log_plan_entries(sk, res, eps)
        f, g = res.u, res.v
        fh = torch.where(torch.isfinite(f), f, 0.0)
        gh = torch.where(torch.isfinite(g), g, 0.0)
        # the dual's kernel entries at the masked potentials (t_e if none died)
        logk = sk.logvals + (fh[sk.rows] + gh[sk.cols]) / eps
        k_e = torch.where(torch.isneginf(logk), 0.0, torch.exp(logk))
        # logvals = -C_e/eps - log p*_e  =>  log p*_e = -C_e/eps - logvals
        logp = torch.clamp_max(-c_e / eps - sk.logvals, 0.0)
        p_e = torch.where(torch.isneginf(sk.logvals), 1.0, torch.exp(logp))
        ess = importance_ess(sk.logvals, log_space=True)
    else:
        vals = sk.vals
        alive = vals > 0
        t_e = res.u[sk.rows] * vals * res.v[sk.cols]
        f, g = _potentials_from_scalings(res.u, res.v, eps)
        uh = torch.where(res.u > 0, res.u, 1.0)
        vh = torch.where(res.v > 0, res.v, 1.0)
        k_e = uh[sk.rows] * vals * vh[sk.cols]
        # vals = K_e / p*_e  =>  p*_e = exp(-C_e/eps) / vals
        K_e = torch.where(torch.isfinite(c_e), torch.exp(-c_e / eps), 0.0)
        p_e = torch.where(alive, torch.clamp(K_e / torch.where(alive, vals, 1.0), 0.0, 1.0), 1.0)
        ess = importance_ess(vals)
    n, m = problem.shape
    return sparse_certificate(
        t_e=t_e, c_e=c_e, rows=sk.rows, cols=sk.cols, n=n, m=m, a=problem.a, b=problem.b,
        f=f, g=g, eps=eps, lam=_problem_lam(problem), value=value, k_e=k_e, p_e=p_e, ess=ess,
        col_layout=sparsify.col_layout(sk),
    )


def _plan_cert(problem: OTProblem, T: torch.Tensor, value, f, g, cost: torch.Tensor | None = None):
    """`dense_certificate` of a dense plan ``T`` on the problem's cost, or on
    ``cost`` for a solver whose kernel is itself sketched or factored."""
    return dense_certificate(
        plan=T, cost=problem.geom.cost if cost is None else cost, a=problem.a, b=problem.b,
        f=f, g=g, eps=float(problem.eps), lam=_problem_lam(problem), value=value,
    )


# --------------------------------------------------------------------------
# Solutions
# --------------------------------------------------------------------------


def _scaling_sketch_solution(method: str, problem: OTProblem, sk, c_e, tol: float, max_iter: int,
                             trace: bool | int = False, certify: bool = False) -> Solution:
    """The scaling-domain iteration on a COO sketch, its objective from the
    gathered costs ``c_e``, and its `Solution`, whose plan is the
    `SparsePlan` ``u_i K~_e v_j`` on the kept entries."""
    res = _coo_scaling_loop(problem, sk, tol, max_iter, trace)
    value = _coo_value(problem, sk, c_e, res)
    cert = _sparse_cert(problem, sk, res, value, c_e, log_domain=False) if certify else None

    def plan() -> SparsePlan:
        return SparsePlan(sk.rows, sk.cols, res.u[sk.rows] * sk.vals * res.v[sk.cols], sk.nnz, sk.n, sk.m)

    return Solution(
        method=method, problem=problem, value=value, result=res, domain="scaling",
        nnz=sk.nnz, overflowed=sk.overflowed, sketch_stats=_sketch_stats(sk, trace), certificate=cert,
        _plan_thunk=plan,
    )


def _sparse_log_solution(method: str, problem: OTProblem, sk, c_e, tol: float, max_iter: int,
                         trace: bool | int = False, certify: bool = False,
                         init: tuple[torch.Tensor, torch.Tensor] | None = None) -> Solution:
    """The log-domain iteration on a log-space sketch, its objective from
    the gathered costs ``c_e``, and its ``domain="log"`` `Solution`."""
    res = _sparse_log_loop(problem, sk, tol, max_iter, trace, init)
    value = _coo_log_value(problem, sk, c_e, res)
    cert = _sparse_cert(problem, sk, res, value, c_e, log_domain=True) if certify else None
    eps = float(problem.eps)

    def plan() -> SparsePlan:
        return SparsePlan(sk.rows, sk.cols, log_plan_entries(sk, res, eps), sk.nnz, sk.n, sk.m)

    return Solution(
        method=method, problem=problem, value=value, result=res, domain="log",
        nnz=sk.nnz, overflowed=sk.overflowed, sketch_stats=_sketch_stats(sk, trace), certificate=cert,
        _plan_thunk=plan,
    )


def _dense_solution(problem: OTProblem, method: str, res, Kt: torch.Tensor, *, nnz=None, certify: bool = False,
                    cost: torch.Tensor | None = None) -> Solution:
    """The `Solution` whose plan is the dense ``diag(u) Kt diag(v)``. The plan
    is rebuilt by the thunk, not kept: a `Solution` pins only ``Kt`` (for
    the dense solvers the kernel that the Geometry's cache holds anyway).
    ``certify=True`` certifies the transient plan (against ``cost`` where
    the kernel is sketched)."""
    T = plan_from_scalings(res.u, Kt, res.v)
    value = problem.objective(T)
    cert = None
    if certify:
        f, g = _potentials_from_scalings(res.u, res.v, float(problem.eps))
        cert = _plan_cert(problem, T, value, f, g, cost=cost)
    del T
    return Solution(
        method=method, problem=problem, value=value, result=res, domain="scaling", nnz=nnz,
        certificate=cert, _plan_thunk=lambda: plan_from_scalings(res.u, Kt, res.v),
    )


# --------------------------------------------------------------------------
# Dense-kernel solvers
# --------------------------------------------------------------------------


@register_solver("dense")
def _solve_dense(
    problem: OTProblem,
    *,
    tol: float = DEFAULT_TOL,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
) -> Solution:
    """Scaling-domain Sinkhorn on the dense Gibbs kernel (Alg. 1 / Alg. 2)."""
    K = problem.kernel()
    if problem.fe == 1.0:
        res = sinkhorn(K, problem.a, problem.b, tol=tol, max_iter=max_iter, trace=trace)
    else:
        res = sinkhorn_uot(
            K, problem.a, problem.b, problem.lam, problem.eps, tol=tol, max_iter=max_iter, trace=trace
        )
    return _dense_solution(problem, "dense", res, K, certify=certify)


@register_solver("log")
def _solve_log(
    problem: OTProblem,
    *,
    tol: float = DEFAULT_TOL,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
    init: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Solution:
    """Log-domain Sinkhorn on dual potentials (survives ``eps`` down to 1e-3).
    ``init=(f0, g0)`` warm-starts the potentials (re-tightening at the
    original ``eps`` from an eps-bumped solve)."""
    logK = problem.log_kernel()
    eps = float(problem.eps)
    if problem.fe == 1.0:
        res = sinkhorn_log(logK, problem.a, problem.b, eps, tol=tol, max_iter=max_iter, trace=trace, init=init)
    else:
        res = sinkhorn_uot_log(
            logK, problem.a, problem.b, float(problem.lam), eps, tol=tol, max_iter=max_iter,
            trace=trace, init=init,
        )
    T = plan_from_potentials(res.u, logK, res.v, eps)
    value = problem.objective(T)
    cert = _plan_cert(problem, T, value, res.u, res.v) if certify else None
    del T
    return Solution(
        method="log", problem=problem, value=value, result=res, domain="log", certificate=cert,
        _plan_thunk=lambda: plan_from_potentials(res.u, logK, res.v, eps),
    )


# --------------------------------------------------------------------------
# Sketching solvers (paper Algorithms 3 & 4 and the Rand-Sink baseline)
# --------------------------------------------------------------------------


@register_solver("spar_sink_coo")
def _solve_spar_sink_coo(
    problem: OTProblem,
    *,
    s: float,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    cap: int | None = None,
    shrinkage: float = 0.0,
    probs: torch.Tensor | None = None,
    tol: float = DEFAULT_TOL,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
) -> Solution:
    """Spar-Sink on the padded-COO sketch (`build_coo_sketch`): O(s)
    iterations of sorted segment sums, an O(cap) plan. Scaling domain: at
    small ``eps`` the sketch underflows, and the solve stops ``degenerate``,
    or ``non_finite`` at its first iteration where a denormal ``K~ v``
    makes ``a / K~ v`` overflow; use ``spar_sink_log`` there."""
    sk = build_coo_sketch(problem, _generator(problem, generator, seed), s, cap=cap, probs=probs,
                          shrinkage=shrinkage)
    return _spar_sink_coo_on(problem, sk, tol, max_iter, trace=trace, certify=certify)


def _spar_sink_coo_on(problem: OTProblem, sk, tol: float, max_iter: int, method: str = "spar_sink_coo", *,
                      trace: bool | int = False, certify: bool = False) -> Solution:
    """Everything of ``spar_sink_coo`` after the sketch: the costs read from
    the dense cost's kept entries."""
    c_e = problem.geom.cost[sk.rows, sk.cols]
    return _scaling_sketch_solution(method, problem, sk, c_e, tol, max_iter, trace, certify)


@register_solver("spar_sink_log")
def _solve_spar_sink_log(
    problem: OTProblem,
    *,
    s: float,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    cap: int | None = None,
    shrinkage: float = 0.0,
    probs: torch.Tensor | None = None,
    tol: float = DEFAULT_TOL,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
    init: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Solution:
    """Log-domain Spar-Sink, safe for small ``eps``: ``spar_sink_coo``'s
    sketch (the same support for the same generator state on OT problems)
    carried as ``logvals`` (`build_coo_log_sketch`), iterated by sorted
    segment-logsumexp on potentials. Returns a ``domain="log"`` `Solution`."""
    sk, c_e = build_coo_log_sketch(problem, _generator(problem, generator, seed), s, cap=cap, probs=probs,
                                   shrinkage=shrinkage)
    return _sparse_log_solution("spar_sink_log", problem, sk, c_e, tol, max_iter, trace, certify, init)


@register_solver("spar_sink_mf")
def _solve_spar_sink_mf(
    problem: OTProblem,
    *,
    s: float,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    cap: int | None = None,
    impl: str = "auto",
    shared_variates: bool = False,
    stabilize: bool = False,
    tol: float = DEFAULT_TOL,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
    init: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Solution:
    """Matrix-free Spar-Sink: Õ(n) end to end, no (n, m) array anywhere.

    Needs a `PointCloudGeometry` problem and a random source: ``generator``
    (a `torch.Generator` on the problem's device) or ``seed``. The sketch is
    the factorized O(s log n) sampler (`build_mf_sketch`, kernel values
    through ``impl``, see `PointCloudGeometry.entries`), the iteration runs
    sorted-COO segment sums, and the objective uses the gathered costs.

    ``stabilize=True`` runs the whole pipeline in the log domain
    (`build_mf_log_sketch` + segment-logsumexp on potentials): still
    matrix-free, safe for small ``eps`` where the scaling-domain sketch
    underflows ``exp(-C/eps)``. It returns a ``domain="log"`` `Solution`;
    ``impl`` does not apply to it (it gathers raw costs only), and only it
    takes ``init=(f0, g0)``.

    ``shared_variates=True`` is the small-n test mode: it draws the dense
    Bernoulli sketch of ``spar_sink_coo`` (``spar_sink_log`` with
    ``stabilize=True``), which needs the dense kernel and so stays under the
    geometry's ``dense_guard``; the scalings are then bitwise those of that
    solver for the same generator state, and only the objective differs
    (costs gathered by `PointCloudGeometry.cost_entries`, on the card the
    float64 cost-only kernel, against the dense cost's entries).
    """
    geom = _mf_geometry(problem)
    if init is not None and not stabilize:
        raise ValueError("init= (warm-started potentials) requires the log-domain stabilize=True path")
    gen = _generator(problem, generator, seed)
    if stabilize:
        if shared_variates:
            sk, c_e = build_coo_log_sketch(problem, gen, s, cap=cap)
        else:
            sk, c_e = build_mf_log_sketch(problem, gen, s, cap=cap)
        return _sparse_log_solution("spar_sink_mf", problem, sk, c_e, tol, max_iter, trace, certify, init)
    if shared_variates:
        sk = build_coo_sketch(problem, gen, s, cap=cap)
        c_e = geom.cost_entries(sk.rows, sk.cols)
    else:
        sk, c_e = build_mf_sketch(problem, gen, s, cap=cap, impl=impl)
    return _scaling_sketch_solution("spar_sink_mf", problem, sk, c_e, tol, max_iter, trace, certify)


@register_solver("rand_sink")
def _solve_rand_sink(
    problem: OTProblem,
    *,
    s: float,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    cap: int | None = None,
    tol: float = DEFAULT_TOL,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
) -> Solution:
    """``spar_sink_coo`` with uniform probabilities (the paper's Rand-Sink),
    given as row/col factors in the geometry's dtype
    (`sparsify.uniform_prob_factors`), so no (n, m) probability array."""
    n, m = problem.shape
    probs = sparsify.uniform_prob_factors(n, m, problem.geom.dtype, problem.device)
    sk = build_coo_sketch(problem, _generator(problem, generator, seed), s, cap=cap, probs=probs)
    return _spar_sink_coo_on(problem, sk, tol, max_iter, method="rand_sink", trace=trace, certify=certify)


@register_solver("spar_sink_dense")
def _solve_spar_sink_dense(
    problem: OTProblem,
    *,
    s: float,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    shrinkage: float = 0.0,
    probs: torch.Tensor | None = None,
    tol: float = DEFAULT_TOL,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
) -> Solution:
    """The exact eq. (7) sketch held as a dense masked array
    (`sparsify.sparsify_dense`: ``spar_sink_coo``'s draw), iterated by dense
    mat-vecs: the O(n^2) reference of the sketch solvers (scaling domain)."""
    gen = _generator(problem, generator, seed)
    Kt = sparsify.sparsify_dense(gen, problem.kernel(), _resolve_probs(problem, probs, shrinkage), s)
    return _spar_sink_dense_on(problem, Kt, tol, max_iter, trace=trace, certify=certify)


def _spar_sink_dense_on(problem: OTProblem, Kt: torch.Tensor, tol: float, max_iter: int, *,
                        trace: bool | int = False, certify: bool = False) -> Solution:
    """Everything of ``spar_sink_dense`` after the sketch ``Kt``; the
    certificate is taken on the sketch's effective cost."""
    res = generic_scaling_loop(
        lambda v: Kt @ v, lambda u: Kt.T @ u, problem.a, problem.b, problem.fe, tol=tol, max_iter=max_iter,
        trace=trace,
    )
    return _dense_solution(
        problem, "spar_sink_dense", res, Kt, nnz=torch.sum(Kt > 0), certify=certify,
        cost=_kernel_cost(Kt, float(problem.eps)) if certify else None,
    )


# --------------------------------------------------------------------------
# The tile-granular sketching solver (block-ELL layout)
# --------------------------------------------------------------------------


def _block_ell_solution(problem: OTProblem, sk: sparsify.BlockEllKernel, tol: float, max_iter: int, *,
                        trace: bool | int = False, certify: bool = False) -> Solution:
    """Scaling-domain Sinkhorn on a block-ELL sketch, and its `Solution`.

    On the card the two mat-vecs launch the two block-ELL kernels, both on
    the row layout's float32 tiles (``K~^T u`` through the sketch's column
    lists), in the loop's float64 or float32; the kernels flag an index out
    of range, and the flag is read once, after the loop. The objective (and
    the certificate, on the sketch's effective cost) is taken on the
    densified sketch, which is then dropped: the `Solution` keeps the tiles
    and rebuilds the dense plan on first access.
    """
    bad = torch.zeros(1, dtype=torch.int32, device=problem.device) if sk.vals.is_cuda else None
    res = generic_scaling_loop(
        lambda v: sparsify.block_ell_matvec(sk, v, bad),
        lambda u: sparsify.block_ell_rmatvec(sk, u, bad),
        problem.a, problem.b, problem.fe,
        tol=tol, max_iter=max_iter, trace=trace,
    )
    if bad is not None and bool(bad):
        raise IndexError("the block-ELL sketch holds a column id out of range")
    Kt = sparsify.block_ell_to_dense(sk)
    T = plan_from_scalings(res.u, Kt, res.v)
    value = problem.objective(T)
    nnz = torch.sum(Kt > 0)
    cert = None
    if certify:
        eps = float(problem.eps)
        f, g = _potentials_from_scalings(res.u, res.v, eps)
        cert = _plan_cert(problem, T, value, f, g, cost=_kernel_cost(Kt, eps))
    del T, Kt
    return Solution(
        method="spar_sink_block_ell", problem=problem, value=value, result=res, domain="scaling",
        nnz=nnz, certificate=cert,
        _plan_thunk=lambda: plan_from_scalings(res.u, sparsify.block_ell_to_dense(sk), res.v),
    )


def build_block_ell_sketch(
    problem: OTProblem,
    generator: torch.Generator,
    s: float,
    *,
    block: int = 128,
    max_blocks: int | None = None,
    shrinkage: float = 0.0,
    probs: torch.Tensor | None = None,
) -> sparsify.BlockEllKernel:
    """The tile-granular importance sketch of ``spar_sink_block_ell``, with
    its transposed layout: tiles of the dense kernel kept with
    ``p*_T = min(1, s/Bk^2 * p_T)`` (``p_T`` the tile sum of eq. 9/11, or of
    ``probs``, mixed with ``shrinkage``) and rescaled by ``1/p*_T``, the
    heaviest tile of every row- and column-block forced in; ``max_blocks``
    (default `default_max_blocks`) is the ELL width. Builds the dense
    kernel, so a `PointCloudGeometry` above its ``dense_guard`` raises;
    ``n`` and ``m`` must be multiples of ``block``."""
    n, m = problem.shape
    if n % block or m % block:
        raise ValueError(f"spar_sink_block_ell needs n and m divisible by block={block}; got {n} x {m}")
    K = problem.kernel()
    tile_p = sparsify.tile_probs_from_elem(_resolve_probs(problem, probs, shrinkage), block)
    if max_blocks is None:
        max_blocks = default_max_blocks(n, s, block)
    return sparsify.sparsify_block_ell(generator, K, tile_p, s, block, max_blocks)


@register_solver("spar_sink_block_ell")
def _solve_spar_sink_block_ell(
    problem: OTProblem,
    *,
    s: float,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    block: int = 128,
    max_blocks: int | None = None,
    shrinkage: float = 0.0,
    probs: torch.Tensor | None = None,
    tol: float = DEFAULT_TOL,
    max_iter: int = 1000,
    trace: bool | int = False,
    certify: bool = False,
) -> Solution:
    """Spar-Sink with the importance sketch drawn at tile granularity
    (`build_block_ell_sketch`; the random source is ``generator``, a
    `torch.Generator` on the problem's device, or ``seed``), iterated in the
    scaling domain on the block-ELL layouts; the objective is taken on the
    densified sketch."""
    gen = _generator(problem, generator, seed)
    sk = build_block_ell_sketch(
        problem, gen, s, block=block, max_blocks=max_blocks, shrinkage=shrinkage, probs=probs
    )
    return _block_ell_solution(problem, sk, tol, max_iter, trace=trace, certify=certify)


# --------------------------------------------------------------------------
# Competitor solvers (paper Section 5 baselines)
# --------------------------------------------------------------------------


@register_solver("greenkhorn")
def _solve_greenkhorn(problem: OTProblem, *, n_updates: int | None = None, certify: bool = False) -> Solution:
    """Greedy single-coordinate scalings; ``n_updates`` defaults to 5(n+m)."""
    n, m = problem.shape
    if n_updates is None:
        n_updates = 5 * (n + m)
    K = problem.kernel()
    res = greenkhorn(K, problem.a, problem.b, n_updates, fe=float(problem.fe))
    return _dense_solution(problem, "greenkhorn", res, K, certify=certify)


@register_solver("nys_sink")
def _solve_nys_sink(
    problem: OTProblem,
    *,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    rank: int | None = None,
    tol: float = DEFAULT_TOL,
    max_iter: int = 1000,
    certify: bool = False,
) -> Solution:
    """Nystrom low-rank kernel (``rank`` landmarks, default ``min(n, m)/20``,
    at least 2) + Sinkhorn. Needs a near-PSD K (it fails on WFR). The
    objective is taken on a transient dense plan; the `Solution` keeps the
    O(n r) factors and rebuilds the plan on first access. The certificate
    is taken against the low-rank kernel the solver optimized (its negative
    entries fall outside the certified support)."""
    n, m = problem.shape
    if rank is None:
        rank = max(2, min(n, m) // 20)
    res, nk = nys_sink(
        _generator(problem, generator, seed), problem.kernel(), problem.a, problem.b, rank,
        tol=tol, max_iter=max_iter, fe=problem.fe,
    )
    T = plan_from_scalings(res.u, nk.dense(), res.v)
    value = problem.objective(T)
    cert = None
    if certify:
        eps = float(problem.eps)
        f, g = _potentials_from_scalings(res.u, res.v, eps)
        cert = _plan_cert(problem, T, value, f, g, cost=_kernel_cost(nk.dense(), eps))
    del T
    return Solution(
        method="nys_sink", problem=problem, value=value, result=res, domain="scaling", certificate=cert,
        _plan_thunk=lambda: plan_from_scalings(res.u, nk.dense(), res.v),
    )


@register_solver("screenkhorn_lite")
def _solve_screenkhorn_lite(
    problem: OTProblem, *, decimation: int = 3, tol: float = DEFAULT_TOL, max_iter: int = 1000,
    certify: bool = False,
) -> Solution:
    """Static active-set screening; screened-out atoms keep zero scalings."""
    K = problem.kernel()
    res, _, _ = screenkhorn_lite(
        K, problem.a, problem.b, decimation=decimation, tol=tol, max_iter=max_iter,
        fe=problem.fe, renormalize=problem.is_balanced,
    )
    return _dense_solution(problem, "screenkhorn_lite", res, K, certify=certify)
