"""The built-in solver registry entries behind ``solve(problem, method=...)``.

================= ==========================================================
``dense``         Algorithm 1/2 on the dense Gibbs kernel (scaling domain);
                  the accuracy oracle of the sketching solver
``log``           log-domain Algorithm 1/2 (small-``eps`` safe)
``spar_sink_mf``  matrix-free Algorithms 3/4 on a `PointCloudGeometry`:
                  factorized O(s log n) Poisson sketch + gathered-kernel
                  evaluation (the CUDA kernel on the card), no (n, m) array
                  anywhere; ``stabilize=True`` runs it in the log domain
================= ==========================================================

Every solver takes `OTProblem` and `UOTProblem` (``fe = lam/(lam+eps)``
comes from the problem; ``lam = inf`` degenerates to the balanced form), and
every one defaults to the same stopping tolerance ``DEFAULT_TOL = 1e-6``.
"""
from __future__ import annotations

import torch

from repro_torch.core import sparsify
from repro_torch.core.api.geometry import PointCloudGeometry
from repro_torch.core.api.problems import OTProblem, UOTProblem
from repro_torch.core.api.registry import register_solver
from repro_torch.core.api.solution import Solution, SparsePlan
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
    log_plan_entries,
)

__all__ = ["DEFAULT_TOL", "build_mf_log_sketch", "build_mf_sketch"]

#: shared stopping-tolerance default of every registered iterative method
DEFAULT_TOL = 1e-6


def _generator(problem: OTProblem, generator=None, seed: int | None = None) -> torch.Generator:
    """The sketch's random source: ``generator`` as given, or a new one on
    the problem's device seeded with ``seed``; exactly one of them."""
    if (generator is None) == (seed is None):
        raise TypeError("pass exactly one of generator= (a torch.Generator) or seed=")
    if generator is None:
        generator = torch.Generator(device=problem.device).manual_seed(int(seed))
    if generator.device.type != problem.device.type:
        raise ValueError(f"generator is on {generator.device}, the problem on {problem.device}")
    return generator


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
    return sparsify.sparsify_coo_mf(
        generator, ra, rb, s, cap,
        lambda r, c: geom.entries(r, c, eps, impl=impl),
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
    ``exp(-C/eps)`` is never evaluated. Returns ``(sketch, C_e)``."""
    geom = _mf_geometry(problem)
    cap = default_cap(s) if cap is None else cap
    ra, rb, thin_scale = _proposal(problem)
    return sparsify.sparsify_coo_mf_log(
        generator, ra, rb, s, cap, geom.cost_entries, float(problem.eps), thin_scale=thin_scale
    )


# --------------------------------------------------------------------------
# Sorted-COO iterations
# --------------------------------------------------------------------------


def _coo_scaling_loop(problem: OTProblem, sk, tol: float, max_iter: int):
    """Scaling-domain Sinkhorn on the sketch: sorted segment sums, with the
    segment offsets computed once for the whole loop."""
    row_off, col_layout = sparsify.row_offsets(sk), sparsify.col_layout(sk)
    return generic_scaling_loop(
        lambda v: sparsify.coo_matvec(sk, v, row_off),
        lambda u: sparsify.coo_rmatvec(sk, u, col_layout),
        problem.a, problem.b, problem.fe,
        tol=tol, max_iter=max_iter,
    )


def _sparse_log_loop(problem: OTProblem, sk, tol: float, max_iter: int):
    """Log-domain Sinkhorn on a log-space sketch: sorted segment-logsumexps
    driven by `generic_sparse_log_loop`."""
    eps = float(problem.eps)
    row_off, col_layout = sparsify.row_offsets(sk), sparsify.col_layout(sk)
    return generic_sparse_log_loop(
        lambda g: sparsify.coo_lse_row(sk, g / eps, row_off),
        lambda f: sparsify.coo_lse_col(sk, f / eps, col_layout),
        _masked_log(problem.a), _masked_log(problem.b), eps, problem.fe,
        tol=tol, max_iter=max_iter,
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
# Dense-kernel solvers
# --------------------------------------------------------------------------


@register_solver("dense")
def _solve_dense(problem: OTProblem, *, tol: float = DEFAULT_TOL, max_iter: int = 1000) -> Solution:
    """Scaling-domain Sinkhorn on the dense Gibbs kernel (Alg. 1 / Alg. 2)."""
    K = problem.kernel()
    if problem.fe == 1.0:
        res = sinkhorn(K, problem.a, problem.b, tol=tol, max_iter=max_iter)
    else:
        res = sinkhorn_uot(
            K, problem.a, problem.b, problem.lam, problem.eps, tol=tol, max_iter=max_iter
        )
    # the plan is rebuilt by the thunk, not kept: a Solution pins only K,
    # which the Geometry's cache holds anyway
    value = problem.objective(plan_from_scalings(res.u, K, res.v))
    return Solution(
        method="dense", problem=problem, value=value, result=res, domain="scaling",
        _plan_thunk=lambda: plan_from_scalings(res.u, K, res.v),
    )


@register_solver("log")
def _solve_log(problem: OTProblem, *, tol: float = DEFAULT_TOL, max_iter: int = 1000) -> Solution:
    """Log-domain Sinkhorn on dual potentials (survives ``eps`` down to 1e-3)."""
    logK = problem.log_kernel()
    eps = float(problem.eps)
    if problem.fe == 1.0:
        res = sinkhorn_log(logK, problem.a, problem.b, eps, tol=tol, max_iter=max_iter)
    else:
        res = sinkhorn_uot_log(
            logK, problem.a, problem.b, float(problem.lam), eps, tol=tol, max_iter=max_iter
        )
    value = problem.objective(plan_from_potentials(res.u, logK, res.v, eps))
    return Solution(
        method="log", problem=problem, value=value, result=res, domain="log",
        _plan_thunk=lambda: plan_from_potentials(res.u, logK, res.v, eps),
    )


# --------------------------------------------------------------------------
# The matrix-free sketching solver (paper Algorithms 3 & 4)
# --------------------------------------------------------------------------


@register_solver("spar_sink_mf")
def _solve_spar_sink_mf(
    problem: OTProblem,
    *,
    s: float,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    cap: int | None = None,
    impl: str = "auto",
    stabilize: bool = False,
    tol: float = DEFAULT_TOL,
    max_iter: int = 1000,
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
    ``impl`` does not apply to it (it gathers raw costs only).
    """
    _mf_geometry(problem)
    gen = _generator(problem, generator, seed)
    if stabilize:
        sk, c_e = build_mf_log_sketch(problem, gen, s, cap=cap)
        res = _sparse_log_loop(problem, sk, tol, max_iter)
        value = _coo_log_value(problem, sk, c_e, res)
        eps = float(problem.eps)

        def plan() -> SparsePlan:
            return SparsePlan(sk.rows, sk.cols, log_plan_entries(sk, res, eps), sk.nnz, sk.n, sk.m)

        domain = "log"
    else:
        sk, c_e = build_mf_sketch(problem, gen, s, cap=cap, impl=impl)
        res = _coo_scaling_loop(problem, sk, tol, max_iter)
        value = _coo_value(problem, sk, c_e, res)

        def plan() -> SparsePlan:
            t_e = res.u[sk.rows] * sk.vals * res.v[sk.cols]
            return SparsePlan(sk.rows, sk.cols, t_e, sk.nnz, sk.n, sk.m)

        domain = "scaling"
    return Solution(
        method="spar_sink_mf", problem=problem, value=value, result=res, domain=domain,
        nnz=sk.nnz, overflowed=sk.overflowed, _plan_thunk=plan,
    )
