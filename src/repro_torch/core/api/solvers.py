"""The built-in solver registry entries behind ``solve(problem, method=...)``.

================= ==========================================================
``dense``         Algorithm 1/2 on the dense Gibbs kernel (scaling domain);
                  the accuracy oracle of the sketching solver
``log``           log-domain Algorithm 1/2 (small-``eps`` safe)
``spar_sink_mf``  matrix-free Algorithms 3/4 on a `PointCloudGeometry`:
                  factorized O(s log n) Poisson sketch + gathered-kernel
                  evaluation (the CUDA kernel on the card), no (n, m) array
                  anywhere; ``stabilize=True`` runs it in the log domain
``spar_sink_block_ell``
                  the importance sketch drawn at (Bk x Bk) tile granularity,
                  stored in block-ELL layout with its transpose; both
                  mat-vecs of an iteration are the CUDA block-ELL kernel on
                  the card (scaling domain: needs ``eps`` large enough that
                  ``exp(-C/eps) > 0``); builds the dense kernel
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
    default_max_blocks,
    log_plan_entries,
)

__all__ = [
    "DEFAULT_TOL",
    "build_block_ell_sketch",
    "build_mf_log_sketch",
    "build_mf_sketch",
    "mix_uniform",
    "sampling_probs",
]

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


# --------------------------------------------------------------------------
# The tile-granular sketching solver (block-ELL layout)
# --------------------------------------------------------------------------


def _block_ell_solution(problem: OTProblem, sk: sparsify.BlockEllKernel, tol: float, max_iter: int) -> Solution:
    """Scaling-domain Sinkhorn on a block-ELL sketch, and its `Solution`.

    On the card the two mat-vecs launch the two block-ELL kernels, both on
    the row layout's float32 tiles (``K~^T u`` through the sketch's column
    lists), in the loop's float64 or float32; the kernels flag an index out
    of range, and the flag is read once, after the loop. The objective is
    taken on the densified sketch, which is then dropped: the `Solution`
    keeps the tiles and rebuilds the dense plan on first access.
    """
    bad = torch.zeros(1, dtype=torch.int32, device=problem.device) if sk.vals.is_cuda else None
    res = generic_scaling_loop(
        lambda v: sparsify.block_ell_matvec(sk, v, bad),
        lambda u: sparsify.block_ell_rmatvec(sk, u, bad),
        problem.a, problem.b, problem.fe,
        tol=tol, max_iter=max_iter,
    )
    if bad is not None and bool(bad):
        raise IndexError("the block-ELL sketch holds a column id out of range")
    Kt = sparsify.block_ell_to_dense(sk)
    value = problem.objective(plan_from_scalings(res.u, Kt, res.v))
    nnz = torch.sum(Kt > 0)
    del Kt
    return Solution(
        method="spar_sink_block_ell", problem=problem, value=value, result=res, domain="scaling",
        nnz=nnz,
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
    return _block_ell_solution(problem, sk, tol, max_iter)
