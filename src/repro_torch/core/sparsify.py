"""Matrix-free importance sparsification of the Gibbs kernel (paper Sec. 3).

The main-path part of ``repro.core.sparsify``: the factorized Poisson
sketch (eq. 7 for the rank-1 probabilities of eq. 9, with eq. 11
acceptance thinning for UOT), in the scaling domain (`SparseKernelCOO`) and
in log space (`LogSparseKernelCOO`), and the sorted-COO reductions the
Sinkhorn loops run on.

Every reduction here is over **sorted** segments (rows, or columns through
the ``csort`` permutation) and goes through `torch.segment_reduce` with
offsets, never through ``index_add_``/``scatter_add_``: on CUDA those sum
with atomics in an order that changes from run to run, and the same inputs
must give the same result.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

__all__ = [
    "LogSparseKernelCOO",
    "SparseKernelCOO",
    "coo_lse_col",
    "coo_lse_row",
    "coo_matvec",
    "coo_rmatvec",
    "col_layout",
    "ot_sampling_prob_factors",
    "row_offsets",
    "segment_logsumexp",
    "segment_sum",
    "sorted_offsets",
    "sparsify_coo_mf",
    "sparsify_coo_mf_log",
]


def ot_sampling_prob_factors(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row/col factors ``(ra, rb)`` with ``p_ij = ra_i * rb_j`` (eq. 9)."""
    sa, sb = torch.sqrt(a), torch.sqrt(b)
    return sa / torch.sum(sa), sb / torch.sum(sb)


class SparseKernelCOO(NamedTuple):
    """Padded COO sketch, **sorted by row**; padded slots carry
    ``vals == 0`` and park at row ``n-1`` after the first ``nnz`` entries."""

    rows: torch.Tensor  # (cap,) int64, ascending
    cols: torch.Tensor  # (cap,) int64
    vals: torch.Tensor  # (cap,) padded with 0.0
    nnz: torch.Tensor  # () int64 realized count (truncated to cap on overflow)
    n: int
    m: int
    #: col-sorted permutation: ``cols[csort]`` is ascending
    csort: torch.Tensor | None = None
    #: () bool, the draw exceeded ``cap`` and its tail was dropped
    overflowed: torch.Tensor | None = None
    #: () proposals drawn (before truncation) / alive before the merge
    n_proposed: torch.Tensor | None = None
    n_accepted: torch.Tensor | None = None

    @property
    def cap(self) -> int:
        return self.rows.shape[0]


class LogSparseKernelCOO(NamedTuple):
    """`SparseKernelCOO`'s layout carrying ``logvals = -C_e/eps - log rate_e``
    (padded with ``-inf``), finite where ``exp(-C/eps)`` underflows."""

    rows: torch.Tensor
    cols: torch.Tensor
    logvals: torch.Tensor
    nnz: torch.Tensor
    n: int
    m: int
    csort: torch.Tensor | None = None
    overflowed: torch.Tensor | None = None
    n_proposed: torch.Tensor | None = None
    n_accepted: torch.Tensor | None = None

    @property
    def cap(self) -> int:
        return self.rows.shape[0]


# --------------------------------------------------------------------------
# Sorted segment reductions (deterministic on every device)
# --------------------------------------------------------------------------


def sorted_offsets(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``(num_segments + 1,)`` offsets of the runs of an ascending id array:
    segment ``s`` is ``seg[off[s]:off[s+1]]`` (empty where ``s`` is absent)."""
    ids = torch.arange(num_segments + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, ids)


def segment_sum(data: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-segment sums over sorted segments; empty segments give 0."""
    return torch.segment_reduce(data, "sum", offsets=offsets, initial=0.0)


def segment_logsumexp(z: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-segment ``logsumexp`` via segment-max + segment-sum.

    ``-inf`` entries are inert (their shifted ``exp`` is masked to 0, so no
    ``-inf - -inf = nan``), and empty or all-dead segments come out exactly
    ``-inf``: the log-domain mirror of `coo_matvec`'s zero rows.
    """
    mx = torch.segment_reduce(z, "max", offsets=offsets, initial=-math.inf)
    lengths = offsets[1:] - offsets[:-1]
    mx_e = torch.repeat_interleave(mx, lengths, output_size=z.shape[0])
    e = torch.where(torch.isneginf(z), 0.0, torch.exp(z - mx_e))
    tot = segment_sum(e, offsets)
    return torch.where(torch.isneginf(mx), -math.inf, mx + torch.log(tot))


def row_offsets(sk) -> torch.Tensor:
    """Offsets of the sketch's row segments (its rows are sorted)."""
    return sorted_offsets(sk.rows, sk.n)


def col_layout(sk) -> tuple[torch.Tensor, torch.Tensor]:
    """``(csort, offsets of the column segments in csort order)``."""
    return sk.csort, sorted_offsets(sk.cols[sk.csort], sk.m)


def coo_matvec(sk: SparseKernelCOO, v: torch.Tensor, offsets: torch.Tensor | None = None) -> torch.Tensor:
    """``K~ v`` in O(cap). ``offsets`` (`row_offsets(sk)`) may be passed to
    skip recomputing them every iteration."""
    offsets = row_offsets(sk) if offsets is None else offsets
    return segment_sum(sk.vals * v[sk.cols], offsets)


def coo_rmatvec(sk: SparseKernelCOO, u: torch.Tensor, layout=None) -> torch.Tensor:
    """``K~^T u`` in O(cap) through the col-sorted permutation ``csort``;
    ``layout`` is a precomputed `col_layout(sk)`."""
    csort, offsets = col_layout(sk) if layout is None else layout
    return segment_sum((sk.vals * u[sk.rows])[csort], offsets)


def coo_lse_row(sk: LogSparseKernelCOO, y: torch.Tensor, offsets: torch.Tensor | None = None) -> torch.Tensor:
    """``logsumexp_j(logvals_e + y[cols_e])`` per row (callers pass ``g/eps``)."""
    offsets = row_offsets(sk) if offsets is None else offsets
    return segment_logsumexp(sk.logvals + y[sk.cols], offsets)


def coo_lse_col(sk: LogSparseKernelCOO, y: torch.Tensor, layout=None) -> torch.Tensor:
    """``logsumexp_i(logvals_e + y[rows_e])`` per column, through ``csort``."""
    csort, offsets = col_layout(sk) if layout is None else layout
    return segment_logsumexp((sk.logvals + y[sk.rows])[csort], offsets)


# --------------------------------------------------------------------------
# The factorized Poisson draw
# --------------------------------------------------------------------------


def _draw(generator, ra, rb, s: float, cap: int):
    """Per-row Poisson totals ``N_i ~ Poisson(s ra_i)``, laid out row-sorted
    over ``cap`` slots, each slot's column by inverse CDF on ``rb``.
    Returns ``(rows, cols, valid, total)``; slots past the total (or past
    ``cap`` on overflow) are invalid and park at row ``n-1``."""
    n, m = ra.shape[0], rb.shape[0]
    counts = torch.poisson(s * ra, generator=generator)
    total = torch.sum(counts).to(torch.int64)
    slot = torch.arange(cap, device=ra.device)
    rows = torch.searchsorted(torch.cumsum(counts, 0), slot.to(counts.dtype), right=True)
    rows = torch.clamp_max(rows, n - 1)
    u = torch.rand(cap, dtype=rb.dtype, device=rb.device, generator=generator)
    cols = torch.clamp_max(torch.searchsorted(torch.cumsum(rb, 0), u, right=True), m - 1)
    valid = slot < torch.clamp_max(total, cap)
    return rows, cols, valid, total


def _merge_and_compact(rows, cols, w, c_e, m: int, alive_fn, merge_fn, dead):
    """Sort entries by (row, col), merge duplicate pairs with ``merge_fn``
    over the duplicate groups, and move every dead slot (``alive_fn`` false:
    rejected, blocked, overflow, merged copies) behind the live ones, keeping
    row order. Returns the compacted ``(rows, cols, w, c_e, alive)``."""
    order = torch.sort(rows * m + cols, stable=True).indices
    rows, cols, w, c_e = rows[order], cols[order], w[order], c_e[order]
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    grp = torch.cumsum(first, 0) - 1
    offsets = sorted_offsets(grp, w.shape[0])
    merged = merge_fn(w, offsets)
    w = torch.where(first, merged[grp], dead)
    compact = torch.argsort((~alive_fn(w)).to(torch.uint8), stable=True)
    rows, cols, w, c_e = rows[compact], cols[compact], w[compact], c_e[compact]
    return rows, cols, w, c_e, alive_fn(w)


def sparsify_coo_mf(
    generator: torch.Generator,
    ra: torch.Tensor,
    rb: torch.Tensor,
    s: float,
    cap: int,
    entries_fn: Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    *,
    thin_scale: float | None = None,
) -> tuple[SparseKernelCOO, torch.Tensor]:
    """Matrix-free COO sketch from rank-1 probabilities ``p_ij = ra_i rb_j``.

    The Poissonized eq. (7): multiplicities ``N_ij ~ Poisson(s ra_i rb_j)``
    drawn as per-row totals plus inverse-CDF columns, each drawn copy
    weighted ``K_ij / (s ra_i rb_j)``, so ``E[K~_ij] = K_ij`` entry-wise.
    Kernel and cost values come from ``entries_fn(rows, cols) -> (K_e, C_e)``.

    With ``thin_scale = 1/(2 lam + eps)`` the draw covers eq. (11): the
    rank-1 ``(a_i b_j)^{lam/(2lam+eps)}`` proposal (as ``ra``/``rb``) is
    thinned by the acceptance ``exp(-C_ij thin_scale)``, evaluated in log
    space, and kept copies are reweighted by the known rate.

    Returns ``(sketch, C_e)`` with the raw costs index-aligned to the sketch.
    Rows come out sorted, duplicates merged, zero slots compacted behind
    ``nnz``.
    """
    n, m = ra.shape[0], rb.shape[0]
    rows, cols, valid, total = _draw(generator, ra, rb, s, cap)
    k_e, c_e = entries_fn(rows, cols)
    rate = s * ra[rows] * rb[cols]  # E[multiplicity] per drawn entry
    if thin_scale is not None:
        # the acceptance test and weight in log space: log U < -C thin_scale
        # cannot flush to `U < 0` when exp(-C thin_scale) underflows
        log_acc = -c_e * thin_scale  # blocked (C = +inf) -> -inf, rejected
        u_acc = torch.rand(cap, dtype=rb.dtype, device=rb.device, generator=generator)
        valid = valid & (torch.log(u_acc) < log_acc)
        alive = valid & (k_e > 0)
        logw = (
            torch.log(torch.where(alive, k_e, 1.0))
            - torch.log(torch.clamp_min(rate, 1e-300))
            - log_acc
        )
        vals = torch.where(alive, torch.exp(logw), 0.0)
    else:
        vals = torch.where(valid, k_e / torch.clamp_min(rate, 1e-300), 0.0)
    n_accepted = torch.sum(vals != 0)  # alive before the merge
    rows, cols, vals, c_e, nz = _merge_and_compact(
        rows, cols, vals, c_e, m, lambda w: w != 0, segment_sum, 0.0
    )
    cols = torch.where(nz, cols, m - 1)
    sk = SparseKernelCOO(
        torch.where(nz, rows, n - 1),
        cols,
        vals,
        torch.sum(nz),
        n,
        m,
        csort=torch.argsort(cols, stable=True),
        overflowed=total > cap,
        n_proposed=total,
        n_accepted=n_accepted,
    )
    return sk, c_e


def sparsify_coo_mf_log(
    generator: torch.Generator,
    ra: torch.Tensor,
    rb: torch.Tensor,
    s: float,
    cap: int,
    cost_entries_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    eps: float,
    *,
    thin_scale: float | None = None,
) -> tuple[LogSparseKernelCOO, torch.Tensor]:
    """Log-space matrix-free COO sketch: `sparsify_coo_mf`'s draw carrying
    ``logvals = -C_e/eps - log rate_e`` from raw costs only
    (``cost_entries_fn(rows, cols) -> C_e``), so ``exp(-C/eps)`` is never
    evaluated. UOT thinning runs in log space; duplicates merge by
    segment-logsumexp. Returns ``(sketch, C_e)``."""
    n, m = ra.shape[0], rb.shape[0]
    rows, cols, valid, total = _draw(generator, ra, rb, s, cap)
    c_e = cost_entries_fn(rows, cols)
    lograte = (
        math.log(s)
        + torch.log(torch.clamp_min(ra[rows], 1e-300))
        + torch.log(torch.clamp_min(rb[cols], 1e-300))
    )
    if thin_scale is not None:
        log_acc = -c_e * thin_scale  # blocked (C = +inf) -> -inf, rejected
        u_acc = torch.rand(cap, dtype=rb.dtype, device=rb.device, generator=generator)
        valid = valid & (torch.log(u_acc) < log_acc)
        lograte = lograte + log_acc
    logvals = torch.where(valid, -c_e / eps - lograte, -math.inf)
    n_accepted = torch.sum(~torch.isneginf(logvals))  # alive before the merge
    rows, cols, logvals, c_e, nz = _merge_and_compact(
        rows, cols, logvals, c_e, m,
        lambda w: ~torch.isneginf(w), segment_logsumexp, -math.inf,
    )
    cols = torch.where(nz, cols, m - 1)
    sk = LogSparseKernelCOO(
        torch.where(nz, rows, n - 1),
        cols,
        logvals,
        torch.sum(nz),
        n,
        m,
        csort=torch.argsort(cols, stable=True),
        overflowed=total > cap,
        n_proposed=total,
        n_accepted=n_accepted,
    )
    return sk, c_e
