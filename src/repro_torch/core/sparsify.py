"""Importance sparsification of the Gibbs kernel (paper Sec. 3).

The ported parts of ``repro.core.sparsify``:

* the sampling probabilities: eq. (9) for OT, as row/col factors and
  dense; eq. (11) for UOT, in log space (also as normalized
  log-probabilities); uniform (Rand-Sink), dense or as row/col factors;
* the eq. (7) Bernoulli sketches of a dense kernel: `sparsify_dense` (a
  dense masked array), `sparsify_coo` (padded COO) and `sparsify_coo_log`
  (padded COO of ``logvals`` from raw costs). All three draw their keep
  mask from one `(n, m)` array of uniforms in ``p*``'s dtype
  (`_keep_mask`), so from one generator state they keep one support;
* the matrix-free factorized Poisson sketch (eq. 7 for the rank-1
  probabilities of eq. 9, with eq. 11 acceptance thinning for UOT), in the
  scaling domain (`SparseKernelCOO`) and in log space
  (`LogSparseKernelCOO`), and the sorted-COO reductions the Sinkhorn loops
  run on;
* the tile-granular sketch in block-ELL layout (`BlockEllKernel`): Poisson
  sampling of (Bk x Bk) tiles, stored with its transposed layout, and the
  block-ELL mat-vecs (on the card both read the row layout's tiles: ``K~^T
  u`` through the sketch's column lists).

Every reduction here is over **sorted** segments (rows, or columns through
the ``csort`` permutation) and goes through `torch.segment_reduce` with
offsets, never through ``index_add_``/``scatter_add_``: on CUDA those sum
with atomics in an order that changes from run to run, and the same inputs
must give the same result. The one ``index_add_`` (`block_ell_rmatvec`)
runs on CPU tensors only, where it is sequential; on CUDA ``K~^T u`` is a
kernel that adds each column-block's tiles in the same order, without
atomics.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core.sinkhorn import _masked_log
from repro_torch.kernels.block_ell import BlockEllColumns, column_lists

__all__ = [
    "BlockEllKernel",
    "LogSparseKernelCOO",
    "SparseKernelCOO",
    "block_ell_columns",
    "block_ell_matvec",
    "block_ell_rmatvec",
    "block_ell_to_dense",
    "block_ell_uniforms",
    "coo_lse_col",
    "coo_lse_row",
    "coo_matvec",
    "coo_rmatvec",
    "col_layout",
    "ot_sampling_prob_factors",
    "ot_sampling_probs",
    "ot_tile_probs",
    "row_offsets",
    "segment_logsumexp",
    "poisson_keep_probs",
    "segment_sum",
    "sorted_offsets",
    "sparsify_block_ell",
    "sparsify_block_ell_from_uniforms",
    "sparsify_coo",
    "sparsify_coo_log",
    "sparsify_coo_mf",
    "sparsify_coo_mf_log",
    "sparsify_dense",
    "tile_probs_from_elem",
    "uniform_prob_factors",
    "uniform_probs",
    "uot_sampling_logprobs",
    "uot_sampling_probs",
]


def ot_sampling_prob_factors(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row/col factors ``(ra, rb)`` with ``p_ij = ra_i * rb_j`` (eq. 9)."""
    sa, sb = torch.sqrt(a), torch.sqrt(b)
    return sa / torch.sum(sa), sb / torch.sum(sb)


def ot_sampling_probs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense eq. (9): ``p_ij = ra_i * rb_j``."""
    ra, rb = ot_sampling_prob_factors(a, b)
    return ra[:, None] * rb[None, :]


def uot_sampling_probs(a: torch.Tensor, b: torch.Tensor, logK: torch.Tensor, lam: float, eps: float) -> torch.Tensor:
    """Eq. (11), evaluated in log space. ``logK = -C/eps`` (``-inf`` = blocked,
    which gets probability exactly 0). Degenerates to eq. (9) as ``lam -> inf``."""
    c_ab = lam / (2.0 * lam + eps)
    c_k = eps / (2.0 * lam + eps)
    logp = c_ab * (_masked_log(a)[:, None] + _masked_log(b)[None, :]) + c_k * logK
    p = torch.exp(logp - torch.logsumexp(logp.reshape(-1), 0))
    return torch.where(torch.isneginf(logp), 0.0, p)


def uot_sampling_logprobs(a: torch.Tensor, b: torch.Tensor, cost: torch.Tensor, lam: float, eps: float) -> torch.Tensor:
    """Eq. (11) as normalized log-probabilities, from the raw cost (``+inf``
    = blocked): the kernel factor stays the exponent ``-C/(2lam+eps)``, so
    a small ``eps`` or ``lam`` flushes no probability to an exact zero
    before the sketch samples. `uot_sampling_probs` is its ``exp``."""
    c_ab = lam / (2.0 * lam + eps)
    logk_part = torch.where(torch.isinf(cost), -math.inf, -cost / (2.0 * lam + eps))
    logp = c_ab * (_masked_log(a)[:, None] + _masked_log(b)[None, :]) + logk_part
    return logp - torch.logsumexp(logp.reshape(-1), 0)


def uniform_probs(n: int, m: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Rand-Sink: every element equally likely, on ``device`` (``None``
    means ``"cuda"``, see `repro_torch._device`)."""
    return torch.full((n, m), 1.0 / (n * m), dtype=dtype, device=resolve_device(device))


def uniform_prob_factors(n: int, m: int, dtype=torch.float32, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Rand-Sink probabilities as row/col factors ``(fr, fc)``, ``p_ij = fr_i
    fc_j``, on ``device`` (``None`` means ``"cuda"``): the sketches broadcast
    them, so no (n, m) probability array is made."""
    dev = resolve_device(device)
    return (
        torch.full((n,), 1.0 / n, dtype=dtype, device=dev),
        torch.full((m,), 1.0 / m, dtype=dtype, device=dev),
    )


def poisson_keep_probs(probs, s: float) -> torch.Tensor:
    """``p*_ij = min(1, s p_ij)``, the inclusion probabilities of eq. (7);
    ``probs`` is an (n, m) array or an ``(fr, fc)`` factor pair."""
    if isinstance(probs, tuple):
        fr, fc = probs
        return torch.clamp_max(s * (fr[:, None] * fc[None, :]), 1.0)
    return torch.clamp_max(s * probs, 1.0)


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
# The eq. (7) Bernoulli sketches of a dense kernel
# --------------------------------------------------------------------------


def _keep_mask(generator: torch.Generator, p_star: torch.Tensor) -> torch.Tensor:
    """The draw every Bernoulli sketch shares: one uniform per entry, in
    ``p*``'s shape, dtype and device, and ``U < p*``."""
    return _uniforms(generator, p_star) < p_star


def _uniforms(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(like.shape, dtype=like.dtype, device=like.device, generator=generator)


def sparsify_dense(generator: torch.Generator, K: torch.Tensor, probs, s: float) -> torch.Tensor:
    """Dense ``K~``: ``K_ij / p*_ij`` with probability ``p*_ij``, else 0."""
    p_star = poisson_keep_probs(probs, s)
    keep = _keep_mask(generator, p_star)
    return torch.where(keep, K / torch.clamp_min(p_star, 1e-300), 0.0)


def _padded_support(keep: torch.Tensor, cap: int):
    """The first ``cap`` kept entries in row-major order as flat indices,
    padded with the last flat index ``n*m - 1`` (so padding parks at ``(n-1,
    m-1)`` and the rows stay ascending). Returns ``(flat_idx, valid,
    true_nnz)``; ``valid`` marks the slots that hold a kept entry."""
    n, m = keep.shape
    true_nnz = torch.sum(keep)
    flat_idx = torch.nonzero_static(keep.reshape(-1), size=cap, fill_value=n * m - 1)[:, 0]
    valid = torch.arange(cap, device=keep.device) < true_nnz
    return flat_idx, valid, true_nnz


def _coo_layout(cls, flat_idx, true_nnz, w, n: int, m: int):
    """A row-sorted padded COO sketch of class ``cls`` with weights ``w``
    at ``flat_idx``, its stable column sort and its draw accounting."""
    cap = flat_idx.shape[0]
    cols = flat_idx % m
    kept = torch.clamp_max(true_nnz, cap)
    return cls(
        flat_idx // m, cols, w, kept, n, m,
        csort=torch.argsort(cols, stable=True),
        overflowed=true_nnz > cap,
        n_proposed=true_nnz,
        n_accepted=kept,
    )


def sparsify_coo(generator: torch.Generator, K: torch.Tensor, probs, s: float, cap: int) -> SparseKernelCOO:
    """Padded COO sketch of eq. (7) with static capacity ``cap``: the draw
    of `sparsify_dense`, so the same generator state keeps the same
    entries. If the draw keeps more than ``cap``, the trailing entries (in
    row-major order) are dropped and ``overflowed`` is set. ``probs`` is an
    (n, m) array or an ``(fr, fc)`` factor pair."""
    n, m = K.shape
    p_star = poisson_keep_probs(probs, s)
    keep = _keep_mask(generator, p_star)
    flat_idx, valid, true_nnz = _padded_support(keep, cap)
    # each value is K / p* at its index, the same quotient as sparsify_dense
    vals = K.reshape(-1)[flat_idx] / torch.clamp_min(p_star.reshape(-1)[flat_idx], 1e-300)
    return _coo_layout(SparseKernelCOO, flat_idx, true_nnz, torch.where(valid, vals, 0.0), n, m)


def sparsify_coo_log(
    generator: torch.Generator,
    cost: torch.Tensor,
    probs,
    eps: float,
    s: float,
    cap: int,
    *,
    logprobs: torch.Tensor | None = None,
) -> tuple[LogSparseKernelCOO, torch.Tensor]:
    """Log-space padded COO sketch from the raw cost matrix, with
    ``logvals = -C_e/eps - log p*_e``; ``exp(-C/eps)`` is never formed.

    With linear ``probs`` the keep mask is `sparsify_coo`'s draw, so the
    same generator state keeps the same support. With ``logprobs``
    (normalized log-probabilities, e.g. `uot_sampling_logprobs`) the keep
    probabilities ``log p* = min(0, log s + log p)`` and the test ``log U <
    log p*`` stay in log space, on uniforms of the same shape and dtype.

    Returns ``(sketch, C_e)``: the gathered costs, index-aligned with the
    sketch (``+inf`` on padded slots).
    """
    n, m = cost.shape
    if logprobs is None:
        p_star = poisson_keep_probs(probs, s)
        keep = _keep_mask(generator, p_star)
        log_pstar = torch.log(torch.clamp_min(p_star, 1e-300))
    else:
        log_pstar = torch.clamp_max(math.log(s) + logprobs, 0.0)
        keep = torch.log(_uniforms(generator, log_pstar)) < log_pstar
    flat_idx, valid, true_nnz = _padded_support(keep, cap)
    c_e = torch.where(valid, cost.reshape(-1)[flat_idx], math.inf)
    logvals = torch.where(valid, -c_e / eps - log_pstar.reshape(-1)[flat_idx], -math.inf)
    return _coo_layout(LogSparseKernelCOO, flat_idx, true_nnz, logvals, n, m), c_e


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


# --------------------------------------------------------------------------
# Block-ELL sketch (tile-granular Poisson sampling)
# --------------------------------------------------------------------------


class BlockEllKernel(NamedTuple):
    """Per row-block a fixed-width list of kept (Bk x Bk) tiles, rescaled by
    ``1/p*_T``, with their column-block ids; padded slots are zero tiles with
    column id 0, so they add exact zeros.

    The rows of ``vals`` are ELL rows of ``max_blocks`` slots. Without
    ``row_ptr`` each row-block is one ELL row (the reference's layout). With
    it, row-block ``r`` is the consecutive ELL rows ``row_ptr[r]:row_ptr[r+1]``,
    so a row-block with more tiles than one row holds loses none: the
    transposed layout uses this for the column-blocks that many row-blocks
    share (rank-1 eq. 9 probabilities force every row-block's heaviest tile
    into the same column-block).
    """

    vals: torch.Tensor  # (ell_rows, max_blocks, Bk, Bk) rescaled kernel tiles (0-padded)
    col_idx: torch.Tensor  # (ell_rows, max_blocks) int32 column-block ids (0-padded)
    nblocks: torch.Tensor  # (ell_rows,) int32 valid slots per ELL row
    n: int
    m: int
    #: (n/Bk + 1,) int32 ELL-row offsets of the row-blocks; None: one ELL row each
    row_ptr: torch.Tensor | None = None
    #: the same sketch transposed (``K~^T`` in block-ELL layout, m/Bk
    #: row-blocks), for the CPU path, interop and the layout checks; no
    #: kernel reads it, so it gets no ``vals32`` or ``columns``
    transposed: "BlockEllKernel | None" = None
    #: float32 copy of ``vals`` that the CUDA kernels read, made once when a
    #: CUDA sketch is built (``None`` on the CPU)
    vals32: torch.Tensor | None = None
    #: the column lists (`repro_torch.kernels.block_ell.column_lists`) that
    #: ``K~^T u`` walks on CUDA, made with ``vals32`` (``None`` on the CPU)
    columns: BlockEllColumns | None = None

    @property
    def block(self) -> int:
        return self.vals.shape[-1]

    @property
    def max_blocks(self) -> int:
        return self.vals.shape[1]

    def row_blocks_of_ell_rows(self) -> torch.Tensor:
        """The row-block of each ELL row."""
        nrb = self.n // self.block
        ids = torch.arange(nrb, device=self.vals.device)
        if self.row_ptr is None:
            return ids
        return torch.repeat_interleave(ids, torch.diff(self.row_ptr.long()), output_size=self.vals.shape[0])


def ot_tile_probs(a: torch.Tensor, b: torch.Tensor, bk: int) -> torch.Tensor:
    """Tile-aggregated eq. (9) probabilities in O(n), exact because eq. (9)
    factorizes: ``p_T = (sum_{i in T} ra_i) (sum_{j in T} rb_j)``."""
    ra, rb = ot_sampling_prob_factors(a, b)
    ta = torch.sum(ra.reshape(-1, bk), dim=1)
    tb = torch.sum(rb.reshape(-1, bk), dim=1)
    return ta[:, None] * tb[None, :]


def tile_probs_from_elem(probs: torch.Tensor, bk: int) -> torch.Tensor:
    """Tile aggregation of arbitrary element probabilities (the UOT eq. 11 path)."""
    n, m = probs.shape
    return probs.reshape(n // bk, bk, m // bk, bk).sum(dim=(1, 3))


def _tile_keep_probs(tile_probs: torch.Tensor, s: float, bk: int, ensure: bool) -> torch.Tensor:
    """``p*_T = min(1, (s/Bk^2) p_T)``; with ``ensure``, the heaviest tile of
    every row-block gets ``p*_T = 1``, and the k-th heaviest column-block is
    forced in at the (k mod nrb)-th heaviest row-block (eq. 9 tile
    probabilities are rank-1, so every column's own argmax is one row). Still
    exactly unbiased; no row- or column-block of the sketch is empty."""
    p_star = torch.clamp_max((s / float(bk * bk)) * tile_probs, 1.0)
    if ensure:
        nrb, ncb = tile_probs.shape
        dev = tile_probs.device
        p_star[torch.arange(nrb, device=dev), torch.argmax(tile_probs, dim=1)] = 1.0
        # the reference sorts with jnp.argsort, which is stable: tied masses
        # (uniform weights) must keep index order here too
        row_order = torch.argsort(-torch.sum(tile_probs, dim=1), stable=True)
        col_order = torch.argsort(-torch.sum(tile_probs, dim=0), stable=True)
        p_star[row_order[torch.arange(ncb, device=dev) % nrb], col_order] = 1.0
    return p_star


def block_ell_uniforms(generator: torch.Generator, shape: tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
    """The sketch's random draw: one uniform per tile, ``(nrb, ncb)``, from
    ``generator`` on its device (tile T is kept iff its uniform < ``p*_T``)."""
    return torch.rand(shape, dtype=dtype, device=generator.device, generator=generator)


def _ell_from_mask(mask, probs, tiles, scale, width: int, *, split: bool):
    """Lay the kept tiles of each row of ``mask`` into ELL rows of ``width``
    slots, the most important first (ties in index order), each slot's tile
    rescaled by ``scale``; slots past the kept count hold zero tiles with
    column id 0. Without ``split`` every row is one ELL row and drops the
    tiles past ``width`` (the reference's rule); with it a row takes as many
    ELL rows as its tiles fill. Returns ``(vals, col_idx, nblocks, row_ptr,
    kept)``: ``row_ptr`` is None when every row is one ELL row, and ``kept``
    marks the tiles that got a slot."""
    nrows, ncols = mask.shape
    dev = mask.device
    counts = torch.sum(mask, dim=1)
    order = torch.argsort(-torch.where(mask, probs, -1.0), dim=1, stable=True)
    per_row = torch.clamp_min(-(-counts // width), 1) if split else torch.ones_like(counts)
    owner = torch.repeat_interleave(torch.arange(nrows, device=dev), per_row)  # ELL row -> row
    first = torch.cumsum(per_row, 0) - per_row
    rank0 = (torch.arange(owner.shape[0], device=dev) - first[owner]) * width
    ranks = rank0[:, None] + torch.arange(width, device=dev)[None, :]
    valid = ranks < counts[owner][:, None]
    ci = torch.where(valid, torch.gather(order[owner], 1, torch.clamp_max(ranks, ncols - 1)), 0)
    rows = owner[:, None].expand_as(ci)
    vals = torch.where(
        valid[:, :, None, None], tiles[rows, ci] * scale[rows, ci][:, :, None, None], 0.0
    )
    kept = torch.zeros_like(mask)
    kept[rows[valid], ci[valid]] = True
    nblocks = torch.clamp(counts[owner] - rank0, 0, width).to(torch.int32)
    row_ptr = None
    if owner.shape[0] != nrows:
        row_ptr = torch.cat([per_row.new_zeros(1), torch.cumsum(per_row, 0)]).to(torch.int32)
    return vals, ci.to(torch.int32), nblocks, row_ptr, kept


def _for_cuda(sk: BlockEllKernel) -> BlockEllKernel:
    """A CUDA sketch gets, once, what its kernels read: the float32 tiles,
    int32 column ids and valid counts, and the column lists of ``K~^T u``;
    and the checks that depend on the sketch alone run here, once, not at
    each launch: ``row_ptr`` is a non-decreasing cover of the ELL rows,
    every valid count lies in ``[0, max_blocks]``, every valid slot's
    column id in ``[0, m/Bk)``, and every slot past the valid ones holds a
    zero tile with column id 0, so that ``K~ v``, which reads the valid
    slots only, gives the sums of the walk over every slot (else
    `IndexError`). CPU sketches come back as they are."""
    if sk.vals.device.type != "cuda":
        return sk
    ell_rows = sk.vals.shape[0]
    if sk.row_ptr is not None:
        rp = sk.row_ptr.long()
        if not (rp.shape[0] == sk.n // sk.block + 1 and int(rp[0]) == 0 and int(rp[-1]) == ell_rows
                and bool((torch.diff(rp) >= 0).all())):
            raise IndexError(f"row_ptr is not a non-decreasing cover of the {ell_rows} ELL rows")
    vals32 = sk.vals.to(torch.float32).contiguous()
    sk = sk._replace(col_idx=sk.col_idx.to(torch.int32).contiguous(), nblocks=sk.nblocks.to(torch.int32).contiguous())
    _check_padding(sk, vals32)
    return sk._replace(vals32=vals32, columns=block_ell_columns(sk))


def _check_padding(sk: BlockEllKernel, vals32: torch.Tensor) -> None:
    """`IndexError` unless ``sk.nblocks`` holds one count in ``[0,
    max_blocks]`` for each ELL row and every slot past an ELL row's valid
    ones holds a zero tile (in ``vals32``) with column id 0: the layout on
    which ``K~ v`` over the valid slots alone gives the sums of the walk
    over every slot."""
    nb, ell_rows = sk.nblocks, sk.vals.shape[0]
    if nb.shape != (ell_rows,) or bool(((nb < 0) | (nb > sk.max_blocks)).any()):
        raise IndexError(f"nblocks is not one count in [0, {sk.max_blocks}] for each of the {ell_rows} ELL rows")
    pad = torch.arange(sk.max_blocks, device=nb.device)[None, :] >= nb[:, None]
    if bool((sk.col_idx[pad] != 0).any()) or bool((vals32.reshape(*pad.shape, -1).abs().amax(-1)[pad] != 0).any()):
        raise IndexError("a slot past an ELL row's valid ones holds a column id other than 0 or a nonzero tile")


def block_ell_columns(sk: BlockEllKernel) -> BlockEllColumns:
    """The column lists of the layout ``sk`` that ``K~^T u`` walks on CUDA
    (`repro_torch.kernels.block_ell.column_lists`), on its device."""
    return column_lists(sk.col_idx, sk.nblocks, sk.row_blocks_of_ell_rows(), sk.m // sk.block)


def sparsify_block_ell_from_uniforms(
    uniforms: torch.Tensor,
    K: torch.Tensor,
    tile_probs: torch.Tensor,
    s: float,
    bk: int,
    max_blocks: int,
    ensure_rows: bool = True,
) -> BlockEllKernel:
    """The block-ELL sketch of ``K`` for a given draw ``uniforms`` (one per
    tile, as `block_ell_uniforms` makes them): tile T is kept iff
    ``uniforms_T < p*_T = min(1, (s/Bk^2) p_T)`` and rescaled by ``1/p*_T``,
    the tile-granular analogue of eq. (7), unbiased for the same reason.
    ``s`` is the element budget; ``s/Bk^2`` is the tile budget.

    A row-block with more than ``max_blocks`` kept tiles drops the least
    important ones, as in the reference. The transposed layout
    (``.transposed``) holds exactly the tiles of the row layout: a
    column-block with more than ``max_blocks`` of them spans several ELL
    rows (``row_ptr``), where the reference's ``sparsify_block_ell_pair``
    drops the excess. Where no column-block overflows, both layouts equal
    the reference's pair for the same draw.
    """
    n, m = K.shape
    nrb, ncb = n // bk, m // bk
    p_star = _tile_keep_probs(tile_probs, s, bk, ensure_rows)
    keep = uniforms < p_star
    scale = 1.0 / torch.clamp_min(p_star, 1e-300)
    tiles = K.reshape(nrb, bk, ncb, bk).permute(0, 2, 1, 3)  # (nrb, ncb, Bk, Bk)
    vals, ci, nb, _, kept = _ell_from_mask(keep, tile_probs, tiles, scale, max_blocks, split=False)
    vals_t, ci_t, nb_t, ptr_t, _ = _ell_from_mask(
        kept.T, tile_probs.T, tiles.permute(1, 0, 3, 2), scale.T, max_blocks, split=True
    )
    transposed = BlockEllKernel(vals_t, ci_t, nb_t, m, n, row_ptr=ptr_t)
    return _for_cuda(BlockEllKernel(vals, ci, nb, n, m, transposed=transposed))


def sparsify_block_ell(
    generator: torch.Generator,
    K: torch.Tensor,
    tile_probs: torch.Tensor,
    s: float,
    bk: int,
    max_blocks: int,
    ensure_rows: bool = True,
) -> BlockEllKernel:
    """Poisson-sample (Bk x Bk) tiles of ``K`` with ``generator``: the draw of
    `block_ell_uniforms`, then `sparsify_block_ell_from_uniforms`. The
    sketch carries its transposed layout, so it stands for the reference's
    ``sparsify_block_ell_pair`` as well."""
    uniforms = block_ell_uniforms(generator, tuple(tile_probs.shape), tile_probs.dtype)
    return sparsify_block_ell_from_uniforms(uniforms, K, tile_probs, s, bk, max_blocks, ensure_rows)


def block_ell_matvec(sk: BlockEllKernel, v: torch.Tensor, bad_index: torch.Tensor | None = None) -> torch.Tensor:
    """``K~ v``: gather v-blocks by column id, one (Bk x Bk) @ (Bk,) per slot,
    summed over each row-block's slots.

    CPU sketches run the reference's gather + einsum in ``v``'s dtype (and
    a sorted segment sum over the ELL rows of a row-block, where it has
    several). CUDA sketches launch the block-ELL kernel on the float32 tiles
    and the valid slots alone (`repro_torch.kernels.ops.block_ell_sketch_matvec`
    with ``nblocks``: the sums of every slot's walk), which reads ``v``
    and writes the output in ``v``'s dtype and sums in float32; the kernel
    sets ``bad_index`` (a zeroed (1,) int32 tensor) on an index out of
    range, or, without one, the call raises `IndexError`.
    """
    if sk.vals.device.type == "cuda":
        from repro_torch.kernels.ops import block_ell_sketch_matvec

        return block_ell_sketch_matvec(_cuda_part(sk, "vals32"), sk.col_idx, v, sk.row_ptr, bad_index, sk.nblocks)
    bk = sk.block
    gathered = v.reshape(sk.m // bk, bk)[sk.col_idx.long()]  # (ell_rows, max_blocks, Bk)
    out = torch.einsum("rkij,rkj->ri", sk.vals, gathered)
    if sk.row_ptr is not None:
        out = torch.segment_reduce(out, "sum", offsets=sk.row_ptr.long(), axis=0, initial=0.0)
    return out.reshape(sk.n)


def _cuda_part(sk: BlockEllKernel, name: str):
    """The CUDA-only field ``name`` of a sketch, which `sparsify_block_ell`
    and `repro_torch.interop.block_ell_sketch_from_numpy` make."""
    part = getattr(sk, name)
    if part is None:
        raise ValueError(f"this CUDA sketch has no {name}: build it with sparsify_block_ell[_from_uniforms] "
                         "or interop.block_ell_sketch_from_numpy")
    return part


def block_ell_rmatvec(sk: BlockEllKernel, u: torch.Tensor, bad_index: torch.Tensor | None = None) -> torch.Tensor:
    """``K~^T u``: the reference's per-tile ``(Bk,) @ (Bk x Bk)``, added
    into column blocks in the order of row-block, then slot. CPU sketches
    run it in ``u``'s dtype with a sequential ``index_add_``. CUDA sketches
    launch the kernel that reads the same float32 tiles as `block_ell_matvec`
    through the sketch's column lists and adds each column-block's tiles in
    that order, in float32, without atomics
    (`repro_torch.kernels.ops.block_ell_sketch_rmatvec`); dtypes and
    ``bad_index`` as `block_ell_matvec`."""
    if sk.vals.device.type == "cuda":
        from repro_torch.kernels.ops import block_ell_sketch_rmatvec

        return block_ell_sketch_rmatvec(_cuda_part(sk, "vals32"), _cuda_part(sk, "columns"), u, bad_index)
    bk = sk.block
    ublocks = u.reshape(sk.n // bk, bk)[sk.row_blocks_of_ell_rows()]
    contrib = torch.einsum("rkij,ri->rkj", sk.vals, ublocks)
    out = torch.zeros((sk.m // bk, bk), dtype=contrib.dtype, device=contrib.device)
    out.index_add_(0, sk.col_idx.reshape(-1).long(), contrib.reshape(-1, bk))
    return out.reshape(sk.m)


def block_ell_to_dense(sk: BlockEllKernel) -> torch.Tensor:
    """Densify: each valid slot's tile is written once (the valid column ids
    of a row-block are distinct), so the result is the same on every device
    and every run."""
    bk = sk.block
    nrb, ncb = sk.n // bk, sk.m // bk
    dense = torch.zeros((nrb, ncb, bk, bk), dtype=sk.vals.dtype, device=sk.vals.device)
    valid = torch.arange(sk.max_blocks, device=sk.vals.device)[None, :] < sk.nblocks[:, None]
    rows = sk.row_blocks_of_ell_rows()[:, None].expand_as(sk.col_idx)
    dense[rows[valid], sk.col_idx[valid].long()] = sk.vals[valid]
    return dense.permute(0, 2, 1, 3).reshape(sk.n, sk.m)
