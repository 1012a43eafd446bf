"""Plain PyTorch versions of the port's hand-written kernels.

Each ``*_ref`` computes what its kernel computes, with ordinary tensor ops.
The kernel wrappers in `repro_torch.kernels.ops` run these for CPU tensors,
and ``chip_smoke.py`` holds every kernel against its plain version on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import gathered_cost, wfr_from_dist
from repro_torch.kernels.gather_kernel import packed_stride

__all__ = [
    "block_ell_matvec_ref",
    "block_ell_rmatvec_ref",
    "gathered_cost_ref",
    "gathered_kernel_ref",
    "linear_scan",
    "lru_scan_bwd_ref",
    "lru_scan_ref",
    "online_lse_ref",
    "online_matvec_ref",
    "packed_rows_ref",
]

#: elements of one (rows, m) block of the streaming plain versions
_BLOCK_ELEMS = 1 << 26


def gathered_kernel_ref(
    x: torch.Tensor,
    y: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    *,
    eps: float,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(K_e, C_e) = (exp(-C(x_i, y_j)/eps), C(x_i, y_j))`` at k index pairs,
    in float32 whatever the points' dtype (as the kernel computes), with the
    reference kernel's formula ``x^2 + y^2 - 2xy`` clamped at 0. WFR pairs
    beyond range (``d >= pi * eta``) come out exactly ``(0, +inf)``."""
    xg = x.to(torch.float32)[rows]
    yg = y.to(torch.float32)[cols]
    sq = torch.clamp_min(
        torch.sum(xg * xg, dim=-1)
        + torch.sum(yg * yg, dim=-1)
        - 2.0 * torch.sum(xg * yg, dim=-1),
        0.0,
    )
    c, blocked = _cost_from_sq(sq, cost, eta)
    k = torch.exp(-c / eps)
    if blocked is None:
        return k, c
    return torch.where(blocked, 0.0, k), torch.where(blocked, torch.inf, c)


def gathered_cost_ref(
    x: torch.Tensor,
    y: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    *,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
) -> torch.Tensor:
    """``C_e = C(x_i, y_j)`` at k index pairs in float64 whatever the points'
    dtype (as the cost-only kernel computes): the float64 formula of
    `repro_torch.core.geometry.gathered_cost`, blocked WFR pairs exactly
    ``+inf``."""
    return gathered_cost(x.to(torch.float64), y.to(torch.float64), rows, cols, cost=cost, eta=eta)


def packed_rows_ref(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The gathered kernels' packed layout of one point set ``(n, d)``:
    ``(n, packed_stride(d))`` rows in ``dtype`` holding the coordinates, the
    squared norm (summed in order t = 0..d-1) and zeros."""
    n, d = x.shape
    xc = x.to(dtype)
    out = torch.zeros((n, packed_stride(d)), dtype=dtype, device=x.device)
    out[:, :d] = xc
    norm = torch.zeros(n, dtype=dtype, device=x.device)
    for t in range(d):
        norm = norm + xc[:, t] * xc[:, t]
    out[:, d] = norm
    return out


def _cost_from_sq(sq: torch.Tensor, cost: str, eta: float):
    """Squared distances -> (ground cost, WFR blocked mask or ``None``), with
    the float32-safe cos clamp of the kernels."""
    if cost == "sqeuclidean":
        return sq, None
    if cost == "wfr":
        return wfr_from_dist(torch.sqrt(sq + 1e-30), eta, cos_floor=1e-30)
    raise ValueError(f"unknown cost {cost!r}; available: sqeuclidean, wfr")


def _cost_block(x: torch.Tensor, y: torch.Tensor, cost: str, eta: float):
    """``(r, d), (m, d) -> (r, m)`` ground costs and blocked mask, with the
    reference's formula ``x^2 + y^2 - 2xy`` clamped at 0."""
    x2 = torch.sum(x * x, dim=-1)[:, None]
    y2 = torch.sum(y * y, dim=-1)[None, :]
    return _cost_from_sq(torch.clamp_min(x2 + y2 - 2.0 * (x @ y.T), 0.0), cost, eta)


def _row_blocks(n: int, m: int, block_rows: int | None):
    rows = block_rows or max(1, _BLOCK_ELEMS // max(m, 1))
    return [(r0, min(r0 + rows, n)) for r0 in range(0, n, rows)]


def online_matvec_ref(
    x: torch.Tensor,
    y: torch.Tensor,
    v: torch.Tensor,
    *,
    eps: float,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
    block_rows: int | None = None,
) -> torch.Tensor:
    """``out_i = sum_j exp(-C(x_i, y_j)/eps) v_j`` in float32, K built in
    blocks of ``block_rows`` rows (by default about 2^26 entries a block),
    so that n = m = 2^17 fits on the card; WFR-blocked entries add 0."""
    xf, yf, vf = x.to(torch.float32), y.to(torch.float32), v.to(torch.float32)
    out = torch.empty(xf.shape[0], dtype=torch.float32, device=xf.device)
    for r0, r1 in _row_blocks(xf.shape[0], yf.shape[0], block_rows):
        c, blocked = _cost_block(xf[r0:r1], yf, cost, eta)
        k = torch.exp(-c / eps)
        if blocked is not None:
            k = torch.where(blocked, 0.0, k)
        out[r0:r1] = k @ vf
    return out


def online_lse_ref(
    x: torch.Tensor,
    y: torch.Tensor,
    g: torch.Tensor,
    *,
    eps: float,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
    block_rows: int | None = None,
) -> torch.Tensor:
    """``out_i = logsumexp_j(-C(x_i, y_j)/eps + g_j/eps)`` in float32, in
    blocks of rows as `online_matvec_ref`; WFR-blocked entries are ``-inf``,
    and a row with no finite term comes out as the ``-1e30`` sentinel."""
    xf, yf, gf = x.to(torch.float32), y.to(torch.float32), g.to(torch.float32)
    out = torch.empty(xf.shape[0], dtype=torch.float32, device=xf.device)
    for r0, r1 in _row_blocks(xf.shape[0], yf.shape[0], block_rows):
        c, blocked = _cost_block(xf[r0:r1], yf, cost, eta)
        z = -c / eps + gf[None, :] / eps
        if blocked is not None:
            z = torch.where(blocked, -torch.inf, z)
        out[r0:r1] = torch.logsumexp(z, dim=1)
    return torch.where(torch.isneginf(out), -1e30, out)


def block_ell_matvec_ref(
    vals: torch.Tensor, col_idx: torch.Tensor, v: torch.Tensor, row_ptr: torch.Tensor | None = None
) -> torch.Tensor:
    """``(ell_rows, maxb, Bk, Bk), (ell_rows, maxb), (ncb, Bk) -> (nrb, Bk)``:
    ``out[r] = sum_k vals[r, k] @ v[col_idx[r, k]]``, a gather and an einsum
    in float32 whatever the inputs' dtype (as the kernel computes). With
    ``row_ptr``, output row-block r is the sum over the ELL rows
    ``row_ptr[r]:row_ptr[r+1]`` (a sorted segment sum); without it, one ELL
    row per row-block."""
    gathered = v.to(torch.float32)[col_idx.long()]  # (ell_rows, maxb, Bk)
    out = torch.einsum("rkij,rkj->ri", vals.to(torch.float32), gathered)
    if row_ptr is None:
        return out
    return torch.segment_reduce(out, "sum", offsets=row_ptr.long(), axis=0, initial=0.0)


def block_ell_rmatvec_ref(vals: torch.Tensor, columns, u: torch.Tensor) -> torch.Tensor:
    """``K~^T u`` over the row layout's tiles ``(ell_rows, maxb, Bk, Bk)``
    through its column lists (`repro_torch.kernels.block_ell.BlockEllColumns`),
    with ``u`` ``(nrb, Bk)`` -> ``(ncb, Bk)``: ``out[c] = sum u[urow] @
    vals[tile]`` over column-block c's listed tiles, a gather, an einsum and
    a sorted segment sum in float32 whatever the inputs' dtype (as the
    kernel computes); a column-block with no tile comes out 0."""
    bk = vals.shape[-1]
    tiles = vals.reshape(-1, bk, bk)[columns.tile.long()].to(torch.float32)  # (T, Bk, Bk)
    ublocks = u.to(torch.float32)[columns.urow.long()]  # (T, Bk)
    contrib = torch.einsum("tij,ti->tj", tiles, ublocks)
    return torch.segment_reduce(contrib, "sum", offsets=columns.col_ptr.long(), axis=0, initial=0.0)


def _combine(e1, e2):
    """The associative operator of the recurrence h_t = a_t h_{t-1} + b_t:
    (a1, h1) then (a2, h2) is (a1 a2, h1 a2 + h2)."""
    a1, h1 = e1
    a2, h2 = e2
    return a1 * a2, h1 * a2 + h2


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a, b)`` under `_combine` along ``dim``: returns
    ``(prod_{s<=t} a_s, h_t)``. A log-depth doubling scan (ceil(log2 S)
    passes, each combining every element with the one ``2^k`` before it),
    the counterpart of ``jax.lax.associative_scan`` with the same operator;
    the two sum in different orders."""
    n = a.shape[dim]
    h = b
    d = 1
    while d < n:
        a_hi, h_hi = _combine((a.narrow(dim, 0, n - d), h.narrow(dim, 0, n - d)),
                              (a.narrow(dim, d, n - d), h.narrow(dim, d, n - d)))
        a = torch.cat([a.narrow(dim, 0, d), a_hi], dim)
        h = torch.cat([h.narrow(dim, 0, d), h_hi], dim)
        d *= 2
    return a, h


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` over (B, S, W) with ``h_{-1} = 0``, in
    float32: the doubling `linear_scan` along S (seconds at S = 32768 on
    the card, where a Python loop over S would take minutes)."""
    return linear_scan(a.to(torch.float32), b.to(torch.float32), 1)[1]


def lru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients ``(da, db)`` of `lru_scan_ref` at its input ``a`` and
    output ``h``, for the cotangent ``g`` of ``h``: the reverse recurrence
    ``lam_t = g_t + a_{t+1} lam_{t+1}`` (a flipped doubling scan), then
    ``da_t = lam_t h_{t-1}`` and ``db_t = lam_t``, in float32."""
    a, h, g = (t.to(torch.float32) for t in (a, h, g))
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    lam = torch.flip(lru_scan_ref(torch.flip(a_next, [1]), torch.flip(g, [1])), [1])
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return lam * h_prev, lam
