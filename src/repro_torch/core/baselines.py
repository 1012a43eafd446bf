"""Competitor algorithms from the paper's experiments (Section 5).

The port of ``repro.core.baselines``:

* GREENKHORN (Altschuler et al., 2017): greedy single-row/col updates;
* NYS-SINK (Altschuler et al., 2019): Nystrom low-rank kernel + Sinkhorn;
* SCREENKHORN-lite: static screening, the reference's simplification of
  Alaya et al. (2019): the problem is restricted to the heaviest atoms of
  each marginal instead of solving the dual screening problem.

RAND-SINK is Spar-Sink with uniform probabilities (``method="rand_sink"``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.sinkhorn import SinkhornResult, generic_scaling_loop

__all__ = [
    "NystromKernel",
    "greenkhorn",
    "nys_sink",
    "nystrom_factors",
    "screenkhorn_lite",
]


# --------------------------------------------------------------------------
# Greenkhorn
# --------------------------------------------------------------------------


def _rho(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bregman violation ``rho(x, y) = y - x + x log(x/y)`` (>= 0)."""
    xpos, ypos = x > 0, y > 0
    logs = torch.log(torch.where(xpos, x, 1.0)) - torch.log(torch.where(ypos, y, 1.0))
    return y - x + torch.where(xpos & ypos, x * logs, 0.0)


def greenkhorn(K: torch.Tensor, a: torch.Tensor, b: torch.Tensor, n_updates: int, fe: float = 1.0) -> SinkhornResult:
    """Greedy Sinkhorn: ``n_updates`` single-coordinate scalings, each O(n).

    Each update scores every row and column by its Bregman violation
    `_rho` against the current marginals, takes the worst row ``i`` and the
    worst column ``j`` (the first on ties, as ``argmax`` does), and rescales
    row ``i`` if its violation is at least column ``j``'s, else column
    ``j``. ``fe = lam/(lam+eps)`` applies the unbalanced update one
    coordinate at a time and scores against its fixed point
    ``u_i^{1/fe} (K v)_i = a_i``.

    The rows and columns share one vector each (scalings ``u|v``, products
    ``Kv|K^T u``, marginals ``a|b``), so an update scores both sides in one
    pass and forms both candidate updates at once; ``torch.where`` keeps
    the chosen one, so the loop never waits for the host. The arithmetic of
    each entry is the reference's.
    """
    n, m = K.shape
    dev = a.device
    scal = torch.ones((n + m,), dtype=a.dtype, device=dev)  # u | v
    prod = torch.cat((K @ scal[n:], K.T @ scal[:n]))  # Kv | K^T u
    Kv, KTu = prod[:n], prod[n:]  # views: updated in place
    target = torch.cat((a, b))
    offset = torch.tensor([0, n], device=dev)
    for _ in range(n_updates):
        marg = scal * prod if fe == 1.0 else scal ** (1.0 / fe) * prod  # static branch
        viol = _rho(target, marg)
        ij = torch.stack((torch.argmax(viol[:n]), torch.argmax(viol[n:]))) + offset  # i, n + j
        worst = viol[ij]
        do_row = worst[0] >= worst[1]
        sums = prod[ij]
        live = sums > 0
        new = torch.where(live, target[ij] / torch.where(live, sums, 1.0), 0.0)
        if fe != 1.0:  # static: the balanced path computes no power
            new = new**fe
        old = scal[ij]
        chosen = torch.stack((do_row, ~do_row))
        scal.index_put_((ij,), torch.where(chosen, new, old))
        # the other side's product moves by the change times K's row i
        # (column j); the update not chosen adds an exact 0
        step = torch.where(chosen, new - old, 0.0)
        KTu.add_(step[0] * torch.index_select(K, 0, ij[:1])[0])
        Kv.add_(step[1] * torch.index_select(K, 1, ij[1:] - n)[:, 0])
    u, v = scal[:n], scal[n:]
    if fe == 1.0:
        err = torch.sum(torch.abs(u * Kv - a)) + torch.sum(torch.abs(v * KTu - b))
    else:  # the fixed-point residual in the same transformed coordinates
        err = torch.sum(torch.abs(u ** (1.0 / fe) * Kv - a)) + torch.sum(torch.abs(v ** (1.0 / fe) * KTu - b))
    return SinkhornResult(u, v, torch.tensor(n_updates, dtype=torch.int32, device=dev), err)


# --------------------------------------------------------------------------
# Nys-Sink
# --------------------------------------------------------------------------


class NystromKernel(NamedTuple):
    """``K ~ F @ G`` with ``F = K[:, S] W^+`` (n, r) and ``G = K[S, :]`` (r, m)."""

    F: torch.Tensor
    G: torch.Tensor

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(self.F @ (self.G @ v), 0.0)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(self.G.T @ (self.F.T @ u), 0.0)

    def dense(self) -> torch.Tensor:
        return torch.clamp_min(self.F @ self.G, 0.0)


def _nystrom_from_index(K: torch.Tensor, idx: torch.Tensor) -> NystromKernel:
    """The Nystrom factors of ``K`` on the landmark columns ``idx``; ``W^+``
    cuts singular values below 1e-10 of the largest."""
    Kr = K[:, idx]  # (n, r)
    W = Kr[idx, :]  # (r, r)
    return NystromKernel(Kr @ torch.linalg.pinv(W, rtol=1e-10), Kr.T)


def nystrom_factors(generator: torch.Generator, K: torch.Tensor, r: int) -> NystromKernel:
    """Uniform column Nystrom on ``r`` distinct landmarks drawn from
    ``generator``. It needs a (near-)PSD ``K``: the limitation the paper
    exploits (WFR kernels are sparse and near full rank, so Nystrom fails
    there). The products clamp at 0, so Sinkhorn stays iterable where the
    low-rank approximation goes slightly negative."""
    idx = torch.randperm(K.shape[0], generator=generator, device=K.device)[:r]
    return _nystrom_from_index(K, idx)


def nys_sink(
    generator: torch.Generator,
    K: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    r: int,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    fe: float = 1.0,
) -> tuple[SinkhornResult, NystromKernel]:
    """Sinkhorn on the rank-``r`` Nystrom approximation of ``K``."""
    nk = nystrom_factors(generator, K, r)
    return generic_scaling_loop(nk.matvec, nk.rmatvec, a, b, fe, tol=tol, max_iter=max_iter), nk


# --------------------------------------------------------------------------
# Screenkhorn-lite
# --------------------------------------------------------------------------


def screenkhorn_lite(
    K: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    decimation: int = 3,
    tol: float = 1e-6,
    max_iter: int = 1000,
    fe: float = 1.0,
    renormalize: bool = True,
) -> tuple[SinkhornResult, torch.Tensor, torch.Tensor]:
    """Active-set screening: keep the ``n/decimation`` heaviest atoms of each
    marginal (ties in index order: a stable sort), solve the restricted
    problem, leave the screened-out scalings at 0.

    For unbalanced problems pass ``fe = lam/(lam+eps)`` and
    ``renormalize=False`` (the marginal masses are data, not constraints).
    Returns ``(result on full-size vectors, active rows, active cols)``; the
    restricted solve's status carries over.
    """
    n, m = K.shape
    rows = torch.argsort(-a, stable=True)[: max(1, n // decimation)]
    cols = torch.argsort(-b, stable=True)[: max(1, m // decimation)]
    a_r, b_r = a[rows], b[cols]
    if renormalize:  # the kept mass, renormalized, makes a balanced problem
        a_r, b_r = a_r / torch.sum(a_r), b_r / torch.sum(b_r)
    K_r = K[rows][:, cols]
    res = generic_scaling_loop(lambda v: K_r @ v, lambda u: K_r.T @ u, a_r, b_r, fe, tol=tol, max_iter=max_iter)
    u = torch.zeros((n,), dtype=a.dtype, device=a.device)
    v = torch.zeros((m,), dtype=b.dtype, device=b.device)
    u[rows], v[cols] = res.u, res.v
    return SinkhornResult(u, v, res.n_iter, res.err, res.status), rows, cols
