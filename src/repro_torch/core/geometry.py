"""Ground costs and Gibbs kernels on torch tensors.

The port of ``repro.core.geometry``: the same formulas, on whatever device
the input tensors lie. The Wasserstein-Fisher-Rao (WFR) cost of the paper
(Section 2.2) is

    C_ij = -log( cos_+^2( d_ij / (2 eta) ) ),   cos_+(z) = cos(min(z, pi/2))

so ``d_ij >= pi * eta  =>  C_ij = +inf  =>  K_ij = 0``: transport is blocked
beyond range ``pi * eta``.
"""
from __future__ import annotations

import math

import torch

from repro_torch._device import resolve_device

__all__ = [
    "euclidean_cost",
    "gathered_cost",
    "gibbs_kernel",
    "grid_support_2d",
    "kernel_from_points",
    "log_gibbs_kernel",
    "normalize_cost",
    "squared_euclidean_cost",
    "wfr_cost",
    "wfr_from_dist",
]


def _pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(n,d),(m,d) -> (n,m)`` squared euclidean distances, clamped at 0."""
    x2 = torch.sum(x * x, dim=-1)[:, None]
    y2 = torch.sum(y * y, dim=-1)[None, :]
    return torch.clamp_min(x2 + y2 - 2.0 * (x @ y.T), 0.0)


def squared_euclidean_cost(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """``C_ij = ||x_i - y_j||_2^2`` (paper Section 5.1)."""
    return _pairwise_sqdist(x, x if y is None else y)


def euclidean_cost(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    return torch.sqrt(_pairwise_sqdist(x, x if y is None else y) + 1e-30)


def wfr_from_dist(
    d: torch.Tensor, eta: float, cos_floor: float = 1e-300
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distances -> (WFR cost ``-2 log cos_+(d/2eta)``, blocked mask).

    Callers put ``+inf`` on the blocked set. ``cos_floor=1e-30`` is the
    float32-safe clamp the gathered kernel uses."""
    z = d / (2.0 * eta)
    blocked = z >= (math.pi / 2.0)
    cosz = torch.cos(torch.clamp_max(z, math.pi / 2.0))
    return -2.0 * torch.log(torch.clamp_min(cosz, cos_floor)), blocked


def wfr_cost(
    x: torch.Tensor,
    y: torch.Tensor | None = None,
    *,
    eta: float = 1.0,
    d: torch.Tensor | None = None,
) -> torch.Tensor:
    """WFR ground cost from points (or precomputed distances ``d``);
    blocked entries (``d >= pi*eta``) come out ``+inf``."""
    if d is None:
        d = euclidean_cost(x, y)
    c, blocked = wfr_from_dist(d, eta)
    return torch.where(blocked, math.inf, c)


def gathered_cost(
    x: torch.Tensor,
    y: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    *,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
) -> torch.Tensor:
    """Entry-wise ground cost ``C[rows, cols]`` straight from support points,
    in O(k d) for k index pairs; blocked WFR entries come out ``+inf``."""
    xg, yg = x[rows], y[cols]
    sq = torch.clamp_min(
        torch.sum(xg * xg, dim=-1)
        + torch.sum(yg * yg, dim=-1)
        - 2.0 * torch.sum(xg * yg, dim=-1),
        0.0,
    )
    if cost == "sqeuclidean":
        return sq
    if cost == "euclidean":
        return torch.sqrt(sq + 1e-30)
    if cost == "wfr":
        c, blocked = wfr_from_dist(torch.sqrt(sq + 1e-30), eta)
        return torch.where(blocked, math.inf, c)
    raise ValueError(f"unknown cost {cost!r}")


def gibbs_kernel(cost: torch.Tensor, eps: float) -> torch.Tensor:
    """``K = exp(-C/eps)``; ``C = +inf`` maps to exactly 0."""
    return torch.where(torch.isinf(cost), 0.0, torch.exp(-cost / eps))


def log_gibbs_kernel(cost: torch.Tensor, eps: float) -> torch.Tensor:
    """``log K = -C/eps`` with ``-inf`` for blocked entries."""
    return torch.where(torch.isinf(cost), -math.inf, -cost / eps)


def normalize_cost(cost: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scale the finite part of a cost matrix to [0, 1]; returns (C', scale)."""
    finite = torch.where(torch.isinf(cost), 0.0, cost)
    scale = torch.clamp_min(torch.max(finite), 1e-30)
    return cost / scale, scale


def grid_support_2d(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-grid support points in [0,1]^2, row-major (image OT), on
    ``device`` (``None`` means ``"cuda"``, see `repro_torch._device`)."""
    dev = resolve_device(device)
    ys = (torch.arange(h, dtype=dtype, device=dev) + 0.5) / h
    xs = (torch.arange(w, dtype=dtype, device=dev) + 0.5) / w
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


def kernel_from_points(x: torch.Tensor, y: torch.Tensor, eps: float) -> torch.Tensor:
    """The squared-euclidean Gibbs kernel straight from support points."""
    return gibbs_kernel(squared_euclidean_cost(x, y), eps)
