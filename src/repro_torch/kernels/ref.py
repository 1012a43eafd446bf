"""Plain PyTorch versions of the port's hand-written kernels.

Each ``*_ref`` computes what its kernel computes, with ordinary tensor ops.
The kernel wrappers in `repro_torch.kernels.ops` run these for CPU tensors,
and ``chip_smoke.py`` holds every kernel against its plain version on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import wfr_from_dist

__all__ = ["gathered_kernel_ref"]


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
    if cost == "sqeuclidean":
        c = sq
        return torch.exp(-c / eps), c
    if cost == "wfr":
        c, blocked = wfr_from_dist(torch.sqrt(sq + 1e-30), eta, cos_floor=1e-30)
        k = torch.where(blocked, 0.0, torch.exp(-c / eps))
        return k, torch.where(blocked, torch.inf, c)
    raise ValueError(f"unknown cost {cost!r}; available: sqeuclidean, wfr")
