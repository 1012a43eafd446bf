"""Pattern C1 of arXiv:2306.06581 Sec. 5.1: ``a``, ``b`` empirical
N(1/3, 1/20) and N(1/2, 1/20) over the index grid, points ``x ~
U(0,1)^d``, one support for both sides; balanced OT. The masses do not
depend on the seed, so the problems differ in their points only."""
from __future__ import annotations

import math

import torch

__all__ = ["KEYS", "make"]

#: the configuration keys this pattern reads
KEYS = frozenset({"n", "d"})


def _gauss_hist(n: int, loc: float, scale: float, device) -> torch.Tensor:
    """The paper's Gaussian-shaped histogram over the index grid (the POT
    ``make_1D_gauss`` convention), float64, with a floor of 1e-12."""
    t = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    w = torch.exp(-0.5 * ((t - loc) / scale) ** 2) + 1e-12
    return w / w.sum()


def make(cfg: dict, count: int, device, gen: torch.Generator) -> list[dict]:
    n, d = cfg["n"], cfg["d"]
    a, b = _gauss_hist(n, 1 / 3, 1 / 20, device), _gauss_hist(n, 1 / 2, 1 / 20, device)
    return [dict(x=torch.rand((n, d), dtype=torch.float64, device=device, generator=gen), a=a, b=b, lam=math.inf)
            for _ in range(count)]
