"""Requests of the serving CLI's kind (``repro_torch.launch.serve_ot``'s
generator): points ``U(0,1)^d``, masses Dirichlet(1) on each side, a share
``uot_share`` of the requests UOT with masses scaled by ``mass_a`` and
``mass_b`` and penalty ``lam``, the rest balanced OT.

A pool holds the sizes of ``sizes`` in equal shares, and at each size the
same share of UOT. Which kind of problem sits at which place of the pool
is drawn once for every seed alike, so every seed serves the same work in
the same order; the seed draws the points and masses."""
from __future__ import annotations

import math

import torch

from perfbench.harness.inputs import SHARED, derive

__all__ = ["KEYS", "make"]

#: the configuration keys this pattern reads
KEYS = frozenset({"sizes", "d", "mass_a", "mass_b", "lam", "uot_share"})


def kinds(cfg: dict, count: int) -> list[tuple[int, bool]]:
    """``(size, uot)`` at each place of a pool of ``count``."""
    sizes = cfg["sizes"]
    per = count // len(sizes)
    uot = per * cfg["uot_share"]
    if per * len(sizes) != count or uot != int(uot):
        raise ValueError(f"a pool of {count} does not split evenly over {len(sizes)} sizes and a UOT share of "
                         f"{cfg['uot_share']}")
    table = [(n, k < uot) for n in sizes for k in range(per)]
    order = torch.randperm(len(table), generator=torch.Generator().manual_seed(derive(SHARED, "pool-order")))
    return [table[i] for i in order.tolist()]


def make(cfg: dict, count: int, device, gen: torch.Generator) -> list[dict]:
    pool = []
    for n, uot in kinds(cfg, count):
        x = torch.rand((n, cfg["d"]), dtype=torch.float64, device=device, generator=gen)
        a = -torch.log(torch.rand(n, dtype=torch.float64, device=device, generator=gen))
        b = -torch.log(torch.rand(n, dtype=torch.float64, device=device, generator=gen))
        a, b = a / a.sum(), b / b.sum()
        if uot:
            pool.append(dict(x=x, a=a * cfg["mass_a"], b=b * cfg["mass_b"], lam=float(cfg["lam"])))
        else:
            pool.append(dict(x=x, a=a, b=b, lam=math.inf))
    return pool
