"""The control: the reference put in the program's place, one precision down.

The configurations state float64 points, masses, scalings and values,
float32 sketched kernel entries in the scaling domain (the gathered
kernel's arithmetic) and float64 costs in the log domain. The control
draws its own eq. (7) sketch from the same inputs and solves it with the
reference's loops, with each of those one step lower: the scaling
domain's kernel entries in bfloat16 and everything else in float32; the
log domain's costs and loop in float32. `judge` must find it not correct;
`perfbench/calibrate.py --control` reads it on the card.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.spar_sink import (
    Estimate,
    Inputs,
    log_rates,
    objective,
    proposal,
    sinkhorn_log,
    sinkhorn_scaling,
    sq_costs,
)

__all__ = ["control_estimate"]


def control_estimate(inp: Inputs, generator: torch.Generator, domain: str, tol: float, max_iter: int) -> Estimate:
    low = Inputs(inp.x.float(), inp.a.float(), inp.b.float(), inp.eps, inp.lam, inp.s)
    n = low.a.shape[0]
    ra, rb, thin = proposal(low)
    counts = torch.poisson(inp.s * ra, generator=generator).long()
    rows = torch.repeat_interleave(torch.arange(n, device=ra.device), counts)
    u = torch.rand(rows.shape[0], dtype=rb.dtype, device=rb.device, generator=generator)
    cols = torch.clamp_max(torch.searchsorted(torch.cumsum(rb, 0), u, right=True), n - 1)
    if thin is not None:
        c = sq_costs(low.x, low.x, rows, cols)
        keep = torch.log(torch.rand(rows.shape[0], dtype=rb.dtype, device=rb.device, generator=generator)) < -c * thin
        rows, cols = rows[keep], cols[keep]
    pairs, mult = torch.unique(rows * n + cols, return_counts=True)
    rows, cols = pairs // n, pairs % n
    costs = sq_costs(low.x, low.x, rows, cols)
    logk = torch.log(mult.float()) + log_rates(low, rows, cols, costs)
    if domain == "scaling":
        logk = torch.log(torch.exp(logk).to(torch.bfloat16).float())
    loop = sinkhorn_log if domain == "log" else sinkhorn_scaling
    f, g = loop(rows, cols, logk, low, tol, max_iter)
    value = objective(rows, cols, logk, costs, f, g, low)
    logt = logk + f[rows] / inp.eps + g[cols] / inp.eps
    plan = torch.where(torch.isfinite(logt), torch.exp(logt), 0.0)
    keep = plan > 0
    return Estimate(rows[keep], cols[keep], plan[keep].double(), f.double(), g.double(),
                    value if math.isfinite(value) else math.nan, domain, tol, max_iter)
