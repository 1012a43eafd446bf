"""Sinkhorn divergence (paper eq. 38, the SSAE application):
``S(α, β) = OT_eps(α, β) - 1/2 (OT_eps(α, α) + OT_eps(β, β))``.

The port of ``repro.core.divergence``. All three OT_eps terms go through
``solve(problem, method=...)``, so the divergence inherits each method's
cost: with ``method="spar_sink_coo"`` every term is O(s) and no term forms
a dense plan.
"""
from __future__ import annotations

import torch

from repro_torch._device import as_tensor, make_generator
from repro_torch.core.api import Geometry, OTProblem, solve
from repro_torch.core.api.registry import method_accepts

__all__ = ["sinkhorn_divergence", "spar_sink_divergence"]


def sinkhorn_divergence(
    x,
    y,
    a,
    b,
    eps: float,
    *,
    method: str = "dense",
    generator: torch.Generator | None = None,
    seed: int | None = None,
    tol: float = 1e-6,
    max_iter: int = 500,
    with_status: bool = False,
    **opts,
):
    """``S(α, β)`` with every OT_eps term solved by the registered ``method``.

    ``x``, ``y``, ``a``, ``b`` follow the port's device rule (tensors stay
    where they are, arrays go to the card). Sketching methods need ``s``
    (in ``opts``) and a random source, ``generator`` or ``seed`` (a
    generator on ``x``'s device): the one generator feeds the three solves
    in order, xy, xx, yy. A random source given to a deterministic method is
    ignored.

    ``with_status=True`` returns ``(value, status)``, ``status`` the worst
    ``STATUS_*`` code of the three solves (the codes are ordered by
    severity, so one non-converged term taints the divergence); ``None`` if
    the method reports no status.
    """
    x = as_tensor(x)
    rng = {}
    if (generator is not None or seed is not None) and method_accepts(method, "generator"):
        rng = {"generator": make_generator(x.device, generator, seed)}
    # forward only the common options the solver understands (greenkhorn is
    # budgeted by n_updates, not tol/max_iter)
    common = {k: v for k, v in (("tol", tol), ("max_iter", max_iter)) if method_accepts(method, k)}

    def term(pts_a, pts_b, wa, wb):
        problem = OTProblem(Geometry.from_points(pts_a, pts_b, device=x.device), wa, wb, eps, device=x.device)
        sol = solve(problem, method=method, **common, **rng, **opts)
        return sol.value, sol.status

    sxy, st_xy = term(x, y, a, b)
    sxx, st_xx = term(x, x, a, a)
    syy, st_yy = term(y, y, b, b)
    value = sxy - 0.5 * (sxx + syy)
    if not with_status:
        return value
    statuses = [s for s in (st_xy, st_xx, st_yy) if s is not None]
    status = None
    if statuses:
        status = statuses[0]
        for s in statuses[1:]:
            status = torch.maximum(status, s)
    return value, status


def spar_sink_divergence(
    x,
    y,
    a,
    b,
    eps: float,
    s: float,
    *,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    tol: float = 1e-6,
    max_iter: int = 500,
):
    """The Spar-Sink divergence: ``spar_sink_coo`` for every term, O(s)
    each; the random source is ``generator`` or ``seed``."""
    if generator is None and seed is None:
        raise TypeError("pass exactly one of generator= (a torch.Generator) or seed=")
    return sinkhorn_divergence(
        x, y, a, b, eps, method="spar_sink_coo", generator=generator, seed=seed, s=s,
        tol=tol, max_iter=max_iter,
    )
