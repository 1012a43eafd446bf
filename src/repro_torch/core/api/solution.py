"""`Solution`: the uniform return type of `solve()`.

* ``.value``        entropic objective estimate (OT_eps / UOT_{lam,eps})
* ``.potentials``   dual potentials ``(f, g)`` (converted from scalings
                    when the solver ran in the scaling domain)
* ``.scalings``     scaling vectors ``(u, v)``
* ``.marginals()``  row/col marginals of the plan; O(cap) on sketch solves
* ``.plan()``       lazy: a `SparsePlan` (O(cap)) for sketch solves, where
                    ``plan(dense=True)`` is the only way to an n x m array;
                    the dense solvers build their n x m plan on first access

* ``.diagnostics``  the `repro_torch.obs.Diagnostics` of a ``trace=True``
                    or ``certify=True`` solve (iteration trace, sketch
                    stats, certificate); ``None`` otherwise
* ``.certificate``  the `repro_torch.obs.Certificate` of a ``certify=True``
                    solve; ``None`` otherwise
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, NamedTuple

import torch

from repro_torch.core.sinkhorn import STATUS_CONVERGED, STATUS_LABELS, SinkhornResult
from repro_torch.core.sparsify import segment_sum, sorted_offsets
from repro_torch.obs.certify import Certificate
from repro_torch.obs.trace import Diagnostics, SketchStats

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.api.problems import OTProblem

__all__ = ["SparsePlan", "Solution"]


class SparsePlan(NamedTuple):
    """Transport plan restricted to the sampled sketch entries (padded COO,
    rows ascending). Entries beyond ``nnz`` are zero-valued padding parked
    at row ``n-1``, so every reduction below stays exact."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    nnz: torch.Tensor
    n: int
    m: int

    @property
    def cap(self) -> int:
        return self.rows.shape[0]

    def row_marginal(self) -> torch.Tensor:
        """``T~ 1`` in O(cap)."""
        return segment_sum(self.vals, sorted_offsets(self.rows, self.n))

    def col_marginal(self) -> torch.Tensor:
        """``T~^T 1`` in O(cap log cap): a stable sort by column, then the
        same sorted (deterministic) reduction."""
        order = torch.argsort(self.cols, stable=True)
        return segment_sum(self.vals[order], sorted_offsets(self.cols[order], self.m))

    def total_mass(self) -> torch.Tensor:
        return torch.sum(self.vals)

    def todense(self) -> torch.Tensor:
        """Explicit n x m materialization (the only densifying operation).
        Sketch entries are unique pairs, so the scatter writes each once."""
        dense = torch.zeros((self.n, self.m), dtype=self.vals.dtype, device=self.vals.device)
        keep = self.vals != 0
        dense[self.rows[keep], self.cols[keep]] = self.vals[keep]
        return dense


def _potentials_from_scalings(u, v, eps: float):
    """``(f, g) = eps log (u, v)`` with dead atoms (zero scalings) at ``-inf``."""
    f = torch.where(u > 0, eps * torch.log(torch.where(u > 0, u, 1.0)), -math.inf)
    g = torch.where(v > 0, eps * torch.log(torch.where(v > 0, v, 1.0)), -math.inf)
    return f, g


@dataclass(eq=False)
class Solution:
    """Uniform solver output; see the module docstring for the accessors."""

    method: str
    problem: "OTProblem"
    value: torch.Tensor
    result: SinkhornResult  # u/v scalings, or f/g potentials in the log domain
    domain: str = "scaling"  # "scaling" | "log"
    nnz: torch.Tensor | None = None  # realized sketch size (sparse solvers)
    #: the sketch draw exceeded its capacity and its tail was dropped (the
    #: estimate is then biased low: re-solve with a larger ``cap``)
    overflowed: torch.Tensor | None = None
    #: sketch-quality stats of a sketching solver's ``trace=True`` solve
    sketch_stats: SketchStats | None = None
    #: the quality certificate of a ``certify=True`` solve
    certificate: Certificate | None = None
    _plan_thunk: Callable[[], "SparsePlan | torch.Tensor"] | None = field(default=None, repr=False)
    _plan_cache: "SparsePlan | torch.Tensor | None" = field(default=None, repr=False, init=False)

    @property
    def scalings(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(u, v)`` with ``T = diag(u) K diag(v)``."""
        if self.domain == "log":
            eps = self.problem.eps
            return torch.exp(self.result.u / eps), torch.exp(self.result.v / eps)
        return self.result.u, self.result.v

    @property
    def potentials(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Dual potentials ``(f, g) = eps log (u, v)`` (``-inf`` on dead atoms)."""
        if self.domain == "log":
            return self.result.u, self.result.v
        return _potentials_from_scalings(self.result.u, self.result.v, self.problem.eps)

    @property
    def n_iter(self) -> torch.Tensor:
        return self.result.n_iter

    @property
    def err(self) -> torch.Tensor:
        return self.result.err

    @property
    def status(self) -> torch.Tensor | None:
        """Why the iteration stopped: a ``repro_torch.core.sinkhorn.STATUS_*`` code."""
        return self.result.status

    @property
    def converged(self) -> torch.Tensor | None:
        """True iff the stopping rule was met (``err <= tol``)."""
        s = self.result.status
        return None if s is None else s == STATUS_CONVERGED

    @property
    def status_label(self) -> str | None:
        """Readable status (reads the device scalar on the host)."""
        s = self.result.status
        return None if s is None else STATUS_LABELS[int(s)]

    @property
    def diagnostics(self) -> Diagnostics | None:
        """The per-solve observability record: the iteration trace, the
        sketch stats and the certificate; ``None`` unless the solve ran with
        ``trace=True`` or ``certify=True``."""
        tr = self.result.trace
        if tr is None and self.sketch_stats is None and self.certificate is None:
            return None
        return Diagnostics(
            trace=tr, n_iter=self.result.n_iter, status=self.result.status,
            sketch=self.sketch_stats, certificate=self.certificate,
        )

    def plan(self, dense: bool = False) -> "SparsePlan | torch.Tensor":
        """Lazy transport plan: a `SparsePlan` for sketch solves
        (``dense=True`` forces the n x m array), the n x m array otherwise,
        built on first access and cached."""
        if self._plan_cache is None:
            if self._plan_thunk is None:
                raise ValueError(f"solver {self.method!r} produced no plan")
            self._plan_cache = self._plan_thunk()
        p = self._plan_cache
        if dense and isinstance(p, SparsePlan):
            return p.todense()
        return p

    def marginals(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(T 1, T^T 1)``; O(cap) and densification-free on sketch solves."""
        p = self.plan()
        if isinstance(p, SparsePlan):
            return p.row_marginal(), p.col_marginal()
        return torch.sum(p, dim=1), torch.sum(p, dim=0)
