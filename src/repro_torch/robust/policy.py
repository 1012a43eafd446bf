"""Escalation policy and the `RobustSolution` attempt record.

The port of ``repro.robust.policy`` (host-side Python, no tensor code).

`EscalationPolicy` is the deterministic knob set of the self-healing
ladder in :mod:`repro_torch.robust.ladder`: how many attempts, how the sketch
``cap`` grows on overflow, how far ``eps`` is bumped on a stall, and
whether a converged attempt must additionally clear certificate quality
floors (`repro_torch.obs.Certificate`). `RobustSolution` wraps the final
`repro_torch.core.api.Solution` with the full attempt history — every solve the
ladder ran, what triggered it, and its matvec-equivalent cost — while
delegating the `Solution` accessor surface, so robust callers read
``.value``/``.plan()``/``.status_label`` unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.api.solution import Solution

__all__ = ["Attempt", "EscalationPolicy", "RobustSolution"]


@dataclass(frozen=True)
class EscalationPolicy:
    """Deterministic escalation knobs (the ladder table of `repro_torch.robust.ladder`).

    ``ess_floor``/``error_bound_tol`` opt a converged attempt into
    certificate quality checks: setting either forces ``certify=True`` on
    every ladder attempt (including the first — the happy path is then no
    longer bitwise-free, by construction: the caller asked for certified
    solves).
    """

    #: total solve attempts, the first (caller's own method/opts) included
    max_attempts: int = 6
    #: sketch ``cap`` multiplier per re-sketch on overflow / low quality
    cap_growth: float = 2.0
    #: ``eps`` multiplier for the stall bump (re-tightened afterwards)
    eps_bump: float = 10.0
    #: ``max_iter`` multiplier on a clean budget exhaustion
    max_iter_growth: float = 2.0
    #: minimum acceptable ``certificate.ess`` (0 = no ESS check)
    ess_floor: float = 0.0
    #: maximum acceptable ``certificate.error_bound`` (inf = no check)
    error_bound_tol: float = math.inf
    #: allow the dense log-domain last resort …
    dense_fallback: bool = True
    #: … but only when max(n, m) fits under this guard (mirrors
    #: `PointCloudGeometry.DEFAULT_DENSE_GUARD`)
    dense_guard: int = 8192

    @property
    def wants_certificate(self) -> bool:
        """Whether accepted attempts must carry a quality certificate."""
        return self.ess_floor > 0 or math.isfinite(self.error_bound_tol)


@dataclass(frozen=True)
class Attempt:
    """One ladder rung: what ran, why, and what came back (host-side)."""

    index: int
    method: str
    #: what put this attempt on the ladder: ``initial`` | ``log_domain`` |
    #: ``resketch`` | ``eps_bump`` | ``retighten`` | ``grow_budget`` |
    #: ``dense_log``
    action: str
    eps: float
    #: `Solution.status_label` (None for status-less solvers)
    status: str | None
    converged: bool
    n_iter: int
    #: matvec-equivalents: 2 kernel applications per Sinkhorn iteration
    matvecs: int
    value: float
    error_bound: float | None = None
    overflowed: bool | None = None
    #: sketch cap in force for this attempt (sketching methods only)
    cap: int | None = None


@dataclass(eq=False)
class RobustSolution:
    """Final accepted `Solution` + the honest history that produced it.

    Attribute access falls through to ``.solution``, so a `RobustSolution`
    drops into any code that reads the plain `Solution` surface
    (``.value``, ``.potentials``, ``.plan()``, ``.status_label``, …).
    The final status is the *real* status of the accepted attempt — a
    ladder that ran out of rungs reports ``recovered=False`` rather than
    dressing up the best failure.
    """

    solution: Solution
    attempts: tuple[Attempt, ...] = field(default_factory=tuple)
    #: did the accepted attempt converge cleanly (no overflow, certificate
    #: floors met when the policy asks for them)? Set by the ladder — a
    #: ladder that ran out of rungs returns its best attempt with
    #: ``recovered=False`` rather than dressing up the failure.
    recovered: bool = False

    @property
    def escalated(self) -> bool:
        """True when the first attempt was not accepted as-is."""
        return len(self.attempts) > 1

    @property
    def total_matvecs(self) -> int:
        """Matvec-equivalents summed over every attempt (recovery cost)."""
        return sum(t.matvecs for t in self.attempts)

    def __getattr__(self, name: str):
        # only reached when normal lookup fails: delegate to the Solution
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.solution, name)
