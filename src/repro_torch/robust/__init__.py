"""Self-healing solves: escalation ladder, circuit breakers, chaos harness.

The port of ``repro.robust``, with its names. ``solve_robust`` (or
``robust=True`` on `repro_torch.core.api.solve`, the batched executor and
the OT server) wraps a solve in the deterministic escalation ladder of
:mod:`repro_torch.robust.ladder`; :mod:`repro_torch.robust.breaker`
supplies the serving-layer circuit breakers; :mod:`repro_torch.robust.chaos`
is the seeded fault-injection harness the package is tested under.
"""
from repro_torch.robust.breaker import BREAKER_STATES, BreakerPolicy, CircuitBreaker
from repro_torch.robust.chaos import (
    ChaosGeometry,
    FlakyExecutor,
    InjectedFault,
    SkewedClock,
    corrupt_scaling_kernel,
    undersized_cap,
)
from repro_torch.robust.ladder import escalate_from, solve_robust
from repro_torch.robust.policy import Attempt, EscalationPolicy, RobustSolution

__all__ = [
    "Attempt",
    "BREAKER_STATES",
    "BreakerPolicy",
    "ChaosGeometry",
    "CircuitBreaker",
    "EscalationPolicy",
    "FlakyExecutor",
    "InjectedFault",
    "RobustSolution",
    "SkewedClock",
    "corrupt_scaling_kernel",
    "escalate_from",
    "solve_robust",
    "undersized_cap",
]
