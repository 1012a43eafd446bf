"""Per-`(bucket, method)` circuit breakers for the serving layer.

The port of ``repro.robust.breaker`` (host-side Python, no tensor code).

A breaker watches consecutive dispatch failures of one cached-program
family (one shape bucket x solver method). After ``failure_threshold``
consecutive failures it OPENs: requests for that family are shed
immediately with `repro_torch.launch.serve_ot.CircuitOpen` instead of burning a
dispatch slot on a known-bad program. After ``reset_timeout_s`` the
breaker lets exactly one probe dispatch through (HALF_OPEN); a successful
probe CLOSEs it, a failed one re-OPENs with a fresh timer.

The state machine is deliberately single-threaded: only the server's
dispatch loop touches it, so there are no locks to reason about. The
clock is injected (``clock=``) so tests — and the chaos harness's
`repro_torch.robust.chaos.SkewedClock` — drive the timeout deterministically.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

__all__ = ["BreakerPolicy", "CircuitBreaker", "BREAKER_STATES"]

#: gauge value per state (exported as ``ot_breaker_state``): 0 closed
#: (healthy), 1 open (shedding), 2 half-open (probing)
BREAKER_STATES = ("closed", "open", "half_open")


class BreakerPolicy(NamedTuple):
    """Knobs for one serving circuit breaker."""

    #: consecutive dispatch failures before the breaker opens
    failure_threshold: int = 3
    #: seconds an open breaker sheds before allowing a half-open probe
    reset_timeout_s: float = 1.0


class CircuitBreaker:
    """Single-dispatcher-thread circuit breaker (see module docstring)."""

    CLOSED, OPEN, HALF_OPEN = 0, 1, 2

    def __init__(
        self,
        policy: BreakerPolicy | None = None,
        *,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.policy = policy or BreakerPolicy()
        self._clock = clock
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> int:
        return self._state

    @property
    def state_label(self) -> str:
        return BREAKER_STATES[self._state]

    def allow(self) -> bool:
        """May the next dispatch go through? OPEN past its reset timeout
        transitions to HALF_OPEN and admits the one probe."""
        if self._state == self.CLOSED:
            return True
        if self._state == self.OPEN:
            if self._clock() - self._opened_at >= self.policy.reset_timeout_s:
                self._state = self.HALF_OPEN
                return True
            return False
        return True  # HALF_OPEN: the probe is in flight on this thread

    def record_success(self) -> None:
        self._state = self.CLOSED
        self._failures = 0

    def record_failure(self) -> None:
        self._failures += 1
        if self._state == self.HALF_OPEN or (
            self._failures >= self.policy.failure_threshold
        ):
            self._state = self.OPEN
            self._opened_at = self._clock()
