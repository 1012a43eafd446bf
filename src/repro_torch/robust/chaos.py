"""Deterministic, seeded fault injectors (the chaos harness).

The port of ``repro.robust.chaos``. The escalation ladder and the hardened
server are tested against *induced* failures. Every injector here is a
pure function of its seed (or an explicit schedule), so rerunning a chaos
test replays the same faults:

* `ChaosGeometry` / `corrupt_scaling_kernel`: the scaling-domain Gibbs
  kernel comes back corrupted (a seed-chosen NaN row, or all zeros, the
  underflow image) while ``log_kernel``/``cost`` stay clean, the failure
  family that the ladder's log-domain rescue fixes. Over a
  `PointCloudGeometry` the corruption reaches the matrix-free sketch's
  gathered kernel values too (its log-domain sketch gathers clean costs).
* `undersized_cap`: a sketch ``cap`` far below the expected draw, forcing
  ``Solution.overflowed`` (the ladder re-sketches with a grown cap).
* `FlakyExecutor` + `InjectedFault`: wraps a `BucketedExecutor`; dispatch
  ``t`` raises when ``t`` is in ``fail_calls`` or, with ``fail_rate``,
  when a Bernoulli draw seeded by ``(seed, t)`` fires.
* `SkewedClock`: an injectable monotonic clock whose ``advance()`` jumps
  time between server phases.

Where the reference takes a PRNG key, these take an integer ``seed``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core.api.geometry import Geometry, PointCloudGeometry
from repro_torch.core.api.problems import OTProblem

__all__ = [
    "ChaosGeometry",
    "FlakyExecutor",
    "InjectedFault",
    "SkewedClock",
    "corrupt_scaling_kernel",
    "undersized_cap",
]


class InjectedFault(RuntimeError):
    """A deliberately injected failure (never raised by healthy code)."""


class ChaosGeometry(Geometry):
    """Geometry whose scaling-domain kernel is corrupted, log domain clean.

    ``mode="nan"`` poisons one seed-chosen row of ``K`` with NaN (the
    iterates go non-finite at the first matvec); ``mode="zero"`` returns an
    all-zero kernel (the small-eps underflow image: the solve exits
    ``degenerate``). ``log_kernel()`` and ``cost`` are the clean base
    geometry's. Built over a `PointCloudGeometry` it is one (a subclass of
    both), and the matrix-free sketch's gathered kernel values are
    corrupted the same way, while its gathered costs stay clean.
    """

    def __new__(cls, base: Geometry, seed: int = 0, *, mode: str = "nan"):
        if cls is ChaosGeometry and isinstance(base, PointCloudGeometry):
            cls = _ChaosPointCloudGeometry
        return super().__new__(cls)

    def __init__(self, base: Geometry, seed: int = 0, *, mode: str = "nan"):
        if mode not in ("nan", "zero"):
            raise ValueError(f"unknown chaos mode {mode!r}; use 'nan' or 'zero'")
        # the base's data and (clean) kernel caches; corruption is applied on
        # every read and never cached
        self.__dict__.update(base.__dict__)
        self.base = base
        self.seed = int(seed)
        self.mode = mode
        self.row = int(np.random.default_rng(self.seed).integers(0, base.shape[0]))

    def kernel(self, eps: float) -> torch.Tensor:
        K = self.base.kernel(eps)
        if self.mode == "zero":
            return torch.zeros_like(K)
        K = K.clone()
        K[self.row] = torch.nan
        return K

    def log_kernel(self, eps: float) -> torch.Tensor:
        return self.base.log_kernel(eps)


class _ChaosPointCloudGeometry(ChaosGeometry, PointCloudGeometry):
    """`ChaosGeometry` over a `PointCloudGeometry`: also corrupts the
    gathered kernel values that the matrix-free scaling-domain sketch reads."""

    def _entries(self, rows, cols, eps: float, impl: str, *, checked: bool):
        k_e, c_e = self.base._entries(rows, cols, eps, impl, checked=checked)
        if self.mode == "zero":
            return torch.zeros_like(k_e), c_e
        return torch.where(rows == self.row, torch.nan, k_e), c_e


def corrupt_scaling_kernel(problem: OTProblem, seed: int = 0, *, mode: str = "nan") -> OTProblem:
    """The same problem on a `ChaosGeometry` (scaling-domain solves fail)."""
    return dataclasses.replace(problem, geom=ChaosGeometry(problem.geom, seed, mode=mode))


def undersized_cap(s: float, *, factor: int = 8) -> int:
    """A sketch capacity about ``factor`` x below the expected draw
    ``E[nnz] = s``: overflow is certain for any reasonable draw, and the
    ladder's ``cap_growth`` doubling needs about log2(factor) + 1
    re-sketches to clear it."""
    return max(4, int(float(s)) // factor)


class FlakyExecutor:
    """`BucketedExecutor` wrapper that fails dispatches deterministically.

    Call ``t`` (0-indexed, counted over the wrapper's lifetime) raises
    `InjectedFault` when ``t`` is in ``fail_calls`` or, with ``fail_rate``,
    when a uniform draw of a generator seeded by ``(seed, t)`` falls below
    it. Everything else (metrics, ``compile_count``, ``min_bucket``, ...)
    delegates to the wrapped executor.
    """

    def __init__(
        self,
        executor,
        *,
        seed: int | None = None,
        fail_rate: float = 0.0,
        fail_calls: Iterable[int] = (),
    ):
        if fail_rate > 0.0 and seed is None:
            raise ValueError("fail_rate needs a seed for determinism")
        self._executor = executor
        self._seed = seed
        self._rate = float(fail_rate)
        self._fail_calls = frozenset(fail_calls)
        self.calls = 0
        self.faults = 0

    def solve_batch(self, *args, **kwargs):
        t = self.calls
        self.calls += 1
        fail = t in self._fail_calls
        if not fail and self._rate > 0.0:
            fail = bool(np.random.default_rng([self._seed, t]).random() < self._rate)
        if fail:
            self.faults += 1
            raise InjectedFault(f"injected dispatch failure (call #{t})")
        return self._executor.solve_batch(*args, **kwargs)

    def __getattr__(self, name: str):
        return getattr(self._executor, name)


class SkewedClock:
    """Injectable monotonic clock: ``clock() = base() + skew``.

    ``advance(dt)`` jumps the skew, e.g. between a server's drain and
    dispatch phases, so expiry paths that compare against "now" are
    testable without real sleeps or racy thread timing.
    """

    def __init__(self, base: Callable[[], float] = time.perf_counter):
        self._base = base
        self._skew = 0.0

    def __call__(self) -> float:
        return self._base() + self._skew

    def advance(self, dt: float) -> None:
        self._skew += float(dt)
