"""Solver telemetry: fixed-size ring-buffer iteration traces.

The port of ``repro.obs.trace``. `SolverTrace` is a ring buffer of the
last ``trace_len`` iterations' stopping-rule error and marginal violation,
plus a matvec-equivalent counter (the paper's cost unit: one kernel
mat-vec or one segment-reduction sweep over the sketch; a Sinkhorn
iteration costs 2). The loops of `repro_torch.core.sinkhorn` carry it in
their state, so an iteration the loop runs past its stop (it reads its
``active`` flag on the host every ``CHECK_EVERY`` iterations) writes no
slot and advances no counter.

Zero overhead when disabled: every loop takes ``trace=False`` by default
and touches trace state only under ``if trace:``, so an untraced solve
dispatches the same ops as the loops before telemetry (guarded by tests
against frozen copies of those loops).

Host-side, `Diagnostics` (``Solution.diagnostics``) unrolls the ring in
order and carries the `SketchStats` of the sketching solvers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.obs.certify import Certificate, importance_ess

__all__ = [
    "DEFAULT_TRACE_LEN",
    "Diagnostics",
    "SketchStats",
    "SolverTrace",
    "empty_trace",
    "record_iteration",
    "resolve_trace_len",
    "sketch_diagnostics",
    "trim_trace",
]

#: ring-buffer length of ``trace=True`` (``trace=<int>`` sets another)
DEFAULT_TRACE_LEN = 256


class SolverTrace(NamedTuple):
    """Per-iteration telemetry carried through a loop.

    Iteration ``i`` writes ring slot ``i % trace_len``; after ``n_iter``
    iterations the buffer holds the **last** ``min(n_iter, trace_len)``
    records (`trim_trace` unrolls them in order). Batched traces carry
    ``(B, trace_len)`` buffers and a ``(B,)`` counter; frozen elements stop
    writing, so each element's trace is its per-problem one.
    """

    err: torch.Tensor  # (..., L) stopping-rule error per iteration
    marg: torch.Tensor  # (..., L) column-marginal violation per iteration
    n_matvec: torch.Tensor  # (...,) int32 matvec-equivalent counter

    @property
    def trace_len(self) -> int:
        return self.err.shape[-1]


def resolve_trace_len(trace: bool | int) -> int:
    """``trace=True`` -> `DEFAULT_TRACE_LEN`; an int is its own length."""
    return DEFAULT_TRACE_LEN if trace is True else int(trace)


def empty_trace(trace_len: int, dtype, batch: int | None = None, *, device=None) -> SolverTrace:
    """Fresh ring buffers, NaN-filled ("not yet recorded" differs from a
    genuine 0.0 error), and a zeroed counter, on ``device`` (``None``
    means the card, by the port's device rule)."""
    dev = resolve_device(device)
    shape = (trace_len,) if batch is None else (batch, trace_len)
    head = () if batch is None else (batch,)
    return SolverTrace(
        torch.full(shape, torch.nan, dtype=dtype, device=dev),
        torch.full(shape, torch.nan, dtype=dtype, device=dev),
        torch.zeros(head, dtype=torch.int32, device=dev),
    )


def record_iteration(
    tr: SolverTrace,
    t: torch.Tensor,
    err: torch.Tensor,
    marg: torch.Tensor,
    *,
    matvec_equivs: int = 2,
    active: torch.Tensor | None = None,
) -> SolverTrace:
    """Write iteration ``t``'s record at ring slot ``t % trace_len``.

    ``t`` is the pre-increment iteration index, a device tensor: the slot is
    written through a mask, so no value leaves the device. Batched form:
    ``t``/``err``/``marg``/``active`` are (B,); inactive elements keep their
    old records and counter.
    """
    L = tr.trace_len
    slots = torch.arange(L, device=tr.err.device)
    if tr.err.ndim == 1:
        hit = slots == t % L
        return SolverTrace(
            torch.where(hit, err, tr.err),
            torch.where(hit, marg, tr.marg),
            tr.n_matvec + matvec_equivs,
        )
    hit = (slots[None, :] == (t % L)[:, None]) & active[:, None]
    return SolverTrace(
        torch.where(hit, err[:, None], tr.err),
        torch.where(hit, marg[:, None], tr.marg),
        tr.n_matvec + torch.where(active, matvec_equivs, 0).to(torch.int32),
    )


def trim_trace(tr: SolverTrace, n_iter) -> tuple[np.ndarray, np.ndarray, int]:
    """One element's ring buffer in chronological order (on the host).

    Returns ``(errs, margs, first_iteration)``: the last ``min(n_iter, L)``
    records, oldest first, and the iteration index of the first of them
    (0 unless the ring wrapped).
    """
    if tr.err.ndim != 1:
        raise ValueError("trim_trace takes one element's trace; index the batch first")
    k = int(n_iter)
    L = tr.trace_len
    err = tr.err.cpu().numpy()
    marg = tr.marg.cpu().numpy()
    if k <= L:
        return err[:k], marg[:k], 0
    h = k % L
    return np.concatenate([err[h:], err[:h]]), np.concatenate([marg[h:], marg[:h]]), k - L


# --------------------------------------------------------------------------
# Sketch diagnostics
# --------------------------------------------------------------------------


class SketchStats(NamedTuple):
    """Quality report of one importance sketch (`SparseKernelCOO` /
    `LogSparseKernelCOO`), computed in O(cap) by `sketch_diagnostics`."""

    nnz: torch.Tensor  # () realized distinct entries
    cap: int  # the COO capacity
    fill: torch.Tensor  # () float32 nnz / cap
    overflowed: torch.Tensor | None  # () bool: the draw exceeded cap (None if unknown)
    ess: torch.Tensor  # () effective sample size of the importance weights
    ess_ratio: torch.Tensor  # () ess / nnz (1.0 = perfectly balanced weights)
    #: float32 fraction of the evaluated proposals that survived thinning
    #: (the UOT acceptance rate of the matrix-free sampler; 1.0 on Bernoulli
    #: draws; None when the builder recorded no draw counts)
    acceptance_rate: torch.Tensor | None
    #: float32 fraction of the accepted draws that did not survive as
    #: distinct entries (merged duplicates of the Poisson sampler, capacity
    #: truncation of the Bernoulli draws; None when unknown)
    dup_merge_rate: torch.Tensor | None


def sketch_diagnostics(sk) -> SketchStats:
    """O(cap) `SketchStats` of a COO sketch (scaling or log domain); the
    weights' ESS is taken in log space for log-space sketches.
    ``acceptance_rate``/``dup_merge_rate`` need the draw counts
    ``n_proposed``/``n_accepted`` on the sketch (None without them).
    """
    nnz, cap = sk.nnz, sk.cap
    fill = nnz.to(torch.float32) / float(cap)
    logvals = getattr(sk, "logvals", None)
    ess = importance_ess(logvals, log_space=True) if logvals is not None else importance_ess(sk.vals)
    ess_ratio = torch.where(nnz > 0, ess / torch.clamp_min(nnz, 1), 0.0)
    n_prop = getattr(sk, "n_proposed", None)
    n_acc = getattr(sk, "n_accepted", None)
    acceptance = merge = None
    if n_prop is not None and n_acc is not None:
        # float32 ratios of the counts, as the reference computes them
        f32 = torch.float32
        evaluated = torch.clamp_max(n_prop, cap)  # proposals past cap never drawn
        acceptance = torch.where(evaluated > 0, n_acc.to(f32) / torch.clamp_min(evaluated, 1).to(f32), 1.0)
        merge = torch.where(n_acc > 0, 1.0 - nnz.to(f32) / torch.clamp_min(n_acc, 1).to(f32), 0.0)
    return SketchStats(
        nnz=nnz,
        cap=cap,
        fill=fill,
        overflowed=sk.overflowed,
        ess=ess,
        ess_ratio=ess_ratio,
        acceptance_rate=acceptance,
        dup_merge_rate=merge,
    )


# --------------------------------------------------------------------------
# The Solution-level diagnostics record
# --------------------------------------------------------------------------


@dataclass
class Diagnostics:
    """Per-solve observability record (``Solution.diagnostics``).

    ``trace`` is the device ring buffer (None when the solve ran untraced);
    the accessors below read it on the host and unroll it. ``sketch`` is
    the `SketchStats` of a sketching solver, ``certificate`` the
    `Certificate` of a ``certify=True`` solve.
    """

    trace: SolverTrace | None
    n_iter: torch.Tensor
    status: torch.Tensor | None = None
    sketch: SketchStats | None = None
    certificate: Certificate | None = None

    @property
    def n_matvec(self) -> int:
        """Matvec-equivalents spent (0 when untraced)."""
        return 0 if self.trace is None else int(self.trace.n_matvec)

    @property
    def first_traced_iteration(self) -> int:
        """Iteration index of the first kept record (the ring may have wrapped)."""
        if self.trace is None:
            return 0
        return max(0, int(self.n_iter) - self.trace.trace_len)

    def iteration_errors(self) -> np.ndarray:
        """Per-iteration stopping-rule errors, oldest first (last L kept)."""
        if self.trace is None:
            return np.empty((0,))
        return trim_trace(self.trace, self.n_iter)[0]

    def marginal_errors(self) -> np.ndarray:
        """Per-iteration column-marginal violations, oldest first."""
        if self.trace is None:
            return np.empty((0,))
        return trim_trace(self.trace, self.n_iter)[1]

    def summary(self) -> dict:
        """Small host-side dict (JSON-friendly) for logging and export."""
        out: dict = {"n_iter": int(self.n_iter), "n_matvec": self.n_matvec}
        if self.status is not None:
            out["status"] = int(self.status)
        errs = self.iteration_errors()
        if errs.size:
            out["final_err"] = float(errs[-1])
            out["first_traced_iteration"] = self.first_traced_iteration
        if self.sketch is not None:
            out["sketch"] = {
                "nnz": int(self.sketch.nnz),
                "cap": int(self.sketch.cap),
                "fill": float(self.sketch.fill),
                "ess": float(self.sketch.ess),
                "ess_ratio": float(self.sketch.ess_ratio),
            }
            if self.sketch.overflowed is not None:
                out["sketch"]["overflowed"] = bool(self.sketch.overflowed)
            if self.sketch.acceptance_rate is not None:
                out["sketch"]["acceptance_rate"] = float(self.sketch.acceptance_rate)
            if self.sketch.dup_merge_rate is not None:
                out["sketch"]["dup_merge_rate"] = float(self.sketch.dup_merge_rate)
        if self.certificate is not None:
            out["certificate"] = self.certificate.summary()
        return out
