"""Faults planted in the program under test, to show that the judge finds
them: each is a context manager that patches one place of the timed path
and restores it on exit. `perfbench/calibrate.py --fault` reads them on
the card; ``perfbench/tests/test_perfbench_faults_*.py`` run them on the CPU.

* ``unchanged_step``: every Sinkhorn step returns its state unchanged;
* ``half_draw``: the sketch keeps only the first half of its draw;
* ``half_batch``: a served batch solves its first half only, and the rest
  get answers from that half;
* ``altered_value``: every value is 1e-3 off where it is produced.
"""
from __future__ import annotations

import importlib
from contextlib import ExitStack, contextmanager
from unittest import mock

__all__ = ["FAULTS", "planted"]

FAULTS = ("unchanged_step", "half_draw", "half_batch", "altered_value")
ALTERED = 1.0 + 1e-3


def _unchanged_step(stack: ExitStack) -> None:
    batch_solvers = importlib.import_module("repro_torch.batch.solvers")
    sinkhorn = importlib.import_module("repro_torch.core.sinkhorn")
    stack.enter_context(mock.patch.object(sinkhorn, "_run", lambda state, active, step, max_iter: (state, active)))
    stack.enter_context(mock.patch.object(batch_solvers, "_run", lambda state, step, max_iter, batch, device: state))


def _half_draw(stack: ExitStack) -> None:
    sparsify = importlib.import_module("repro_torch.core.sparsify")
    draw = sparsify._draw

    def half(generator, ra, rb, s, cap):
        rows, cols, valid, total = draw(generator, ra, rb, s, cap)
        slot = valid.cumsum(0)
        return rows, cols, valid & (slot <= total // 2), total

    stack.enter_context(mock.patch.object(sparsify, "_draw", half))


def _half_batch(stack: ExitStack) -> None:
    from repro_torch.batch.executor import BucketedExecutor

    solve_batch = BucketedExecutor.solve_batch

    def half(self, problems, *, generators=None, seeds=None, **opts):
        problems = list(problems)
        keep = max(len(problems) // 2, 1)
        gens = None if generators is None else list(generators)[:keep]
        sds = None if seeds is None else list(seeds)[:keep]
        out = solve_batch(self, problems[:keep], generators=gens, seeds=sds, **opts)
        return [out[i % keep] for i in range(len(problems))]

    stack.enter_context(mock.patch.object(BucketedExecutor, "solve_batch", half))


def _altered_value(stack: ExitStack) -> None:
    batch_solvers = importlib.import_module("repro_torch.batch.solvers")
    solvers = importlib.import_module("repro_torch.core.api.solvers")
    for name in ("_coo_value", "_coo_log_value"):
        fn = getattr(solvers, name)
        stack.enter_context(mock.patch.object(solvers, name, lambda *a, fn=fn: fn(*a) * ALTERED))
    outputs = batch_solvers._sketch_outputs

    def altered(*args, **kwargs):
        values, cert = outputs(*args, **kwargs)
        return values * ALTERED, cert

    stack.enter_context(mock.patch.object(batch_solvers, "_sketch_outputs", altered))


@contextmanager
def planted(name: str):
    patch = {"unchanged_step": _unchanged_step, "half_draw": _half_draw, "half_batch": _half_batch,
             "altered_value": _altered_value}[name]
    with ExitStack() as stack:
        patch(stack)
        yield
