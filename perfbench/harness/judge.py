"""Whether a run is correct: every judged answer's numbers within the
cell's limits (``perfbench/limits/<workload>.json``), and no answer that
failed.

The numbers and the judge of one answer come from the cell's kind: its
``REFERENCE`` is a module of ``perfbench/reference/`` with ``NUMBERS``
(the names, in the order they are printed) and ``judge(inputs, output)
-> dict`` (each number for one answer)."""
from __future__ import annotations

import math
import sys

__all__ = ["judge", "readings"]


def readings(items, reference) -> dict[str, float]:
    """Each of ``reference.NUMBERS``' largest reading over the judged
    answers; ``inf`` for an answer that never came, and for all if there
    is none."""
    numbers = reference.NUMBERS
    out = dict.fromkeys(numbers, -math.inf)
    if not items:
        return dict.fromkeys(numbers, math.inf)
    for inputs, output in items:
        got = dict.fromkeys(numbers, math.inf) if output is None else reference.judge(inputs, output)
        for k in numbers:
            out[k] = max(out[k], got[k])
    return out


def judge(cell, run) -> tuple[bool, dict]:
    reference = cell.kind.REFERENCE
    got = readings(run.items, reference)
    checks = {k: {"value": got[k], "limit": cell.limits[k]["limit"]} for k in reference.NUMBERS}
    ok = run.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    checks["failed"] = {"value": run.failed, "limit": 0}
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    return ok, checks
