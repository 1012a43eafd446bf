"""Whether a run is correct: every judged estimate's numbers within the
cell's limits (``perfbench/limits/<workload>.json``), and no estimate or
request that failed."""
from __future__ import annotations

import math
import sys

from perfbench.reference.spar_sink import judge as judge_one

__all__ = ["NUMBERS", "judge", "readings"]

NUMBERS = ("sketch_gap", "draw_dev", "marginal_gap", "value_gap")


def readings(items) -> dict[str, float]:
    """Each number's largest reading over the judged estimates; ``inf`` for
    an answer that never came, and for all if there is none."""
    out = dict.fromkeys(NUMBERS, -math.inf)
    if not items:
        return dict.fromkeys(NUMBERS, math.inf)
    for inputs, estimate in items:
        got = dict.fromkeys(NUMBERS, math.inf) if estimate is None else judge_one(inputs, estimate)
        for k in NUMBERS:
            out[k] = max(out[k], got[k])
    return out


def judge(limits: dict, run) -> tuple[bool, dict]:
    got = readings(run.items)
    checks = {k: {"value": got[k], "limit": limits[k]["limit"]} for k in NUMBERS}
    ok = run.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    checks["failed"] = {"value": run.failed, "limit": 0}
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    return ok, checks
