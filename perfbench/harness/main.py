"""The command: one run of one cell, its checks on standard error and its
result as the last line of standard output."""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time

__all__ = ["foreign_modules", "main", "result_line"]

#: top-level module names that may not be loaded in a run's process
FOREIGN = frozenset({"jax", "jaxlib", "flax", "repro"})
BIG = sys.float_info.max  # stands for an infinite reading in the JSON line


def foreign_modules() -> list[str]:
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FOREIGN)


def _num(v: float) -> float:
    return BIG if math.isinf(v) else v


def result_line(cell, run, correct: bool, checks: dict, traced: bool, device_kind: str, count: int) -> dict:
    from perfbench.harness.manifest import reader
    from perfbench.harness.trace import breakdown

    metrics = {}
    if traced:
        records = dict(run.records, trace=run.trace, spans=run.spans)
        for m in cell.per_layer:
            value = reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": _num(values[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": count, "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
            "device": device}
    if traced and run.trace is not None:
        device.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        line["breakdown"] = breakdown(run.trace, run.spans)
    line["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]} for k, c in checks.items()}
    return line


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.harness.manifest import Cell, load

    cell = Cell(load(), args.workload)
    import torch

    torch.set_num_threads(2)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from perfbench.harness.cells import run_cell
    from perfbench.harness.judge import judge

    marks = {"torch": time.perf_counter() - t_start}
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    found = foreign_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    marks.update(run.records.get("setup_marks", {}), window=run.setup_s)
    print("perfbench: set-up reached " + ", ".join(f"{k} at {v:.3f} s" for k, v in marks.items()), file=sys.stderr)
    gc.unfreeze()
    run.release()
    run.release = None
    torch.cuda.empty_cache()
    correct, checks = judge(cell, run)
    line = result_line(cell, run, correct, checks, bool(args.trace), torch.cuda.get_device_name(device), cell.chips)
    print(json.dumps(line))
    return 0
