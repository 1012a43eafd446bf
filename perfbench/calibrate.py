"""Readings that the cells' limits and rates were set from, on the card.

    # the program's readings over seeds, one short window each
    python3 perfbench/calibrate.py --workload mf_n131072.ot --seeds 11,12,13 --seconds 4
    # the control (the reference one precision down) in the program's place
    python3 perfbench/calibrate.py --workload mf_n131072.ot --seeds 11,12,13 --control
    # a fault planted in the program (see perfbench/harness/faults.py)
    python3 perfbench/calibrate.py --workload mf_n131072.ot --seeds 11,12,13 --seconds 4 --fault half_draw
    # an open-loop cell at other rates (the knee sweep)
    python3 perfbench/calibrate.py --workload serve_mf.poisson --seeds 11 --seconds 30 --rates 16,20,24
    # a cell that BENCHMARK.json does not hold yet, from its files
    python3 perfbench/calibrate.py --workload mf_n131072.ot --config sparsink_mf_c1_n131072 --traffic ot --seeds 11

Every seed runs in this one process and prints one JSON line: the largest
reading of each number over the judged estimates, the cell's end-to-end
numbers, and what was attempted and failed. The benchmark's runs never run
this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def control_items(cell, seed: int, device) -> list:
    """The cell's judged estimates, made by the control on the inputs the
    cell would give the program for ``seed``."""
    import torch

    from perfbench.harness.cells import domain, inputs_of, make_pool
    from perfbench.harness.inputs import derive
    from perfbench.reference.control import control_estimate

    pool = make_pool(cell, seed, device)
    s = cell.kind.budget(cell.config)
    tol, max_iter = cell.kind.stops(cell)
    items = []
    for k in cell.kind.sample(cell, seed, pool):
        inp = inputs_of(pool[k % len(pool)], cell.config, s)
        gen = torch.Generator(device=device).manual_seed(derive(seed, "control", k))
        items.append((inp, control_estimate(inp, gen, domain(cell), tol, max_iter)))
    return items


def main() -> int:
    ap = argparse.ArgumentParser(description="Readings for the limits and rates of a cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--rates", default=None, help="comma-separated offered rates of an open-loop cell")
    ap.add_argument("--sample-from", type=int, default=None, help="draw the judged requests among the first N")
    ap.add_argument("--config", default=None, help="with --traffic: a cell that BENCHMARK.json does not hold yet")
    ap.add_argument("--traffic", default=None)
    args = ap.parse_args()

    import torch

    from perfbench.harness.cells import run_cell
    from perfbench.harness.faults import planted
    from perfbench.harness.judge import readings
    from perfbench.harness.manifest import Cell, load

    torch.set_num_threads(2)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    manifest = load()
    if args.config:
        manifest["workloads"].append(dict(name=args.workload, config=args.config, traffic=args.traffic, chips=1))
    cell = Cell(manifest, args.workload)
    if args.sample_from is not None:
        cell.traffic["sample_from"] = args.sample_from
    rates = [float(r) for r in args.rates.split(",")] if args.rates else [None]
    for seed in (int(s) for s in args.seeds.split(",")):
        for rate in rates:
            if rate is not None:
                cell.traffic["rate_per_s"] = rate
            t0 = time.perf_counter()
            out = {"workload": args.workload, "seed": seed, "rate": rate,
                   "mode": "control" if args.control else (args.fault or "program")}
            if args.control:
                items = control_items(cell, seed, device)
                out["control_s"] = time.perf_counter() - t0
            else:
                with planted(args.fault) if args.fault else nullcontext():
                    run = run_cell(cell, seed, args.seconds, False, device, time.perf_counter())
                    run.release()
                    run.release = None
                items = run.items
                out.update(attempted=run.attempted, failed=run.failed, setup_s=run.setup_s, e2e=run.e2e,
                           close=run.records.get("close"),
                           iters=run.records.get("n_iter", [])[:8],
                           mean_batch=(run.records.get("server_stats") or {}).get("mean_batch"))
                del run
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            out["readings"] = readings(items)
            out["judge_s"] = time.perf_counter() - t1
            out["card"] = torch.cuda.get_device_name(device)
            print(json.dumps(out), flush=True)
            del items
            gc.unfreeze()
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
