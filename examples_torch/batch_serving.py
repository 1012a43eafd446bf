"""Batched OT execution and serving quickstart, on the PyTorch port.

    PYTHONPATH=src python examples_torch/batch_serving.py [--device cpu]

The counterpart of ``examples/batch_serving.py``. Builds a mixed stream of
balanced-OT and unbalanced-UOT problems at several support sizes, then
solves it three ways:

1. per-problem ``solve()`` in a Python loop,
2. one `BucketedExecutor` dispatch — the same `Solution`s (bitwise
   sketches and scalings for spar_sink given the same seeds), one batched
   solve a shape bucket, its bound solver cached across dispatches,
3. through the `OTServer` microbatching queue, the serving front end.

Along the way it prints the executor's `repro_torch.obs` runtime metrics
(cache hit rate, padding waste), the registry that
``repro_torch.obs.export()`` renders as JSON / Prometheus text. Where the
reference passes one JAX key a problem, the port passes one seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.batch import BucketedExecutor, batchable_methods
from repro_torch.core import Geometry, OTProblem, UOTProblem, s0, solve
from repro_torch.launch.serve_ot import OTServer
from repro_torch.obs import MetricsRegistry


def make_problems(B=16, sizes=(96, 128, 200, 256), seed=0, device=None):
    rng = np.random.default_rng(seed)
    problems = []
    for i in range(B):
        n = int(sizes[i % len(sizes)])
        x = torch.as_tensor(rng.uniform(size=(n, 3)), device=device)
        a = torch.as_tensor(rng.dirichlet(np.ones(n)), device=device)
        b = torch.as_tensor(rng.dirichlet(np.ones(n)), device=device)
        geom = Geometry.from_points(x, normalize=True)
        if i % 2:
            problems.append(UOTProblem(geom, a * 5.0, b * 3.0, 0.1, lam=0.5))
        else:
            problems.append(OTProblem(geom, a, b, 0.1))
    return problems


def _synced(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main(argv=None):
    ap = argparse.ArgumentParser(description="per-problem loop, batched dispatch and OTServer")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--problems", type=int, default=16)
    ap.add_argument("--sizes", default="96,128,200,256", help="support sizes, cycled")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    B = args.problems
    sizes = tuple(int(v) for v in args.sizes.split(","))
    problems = make_problems(B, sizes, device=device)
    seeds = list(range(B))
    s = 8 * s0(max(sizes))
    opts = dict(s=s, max_iter=2000)
    print("batchable methods:", ", ".join(batchable_methods()))

    # 1 -- per-problem loop
    t0 = _synced(device)
    loop_sols = [solve(p, method="spar_sink_coo", seed=k, **opts) for p, k in zip(problems, seeds)]
    t_loop = _synced(device) - t0

    # 2 -- one batched dispatch (the first fills the cache; the second is
    # the steady state)
    metrics = MetricsRegistry()  # private registry: numbers for this run only
    executor = BucketedExecutor(metrics=metrics)
    executor.solve_batch(problems, method="spar_sink_coo", seeds=seeds, **opts)
    t0 = _synced(device)
    batch_sols = executor.solve_batch(problems, method="spar_sink_coo", seeds=seeds, **opts)
    t_batch = _synced(device) - t0
    bitwise = all(
        torch.equal(bs.result.u, ls.result.u) and torch.equal(bs.result.v, ls.result.v)
        for bs, ls in zip(batch_sols, loop_sols)
    )
    print(f"loop {t_loop:.2f}s vs batched {t_batch:.2f}s "
          f"({t_loop / t_batch:.1f}x, {executor.compile_count} compiled "
          f"programs, scalings bitwise identical: {bitwise})")
    plan = batch_sols[0].plan()
    print(f"first solution: value={float(batch_sols[0].value):+.4f} "
          f"plan={type(plan).__name__}(cap={plan.cap})")
    hits = metrics.get_counter("executor.cache_hit")
    misses = metrics.get_counter("executor.cache_miss")
    waste = metrics.get_histogram("executor.padding_waste")
    print(f"executor metrics: cache hit rate "
          f"{hits / max(hits + misses, 1):.0%} ({hits:.0f}/{hits + misses:.0f} "
          f"lookups), mean padding waste {waste['mean']:.0%} over "
          f"{waste['count']} dispatches")

    # 3 -- serving front end: futures resolve to the same Solutions
    with OTServer(max_batch=8, deadline_s=0.02) as server:
        futures = [server.submit(p, method="spar_sink_coo", seed=k, **opts) for p, k in zip(problems, seeds)]
        served = [f.result() for f in futures]
    st = server.stats()
    same = all(float(sv.value) == float(bs.value) for sv, bs in zip(served, batch_sols))
    print(f"served {st['requests']} requests in {st['batches']} batches "
          f"(mean occupancy {st['mean_batch']:.1f}); values match batched "
          f"dispatch: {same}")
    return {"bitwise": bitwise, "served_match": same}


if __name__ == "__main__":
    main()
