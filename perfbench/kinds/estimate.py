"""Single large estimates: ``repro_torch.solve`` on each problem of the
pool in turn, as the traffic's discipline offers them.

Set-up makes the pool from the seed and runs one warm estimate; the window
records each estimate's time, iterations, kept pairs and memory peak. A
traced run profiles estimates ``trace_from`` to ``trace_from +
trace_estimates - 1`` and, after the window, times the public sketch build
alone."""
from __future__ import annotations

import math
import time
import traceback

import torch

from perfbench.harness.cells import (
    Run,
    domain,
    estimate_of,
    inputs_of,
    make_pool,
    open_window,
    peak,
    problem_of,
    warm_profiler,
)
from perfbench.harness.inputs import derive, generator, judged, s0
from perfbench.harness.trace import DeviceTrace

__all__ = ["CONFIG_KEYS", "TRAFFIC_KEYS", "budget", "check", "run", "sample", "stops"]

#: the configuration keys this kind reads (its pattern reads its own)
CONFIG_KEYS = frozenset({"method", "cost", "eps", "n", "d", "s_mult"})
#: the traffic keys this kind reads (its discipline reads its own)
TRAFFIC_KEYS = frozenset({"pool", "stabilize", "tol", "max_iter", "sample", "sample_from", "trace_from",
                          "trace_estimates"})
METHODS = ("spar_sink_mf",)


def check(cell) -> None:
    if cell.config["method"] not in METHODS:
        raise ValueError(f"{cell.name}: method {cell.config['method']!r}; this kind drives {METHODS}")


def budget(cfg: dict) -> float:
    """The sketch's proposal budget ``s = s_mult * s0(n)``."""
    return cfg["s_mult"] * s0(cfg["n"])


def stops(cell) -> tuple[float, int]:
    return cell.traffic["tol"], cell.traffic["max_iter"]


def sample(cell, seed: int, pool: list[dict]) -> list[int]:
    tr = cell.traffic
    sizes = [pool[i % len(pool)]["x"].shape[0] for i in range(tr["sample_from"])]
    return judged(seed, tr["sample_from"], tr["sample"], sizes)


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Run:
    import repro_torch as rt

    cfg, tr = cell.config, cell.traffic
    result = Run()
    s = budget(cfg)
    dom = domain(cell)
    tol, max_iter = stops(cell)
    pool = make_pool(cell, seed, device)
    problems = [problem_of(p, cfg, device) for p in pool]
    result.records["setup_marks"] = {"pool": time.perf_counter() - t_start}
    opts = dict(method=cfg["method"], s=s, tol=tol, max_iter=max_iter, stabilize=tr["stabilize"])
    float(rt.solve(problems[0], seed=derive(seed, "warm"), **opts).value)
    if traced:
        warm_profiler(device)
    result.records["setup_marks"]["warm"] = time.perf_counter() - t_start
    chosen = set(sample(cell, seed, pool))
    held, n_iter, nnz, peaks = {}, [], [], []
    trace_first = tr["trace_from"]
    trace_stop = trace_first + tr["trace_estimates"]
    open_window(device)
    result.memory_peak_bytes = peak(device)
    base = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    t0 = time.perf_counter()
    result.setup_s = t0 - t_start
    last_end = t0

    def one(i: int) -> None:
        nonlocal last_end
        if traced and i == trace_first:
            result.trace = DeviceTrace()
            result.trace.begin()
        if device.type == "cuda":
            held_bytes = torch.cuda.memory_allocated(device) - base
            torch.cuda.reset_peak_memory_stats(device)
        with result.spans.span("estimate"):
            try:
                sol = rt.solve(problems[i % len(problems)], seed=derive(seed, "estimate", i), **opts)
                value = float(sol.value)  # waits for the estimate
            except Exception:  # noqa: BLE001 - an estimate that raises is counted, the loop goes on
                traceback.print_exc()
                sol, value = None, math.nan
        last_end = time.perf_counter()
        if device.type == "cuda":
            raw = torch.cuda.max_memory_allocated(device)
            result.memory_peak_bytes = max(result.memory_peak_bytes, raw)
            peaks.append(raw - held_bytes)  # what the harness holds to judge is not the estimate's
        result.attempted += 1
        if sol is None or not math.isfinite(value):
            result.failed += 1
        else:
            n_iter.append(int(sol.n_iter))
            nnz.append(int(sol.nnz))
            if i in chosen:
                held[i] = sol
        if traced and i == trace_stop - 1:
            result.trace.finish()

    least = max(tr["sample_from"], trace_stop if traced else 0)
    cell.discipline.drive(tr, one, t0, seconds, least)
    window = last_end - t0
    result.e2e = {"estimate_ms": window / max(result.attempted - result.failed, 1) * 1e3,
                  "estimate_peak_gb": max(peaks) / 1e9 if peaks else None}
    result.records.update(n=cfg["n"], d=cfg["d"], s=s, domain=dom, n_iter=n_iter, nnz=nnz,
                          traced_iters=n_iter[trace_first:trace_stop], traced_nnz=nnz[trace_first:trace_stop])
    if traced:
        build = rt.build_mf_log_sketch if tr["stabilize"] else rt.build_mf_sketch

        def sketch():
            return build(problems[0], generator(device, seed, "sketch"), s)

        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with result.spans.span("sketch"):
                start.record()
                sketch()
                end.record()
                end.synchronize()
            times.append(start.elapsed_time(end))
        dev = DeviceTrace()
        dev.begin()
        for _ in range(3):
            sketch()
        dev.finish()
        result.records.update(sketch_event_ms=times, sketch_device_s=dev.op_seconds(lambda name: True)[0] / 3)

    def release():
        result.items = [estimate_of(held[k], inputs_of(pool[k % len(pool)], cfg, s), dom, tol, max_iter)
                        for k in sorted(held)]
        held.clear()
        problems.clear()

    result.release = release
    return result
