"""Small problems served: ``OTServer.submit`` over a ``BucketedExecutor``,
as the traffic's discipline offers them.

Set-up makes the pool from the seed and fills every executor cache entry
the traffic can reach (each size's bucket at each padded batch size); the
window times each request from when it was due. A traced run continues the
same traffic for ``trace_seconds`` after the window under the profiler,
started and stopped while the server is idle (started or stopped while its
thread launches kernels, the profiler corrupts memory)."""
from __future__ import annotations

import math
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field

import torch

from perfbench.harness import faults as FAULTS
from perfbench.harness.cells import (
    LATE_S,
    Run,
    control_items as control,
    domain,
    estimate_of,
    inputs_of,
    make_pool,
    open_window,
    peak,
    problem_of,
    warm_profiler,
)
from perfbench.harness.inputs import derive, judged, s0
from perfbench.harness.trace import DeviceTrace
from perfbench.reference import spar_sink as REFERENCE

__all__ = ["CONFIG_KEYS", "FAULTS", "REFERENCE", "TRAFFIC_KEYS", "budget", "check", "control", "run", "sample",
           "stops"]

#: the configuration keys this kind reads (its pattern reads its own)
CONFIG_KEYS = frozenset({"method", "cost", "eps", "sizes", "s_mult", "s_of", "tol", "max_iter", "max_batch",
                         "deadline_ms"})
#: the traffic keys this kind reads (its discipline reads its own)
TRAFFIC_KEYS = frozenset({"pool", "stabilize", "sample", "sample_from", "trace_seconds"})
METHODS = ("spar_sink_mf",)


def check(cell) -> None:
    if cell.config["method"] not in METHODS:
        raise ValueError(f"{cell.name}: method {cell.config['method']!r}; this kind drives {METHODS}")
    if cell.config["cost"] not in REFERENCE.COSTS:
        raise ValueError(f"{cell.name}: cost {cell.config['cost']!r}; the reference judges {REFERENCE.COSTS}")


def budget(cfg: dict) -> float:
    """Every request's proposal budget ``s = s_mult * s0(s_of)``."""
    return cfg["s_mult"] * s0(cfg["s_of"])


def stops(cell) -> tuple[float, int]:
    return cell.config["tol"], cell.config["max_iter"]


def sample(cell, seed: int, pool: list[dict]) -> list[int]:
    tr = cell.traffic
    sizes = [pool[i % len(pool)]["x"].shape[0] for i in range(tr["sample_from"])]
    return judged(seed, tr["sample_from"], tr["sample"], sizes)


@dataclass
class Request:
    index: int
    pool: int
    due: float
    submitted: float = math.nan
    done: float = math.nan
    #: the answer's value, or None where it raised
    value: object = None
    #: the server's future until the answer is in, and after that only
    #: while the answer is to be judged: a solution holds its batch's
    #: tensors, so answers that are kept add up to its whole output
    future: object = None
    finished: threading.Event = field(default_factory=threading.Event)


class Feed:
    """What a discipline sends requests through: ``send(i, due, then)``
    submits request ``i`` (the pool's problem ``i % len(pool)``, its own
    sketch seed), calls ``then()`` once its answer is in, and returns its
    `Request`; ``spans`` records the discipline's waits."""

    def __init__(self, send, spans):
        self.send = send
        self.spans = spans


def _p95(values: list[float]) -> float:
    """The nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Run:
    from repro_torch.batch import BucketedExecutor
    from repro_torch.launch.serve_ot import OTServer
    from repro_torch.obs.metrics import MetricsRegistry

    cfg, tr = cell.config, cell.traffic
    result = Run()
    s = budget(cfg)
    dom = domain(cell)
    tol, max_iter = stops(cell)
    pool = make_pool(cell, seed, device)
    problems = [problem_of(p, cfg, device) for p in pool]
    result.records["setup_marks"] = {"pool": time.perf_counter() - t_start}
    opts = dict(method=cfg["method"], s=s, tol=tol, max_iter=max_iter, stabilize=tr["stabilize"])
    metrics = MetricsRegistry()
    executor = BucketedExecutor(metrics=metrics)
    # every cache entry the traffic reaches: each size's bucket at each
    # padded batch size a collected batch can give
    for size in cfg["sizes"]:
        idx = [k for k, p in enumerate(pool) if p["x"].shape[0] == size]
        batch = 1
        while batch <= cfg["max_batch"]:
            group = [problems[idx[j % len(idx)]] for j in range(batch)]
            sols = executor.solve_batch(group, seeds=[derive(seed, "warm", size, batch, j) for j in range(batch)],
                                        **opts)
            float(sols[-1].value)
            batch *= 2
    server = OTServer(executor, max_batch=cfg["max_batch"], deadline_s=cfg["deadline_ms"] / 1e3)
    server.start()
    server.submit(problems[0], seed=derive(seed, "warm"), **opts).result()
    if traced:
        warm_profiler(device)
    result.records["setup_marks"]["warm"] = time.perf_counter() - t_start
    server.reset_stats()
    metrics.reset("executor.")

    chosen = set(sample(cell, seed, pool))
    extracted: dict[int, tuple] = {}
    to_extract: "queue.Queue[Request | None]" = queue.Queue()
    deadline = math.inf

    def collector():
        # the sampled answers' outputs, copied as each arrives, so that no
        # whole batch stays pinned
        while (r := to_extract.get()) is not None:
            try:
                wait = None if math.isinf(deadline) else max(deadline - time.perf_counter(), 0.0)
                sol = r.future.result(timeout=wait)
                extracted[r.index] = estimate_of(sol, inputs_of(pool[r.pool], cfg, s), dom, tol, max_iter)
            except Exception:  # noqa: BLE001 - judged as an answer that never came
                traceback.print_exc()
            r.future = None

    worker = threading.Thread(target=collector, daemon=True)
    worker.start()

    def finish(r: Request, fut, then) -> None:
        r.done = time.perf_counter()
        try:
            r.value = fut.result().value
        except Exception:  # noqa: BLE001 - counted as failed
            r.value = None
        if r.index not in chosen:
            r.future = None
        r.finished.set()
        if then is not None:
            then()

    def send(i: int, due: float, then=None) -> Request:
        r = Request(i, i % len(pool), due)
        with result.spans.span("submit"):
            r.submitted = time.perf_counter()
            r.future = fut = server.submit(problems[r.pool], seed=derive(seed, "request", i), **opts)
        fut.add_done_callback(lambda fut, r=r: finish(r, fut, then))
        if i in chosen:
            to_extract.put(r)
        return r

    feed = Feed(send, result.spans)

    def settle(sent: list, close: float) -> None:
        """Wait for every answer, a minute past ``close`` at most."""
        with result.spans.span("wait"):
            for r in sent:
                r.finished.wait(timeout=max(close + LATE_S - time.perf_counter(), 0.0))

    open_window(device)
    result.memory_peak_bytes = peak(device)
    t0 = time.perf_counter() + 0.005
    result.setup_s = t0 - t_start
    t_end = t0 + seconds
    reqs = cell.discipline.drive(tr, feed, 0, t0, seconds, "arrivals")
    window_close = time.perf_counter()
    deadline = window_close + LATE_S
    settle(reqs, window_close)
    to_extract.put(None)
    worker.join()
    result.memory_peak_bytes = max(result.memory_peak_bytes, peak(device))
    stats = server.stats()
    dispatch = metrics.get_histogram("executor.dispatch_seconds")
    if traced:
        result.trace = DeviceTrace()
        result.trace.begin()
        extra = cell.discipline.drive(tr, feed, len(reqs), time.perf_counter(), tr["trace_seconds"], "trace-arrivals")
        settle(extra, time.perf_counter())
        result.trace.finish()
        reqs = reqs + extra
    server.stop()

    values = [r.value if r.finished.is_set() else None for r in reqs]
    finite = [v for v in values if v is not None]
    flags = torch.isfinite(torch.stack(finite)).tolist() if finite else []
    it = iter(flags)
    good = [v is not None and next(it) for v in values]
    result.attempted = len(reqs)
    result.failed = good.count(False)
    window = [(r, ok) for r, ok in zip(reqs, good) if r.due < t_end]
    latencies = [(r.done - r.due) if ok else math.inf for r, ok in window]
    result.e2e = {
        "serve_p95_ms": _p95(latencies) * 1e3,
        "serve_req_per_s": sum(1 for r, ok in window if ok and r.done <= t_end) / seconds,
    }
    done_by_close = sum(1 for r, _ in window if r.done <= window_close)
    result.records.update(server_stats=stats, dispatch=dispatch,
                          close=dict(offered=len(window), done=done_by_close, queued=len(window) - done_by_close),
                          gen_lag_s=[r.submitted - r.due for r, _ in window])

    def release():
        for i in sorted(chosen):
            if i < len(reqs):
                result.items.append(extracted.get(i, (inputs_of(pool[i % len(pool)], cfg, s), None)))
        reqs.clear()
        problems.clear()

    result.release = release
    return result
