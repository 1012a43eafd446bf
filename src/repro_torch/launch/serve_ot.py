"""OT serving driver: a microbatching request queue over `BucketedExecutor`.

  PYTHONPATH=src python -m repro_torch.launch.serve_ot \\
      --requests 64 --max-batch 16 --method spar_sink_mf --deadline-ms 20

The port of ``repro.launch.serve_ot``. Requests (one OT/UOT problem each)
land on a queue; the dispatch loop collects up to ``max_batch`` of them, or
whatever has arrived when the oldest waiting request hits its batching
deadline, groups them by (method, options), and solves each group as one
`BucketedExecutor` dispatch. Every request resolves to an ordinary
`Solution` (an O(cap) `SparsePlan` for sketch methods) through a
`concurrent.futures.Future`. A sketching request carries its own random
source: ``submit(generator=)`` (a `torch.Generator` on the problem's
device) or ``submit(seed=)``, which makes one there. The dispatch thread
runs on the card's default stream, on the card unless the problems lie on
the CPU; nothing is served from the CPU in place of the card.

The CLI drives the server with synthetic mixed OT/UOT traffic (a few
support sizes, so a handful of shape buckets) and prints throughput,
latency, batch occupancy and cache statistics; ``--serial`` times the same
request stream as per-problem ``solve()`` calls. ``--device`` picks where
the problems live (default: the card).
"""
from __future__ import annotations

import argparse
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch._device import make_generator, resolve_device
from repro_torch.batch import BucketedExecutor
from repro_torch.batch.problems import bucket_shape
from repro_torch.core.api import Geometry, OTProblem, PointCloudGeometry, UOTProblem, solve
from repro_torch.core.api.solution import Solution
from repro_torch.core.spar_sink import s0
from repro_torch.obs import spans
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.robust.breaker import BreakerPolicy, CircuitBreaker

__all__ = [
    "CircuitOpen",
    "OTRequest",
    "OTServer",
    "RequestTimeout",
    "ServerOverloaded",
    "UnrecoverableSolve",
]


class RequestTimeout(TimeoutError):
    """A queued request exceeded its ``timeout_s`` before dispatch.

    Set as the exception of the request's future (so ``future.result()``
    raises it) instead of leaving the future forever unresolved; each
    expiry also bumps the ``ot_server_timeouts_total`` counter. Expiry is
    checked both when a batch is collected *and* again at dispatch time, so
    a request that aged out while earlier groups dispatched is dropped
    instead of solved past its deadline.
    """


class ServerOverloaded(RuntimeError):
    """Typed load-shed: ``submit()`` refused because the bounded queue
    (``max_queue``) is full. Counted in ``ot_shed_total``. Back off and
    resubmit — nothing was enqueued."""


class CircuitOpen(RuntimeError):
    """Typed load-shed: the `(bucket, method)` circuit breaker is OPEN, so
    the request was failed immediately instead of burning a dispatch on a
    known-bad cached-program family. Counted in ``ot_shed_total``."""


class UnrecoverableSolve(RuntimeError):
    """A ``robust=True`` dispatch ran the full escalation ladder and still
    could not produce an acceptable solution. Carries the honest history:
    ``.solution`` is the `repro_torch.robust.RobustSolution` (best attempt +
    every rung tried) — never silently returned as if it had converged."""

    def __init__(self, solution):
        self.solution = solution
        att = getattr(solution, "attempts", ())
        last = att[-1].status if att else None
        super().__init__(
            f"escalation ladder exhausted after {len(att)} attempt(s); "
            f"final status: {last!r}"
        )


@dataclass
class OTRequest:
    """One problem + solver options awaiting dispatch."""

    problem: OTProblem
    method: str
    #: the request's random source, on the problem's device (sketching methods)
    generator: torch.Generator | None
    opts: dict
    timeout_s: float | None = None
    future: "Future[Solution]" = field(default_factory=Future)
    #: stamped by ``submit()`` with the server's (injectable) clock
    t_submit: float = field(default_factory=time.perf_counter)
    #: True when the over-watermark degradation overrides were applied
    degraded: bool = False
    #: the request's trace id (`repro_torch.obs.spans`), from the spans' ids
    id: int = field(default_factory=spans.new_id)


class OTServer:
    """Microbatching front end: collect -> bucket -> one batched dispatch.

    ``deadline_s`` bounds how long the oldest queued request may wait for
    batch-mates; a full ``max_batch`` dispatches immediately. Requests with
    different (method, options) never share a dispatch (options are part of
    the executor's cache key anyway).

    Serving telemetry lands in ``metrics`` (default: the executor's
    registry, so one ``repro_torch.obs.export()`` covers both layers): counters
    ``serve.requests`` / ``serve.batches``, the ``serve.queue_depth``
    gauge, and histograms ``serve.batch_fill`` (dispatched size /
    ``max_batch``), ``serve.latency_seconds`` (submit-to-resolve per
    request, the distribution behind ``stats()``'s p50/p95/p99) and
    ``serve.queue_wait_seconds`` (submit to the start of the request's
    group's dispatch, the mean behind ``stats()["mean_queue_wait_s"]``).
    Spans (`repro_torch.obs.spans`, when recording): ``serve.batch``
    from a collected batch to its last future set (count ``requests``:
    their ids; host-only, its device time is its dispatches'), and one
    ``serve.queue`` a request over its queue wait on the server's clock,
    its trace id the request's ``id``.
    ``certify=True`` requests additionally feed the ``serve.cert_gap`` /
    ``serve.cert_ci_width`` histograms and the ``ot_cert_gap_p95`` /
    ``ot_cert_ci_width_p95`` gauges; requests expiring past their
    ``timeout_s`` bump ``ot_server_timeouts_total`` and fail their future
    with `RequestTimeout`.

    Hardening knobs (all off by default — the default server behaves
    exactly as before):

    * ``max_queue`` bounds the request queue; a full queue makes
      ``submit()`` raise `ServerOverloaded` instead of enqueueing
      (``ot_shed_total``).
    * ``degrade_watermark`` + ``degrade`` apply option overrides (e.g.
      ``{"certify": False, "max_iter": 500}``) to requests submitted while
      the queue depth is at or past the watermark — graceful degradation
      under load (``ot_degraded_total``; ``OTRequest.degraded`` marks them).
    * ``max_retries``/``backoff_s`` retry a failed dispatch with
      exponential backoff before failing its futures (``ot_retries_total``).
    * ``breaker`` (a `repro_torch.robust.BreakerPolicy`) arms one
      `repro_torch.robust.CircuitBreaker` per `(bucket, method)` cached-program
      family: after ``failure_threshold`` consecutive dispatch failures the
      family's requests are shed with `CircuitOpen` until a half-open probe
      succeeds (``ot_breaker_state`` gauges, ``ot_breaker_open`` count).
    * ``robust``/``policy`` run every dispatch under the `repro_torch.robust`
      escalation ladder; recovered requests resolve to a
      `repro_torch.robust.RobustSolution`, unrecoverable ones fail with
      `UnrecoverableSolve` — a degenerate result is never returned as a
      success.
    * ``clock``/``sleep`` are injectable for deterministic tests (the chaos
      harness's `repro_torch.robust.SkewedClock` drives expiry and breaker
      timeouts without real waits).
    """

    def __init__(
        self,
        executor: BucketedExecutor | None = None,
        *,
        max_batch: int = 16,
        deadline_s: float = 0.02,
        metrics: MetricsRegistry | None = None,
        max_queue: int | None = None,
        degrade_watermark: int | None = None,
        degrade: dict | None = None,
        max_retries: int = 0,
        backoff_s: float = 0.05,
        breaker: BreakerPolicy | None = None,
        robust: bool = False,
        policy=None,
        clock=time.perf_counter,
        sleep=time.sleep,
    ):
        self.executor = executor or BucketedExecutor()
        self.max_batch = max_batch
        self.deadline_s = deadline_s
        self.metrics = metrics if metrics is not None else self.executor.metrics
        self.max_queue = max_queue
        self.degrade_watermark = degrade_watermark
        self.degrade = dict(degrade) if degrade else {}
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.breaker_policy = breaker
        self.robust = robust or policy is not None
        self.policy = policy
        self._clock = clock
        self._sleep = sleep
        self._breakers: dict[tuple, CircuitBreaker] = {}
        self._queue: "queue.Queue[OTRequest | None]" = queue.Queue()
        self._thread: threading.Thread | None = None
        self.batches_dispatched = 0
        self.requests_served = 0

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "OTServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain the queue, then stop the dispatch thread."""
        if self._thread is None:
            return
        self._queue.put(None)
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "OTServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- submit

    def submit(
        self,
        problem: OTProblem,
        *,
        method: str = "spar_sink_coo",
        generator: torch.Generator | None = None,
        seed: int | None = None,
        timeout_s: float | None = None,
        **opts,
    ) -> "Future[Solution]":
        """Enqueue one problem; resolves to its `Solution` after dispatch.

        A sketching method needs a random source: ``generator`` (a
        `torch.Generator` on the problem's device) or ``seed`` (a generator
        seeded with it is made there), as ``solve()`` takes them.

        ``timeout_s`` bounds the queue wait: a request still undispatched
        that long after submit fails with `RequestTimeout` instead of
        occupying a batch slot (and is counted in
        ``ot_server_timeouts_total``).

        With a bounded queue (``max_queue``), a full queue raises
        `ServerOverloaded` here — synchronous backpressure, nothing is
        enqueued. Past ``degrade_watermark``, the server's ``degrade``
        option overrides are merged into ``opts`` before enqueueing.
        """
        depth = self._queue.qsize()
        if self.max_queue is not None and depth >= self.max_queue:
            self.metrics.counter("ot_shed_total")
            raise ServerOverloaded(
                f"queue full ({depth} >= max_queue={self.max_queue})"
            )
        degraded = False
        if (
            self.degrade_watermark is not None
            and depth >= self.degrade_watermark
            and self.degrade
        ):
            opts = {**opts, **self.degrade}
            degraded = True
            self.metrics.counter("ot_degraded_total")
        if generator is not None or seed is not None:
            generator = make_generator(problem.device, generator, seed)
        req = OTRequest(
            problem, method, generator, opts, timeout_s=timeout_s, degraded=degraded
        )
        req.t_submit = self._clock()
        self._queue.put(req)
        self.metrics.gauge("serve.queue_depth", float(self._queue.qsize()))
        return req.future

    # ------------------------------------------------------------ dispatch

    def _collect(self) -> list[OTRequest] | None:
        """Block for the next request, then gather batch-mates until the
        batch is full or the first request's deadline passes. Already-queued
        requests are drained greedily even past the deadline — when the
        server falls behind, batches fill instead of degenerating to size 1.
        Returns None on the stop sentinel."""
        first = self._queue.get()
        self.metrics.gauge("serve.queue_depth", float(self._queue.qsize()))
        if first is None:
            return None
        batch = [first]
        deadline = first.t_submit + self.deadline_s
        while len(batch) < self.max_batch:
            timeout = deadline - self._clock()
            try:
                nxt = (
                    self._queue.get_nowait()
                    if timeout <= 0
                    else self._queue.get(timeout=timeout)
                )
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # keep the sentinel for the main loop
                break
            batch.append(nxt)
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            with spans.span("serve.batch", requests=[r.id for r in batch]):
                batch = self._expire(batch)
                # group by (method, opts, has-generator): only identical programs
                # share a dispatch, and a request without a random source can't
                # poison a group that has them (it fails alone with the
                # executor's missing-generators error)
                groups: dict[tuple, list[OTRequest]] = {}
                for r in batch:
                    groups.setdefault(
                        (r.method, tuple(sorted(r.opts.items())), r.generator is not None),
                        [],
                    ).append(r)
                for (method, _, _), reqs in groups.items():
                    self._dispatch(method, reqs)

    def _expire(self, batch: list[OTRequest]) -> list[OTRequest]:
        """Fail requests whose queue wait exceeded their ``timeout_s`` with
        `RequestTimeout`; returns the still-live remainder."""
        now = self._clock()
        live = []
        for r in batch:
            if r.timeout_s is not None and now - r.t_submit > r.timeout_s:
                self.metrics.counter("ot_server_timeouts_total")
                if not r.future.cancelled():
                    r.future.set_exception(RequestTimeout(
                        f"request queued {now - r.t_submit:.3f}s, "
                        f"timeout_s={r.timeout_s}"
                    ))
            else:
                live.append(r)
        return live

    def _dispatch(self, method: str, reqs: list[OTRequest]) -> None:
        # re-check expiry at dispatch time: a request may have aged out while
        # earlier groups of the same batch dispatched ahead of it
        reqs = self._expire(reqs)
        if not reqs:
            return
        if self.breaker_policy is None:
            self._dispatch_group(method, reqs)
            return
        # breaker families are per (shape bucket, method) — one cached
        # program each — so a poisoned family sheds alone instead of
        # dragging healthy buckets down with it
        by_bucket: dict[tuple, list[OTRequest]] = {}
        for r in reqs:
            n, m = r.problem.shape
            b = bucket_shape(n, m, min_size=self.executor.min_bucket)
            by_bucket.setdefault(b, []).append(r)
        for bucket, group in by_bucket.items():
            brk = self._breakers.setdefault(
                (bucket, method),
                CircuitBreaker(self.breaker_policy, clock=self._clock),
            )
            if not brk.allow():
                self.metrics.counter("ot_shed_total", float(len(group)))
                for r in group:
                    if not r.future.cancelled():
                        r.future.set_exception(CircuitOpen(
                            f"breaker open: bucket={bucket}, method={method!r}"
                        ))
                self._breaker_gauges(bucket, method, brk)
                continue
            ok = self._dispatch_group(method, group)
            (brk.record_success if ok else brk.record_failure)()
            self._breaker_gauges(bucket, method, brk)

    def _breaker_gauges(self, bucket: tuple, method: str, brk: CircuitBreaker) -> None:
        self.metrics.gauge(
            f"ot_breaker_state:{method}:{bucket[0]}x{bucket[1]}",
            float(brk.state),
        )
        self.metrics.gauge(
            "ot_breaker_open",
            float(sum(
                1 for b in self._breakers.values() if b.state == CircuitBreaker.OPEN
            )),
        )

    def _dispatch_group(self, method: str, reqs: list[OTRequest]) -> bool:
        """One executor dispatch with retry-with-backoff; True on success.

        On failure each retry bumps ``ot_retries_total`` and sleeps
        ``backoff_s * 2**attempt`` (injectable ``sleep``); the final failure
        fails every request's future with the dispatch exception.
        """
        generators = None
        if all(r.generator is not None for r in reqs):
            generators = [r.generator for r in reqs]
        problems = [r.problem for r in reqs]
        t_dispatch = self._clock()
        for r in reqs:
            spans.record("serve.queue", r.t_submit, t_dispatch, trace=r.id)
        attempt = 0
        while True:
            try:
                sols = self.executor.solve_batch(
                    problems,
                    method=method,
                    generators=generators,
                    robust=self.robust,
                    policy=self.policy,
                    **reqs[0].opts,
                )
                break
            except Exception as e:  # noqa: BLE001 — fail the requests, not the loop
                if attempt >= self.max_retries:
                    for r in reqs:
                        if not r.future.cancelled():
                            r.future.set_exception(e)
                    return False
                self.metrics.counter("ot_retries_total")
                self._sleep(self.backoff_s * (2 ** attempt))
                attempt += 1
        now = self._clock()
        # one locked block: the counters, the fill/latency histograms, and
        # the legacy attributes move together, so a concurrent reset_stats()
        # or stats() never sees a half-recorded dispatch
        with self.metrics.locked():
            self.batches_dispatched += 1
            self.requests_served += len(reqs)
            self.metrics.counter("serve.batches")
            self.metrics.counter("serve.requests", float(len(reqs)))
            self.metrics.observe("serve.batch_fill", len(reqs) / self.max_batch)
            for r in reqs:
                self.metrics.observe("serve.latency_seconds", now - r.t_submit)
                self.metrics.observe("serve.queue_wait_seconds", t_dispatch - r.t_submit)
            # quality-certificate telemetry (certify=True dispatches only):
            # per-request gap / CI-width histograms plus p95 gauges, so a
            # scrape sees serving quality next to serving latency
            cert_seen = False
            for sol in sols:
                cert = sol.certificate
                if cert is None:
                    continue
                cert_seen = True
                gap = float(cert.gap)
                if np.isfinite(gap):
                    self.metrics.observe("serve.cert_gap", gap)
                width = float(cert.ci_width)
                if np.isfinite(width):
                    self.metrics.observe("serve.cert_ci_width", width)
            if cert_seen:
                self.metrics.gauge(
                    "ot_cert_gap_p95",
                    self.metrics.get_histogram("serve.cert_gap")["p95"],
                )
                self.metrics.gauge(
                    "ot_cert_ci_width_p95",
                    self.metrics.get_histogram("serve.cert_ci_width")["p95"],
                )
        for r, sol in zip(reqs, sols):
            if self.robust and not sol.recovered:
                # the ladder ran dry: surface the honest history as a typed
                # failure — never a degenerate result dressed up as success
                r.future.set_exception(UnrecoverableSolve(sol))
            else:
                r.future.set_result(sol)
        return True

    # --------------------------------------------------------------- stats

    def reset_stats(self) -> None:
        """Atomically zero the serving counters and latency/fill histograms
        (keeps the executor's cache and ``executor.*`` metrics)."""
        with self.metrics.locked():
            self.batches_dispatched = 0
            self.requests_served = 0
            self.metrics.reset("serve.")

    def stats(self) -> dict:
        with self.metrics.locked():
            lat = self.metrics.get_histogram("serve.latency_seconds")
            wait = self.metrics.get_histogram("serve.queue_wait_seconds")
            requests = self.requests_served
            batches = self.batches_dispatched
        return {
            "requests": requests,
            "batches": batches,
            "mean_batch": requests / max(batches, 1),
            "p50_latency_s": lat["p50"],
            "p95_latency_s": lat["p95"],
            "p99_latency_s": lat["p99"],
            "mean_queue_wait_s": wait["mean"],
            "compiles": self.executor.compile_count,
        }


# --------------------------------------------------------------------------
# CLI: synthetic traffic generator
# --------------------------------------------------------------------------


def _make_request_problems(n_requests: int, sizes, seed: int,
                           point_cloud: bool = False, device=None):
    """Synthetic mixed OT/UOT traffic on ``device`` (``None`` means the
    card): even requests OT, odd ones UOT with masses 5/3 and ``lam`` 0.5,
    ``eps`` 0.1, points uniform in [0, 1]^3. ``point_cloud=True`` builds
    guarded `PointCloudGeometry` problems (needed by the matrix-free
    ``spar_sink_mf`` method: raw costs, no normalization pass)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    problems = []
    for i in range(n_requests):
        n = int(rng.choice(sizes))
        x = rng.uniform(size=(n, 3))
        a = rng.dirichlet(np.ones(n))
        b = rng.dirichlet(np.ones(n))
        if point_cloud:
            geom = PointCloudGeometry(x, device=dev)
        else:
            geom = Geometry.from_points(x, normalize=True, device=dev)
        if i % 2:
            problems.append(UOTProblem(geom, a * 5.0, b * 3.0, 0.1, lam=0.5))
        else:
            problems.append(OTProblem(geom, a, b, 0.1))
    return problems


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--deadline-ms", type=float, default=20.0)
    ap.add_argument("--method", default="spar_sink_coo")
    ap.add_argument("--sizes", default="96,128,200,256")
    ap.add_argument("--s-mult", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--robust", action="store_true",
                    help="serve under the repro_torch.robust escalation ladder")
    ap.add_argument("--serial", action="store_true",
                    help="also time the stream as per-problem solve() calls")
    ap.add_argument("--no-warmup", action="store_true",
                    help="include the first dispatches (cache fills) in the timed run")
    ap.add_argument("--device", default=None,
                    help="where the problems live (default: the CUDA card)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    sizes = [int(v) for v in args.sizes.split(",")]
    problems = _make_request_problems(
        args.requests, sizes, args.seed,
        point_cloud=args.method == "spar_sink_mf", device=device,
    )
    opts: dict = {"max_iter": 2000}
    # every sketching method needs a random source + budget (spar_sink_coo,
    # the log-domain spar_sink_log, matrix-free spar_sink_mf)
    keyed = args.method.startswith("spar_sink") or args.method == "rand_sink"
    if keyed:
        opts["s"] = args.s_mult * s0(max(sizes))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    server = OTServer(
        max_batch=args.max_batch, deadline_s=args.deadline_ms / 1e3,
        robust=args.robust,
    )

    def run_stream():
        t0 = time.perf_counter()
        futures = []
        for i, p in enumerate(problems):
            s = {"seed": i} if keyed else {}
            futures.append(server.submit(p, method=args.method, **s, **opts))
        values = [float(f.result().value) for f in futures]
        return values, time.perf_counter() - t0

    with server:
        if not args.no_warmup:
            run_stream()  # fill the executor's cache (steady-state numbers)
            server.reset_stats()
        values, dt = run_stream()
    st = server.stats()
    print(f"served {st['requests']} requests in {dt:.2f}s "
          f"({st['requests'] / dt:.1f} req/s) over {st['batches']} batches "
          f"(mean occupancy {st['mean_batch']:.1f}, "
          f"{st['compiles']} compiles) on {device}")
    print(f"latency p50={st['p50_latency_s'] * 1e3:.0f}ms "
          f"p95={st['p95_latency_s'] * 1e3:.0f}ms "
          f"p99={st['p99_latency_s'] * 1e3:.0f}ms; "
          f"sample values: {np.round(values[:4], 4).tolist()}")

    if args.serial:
        sync()
        t0 = time.perf_counter()
        for i, p in enumerate(problems):
            kw = dict(opts)
            if keyed:
                kw["seed"] = i
            float(solve(p, method=args.method, **kw).value)
        dt_serial = time.perf_counter() - t0
        print(f"serial loop: {dt_serial:.2f}s "
              f"({args.requests / dt_serial:.1f} req/s) — "
              f"batched speedup {dt_serial / dt:.1f}x")


if __name__ == "__main__":
    main()
