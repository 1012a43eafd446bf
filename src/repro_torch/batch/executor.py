"""`BucketedExecutor`: shape-bucketed, cached batched OT dispatch.

The port of ``repro.batch.executor``. One dispatch solves B independent
problems:

    executor = BucketedExecutor()
    solutions = executor.solve_batch(problems, method="spar_sink_mf",
                                     seeds=[0, 1, ...], s=8 * s0(n))

* problems are grouped into power-of-two shape buckets (`bucket_shape`)
  and padded with inert mass-0 rows (`BatchedProblem`);
* each (bucket shape, method, static options) triple fills **one** entry
  of an LRU cache: the batched solver bound to its options, a callable that
  costs nothing to build, since nothing is compiled (`compile_count` keeps
  the reference's name and counts the fills; a repeat dispatch adds none).
  The entry is where a CUDA graph of the bucket's iterations would live
  (ROADMAP D-14);
* every request comes back as an ordinary `Solution` sliced to its true
  support (an O(cap) `SparsePlan` for sketch solves), so downstream code
  cannot tell batched execution from per-problem ``solve()``.

Randomness: where the reference takes one PRNG key a problem (``keys=``),
the port takes ``generators=`` (one `torch.Generator` a problem, on the
problems' device) or ``seeds=``, as ``solve(generator=, seed=)`` does.
The batch runs where the problems lie: there is no CPU fallback.
"""
from __future__ import annotations

import functools
import time
from collections import OrderedDict
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import local_map

from repro_torch._device import generator_at, make_generator
from repro_torch.batch.problems import BatchedProblem, group_by_bucket
from repro_torch.batch.solvers import (
    BatchedResult,
    BatchedSketch,
    build_batched_log_sketch,
    build_batched_mf_log_sketch,
    build_batched_mf_sketch,
    build_batched_sketch,
    get_batched_solver,
)
from repro_torch.core.api.problems import OTProblem
from repro_torch.core.api.solution import Solution, SparsePlan
from repro_torch.core.sinkhorn import SinkhornResult, plan_from_potentials, plan_from_scalings
from repro_torch.core.spar_sink import log_plan_entries
from repro_torch.core.sparsify import LogSparseKernelCOO
from repro_torch.distributed.sharding import leading_axis_specs
from repro_torch.obs import spans
from repro_torch.obs.certify import Certificate
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import SolverTrace

__all__ = ["BucketedExecutor"]

_NEEDS_KEY = frozenset({"spar_sink_coo", "spar_sink_log", "spar_sink_mf"})
_LOG_DOMAIN = frozenset({"log"})
# methods whose batched solver never reads bp.cost: the batch is assembled
# without the (B, n, m) array
_COSTLESS = frozenset({"spar_sink_log", "spar_sink_mf"})


def _next_pow2(v: int) -> int:
    b = 1
    while b < v:
        b *= 2
    return b


class BucketedExecutor:
    """Batched OT execution engine with a bounded cache.

    Parameters
    ----------
    cache_size:
        Max number of live cache entries (LRU-evicted beyond that), one a
        (bucket shape, method, static options) specialization.
    min_bucket:
        Smallest bucket edge; supports are padded up to powers of two of at
        least this size.
    mesh:
        Optional `DeviceMesh` (from `repro_torch.launch.mesh`): the batch
        axis of each bucket's padded batch is laid out by
        `leading_axis_specs` over the mesh's data axes. A batched problem's
        sketch is flat and sorted across its elements, and the sorted-segment
        reductions have no DTensor rule, so the batch is split by problem:
        under `local_map` each data rank solves its elements' sub-batch
        (each element still padded to `SLOT_ALIGN` slots, so every solve
        stays bitwise its per-problem one), and the ranks' results are
        gathered (``all_gather_object``). Every rank of the mesh must call
        `solve_batch` with the same problems and random sources; each
        returns every solution. A batch axis the data ranks do not divide is
        replicated: every rank solves it all.
    metrics:
        `repro_torch.obs.MetricsRegistry` receiving the executor telemetry
        (default `repro_torch.obs.default_registry`): counters
        ``executor.cache_hit`` / ``executor.cache_miss`` (a cache fill:
        nothing is traced or compiled), histograms
        ``executor.bucket_occupancy`` (live fraction of the padded batch
        axis), ``executor.padding_waste`` (1 - true elements / padded
        elements a dispatch) and ``executor.dispatch_seconds`` (from after
        the sketch build, which is not synced, to the device sync that ends
        the solve on the card), and the ``executor.cache_entries`` gauge.
        Spans (`repro_torch.obs.spans`, when recording): each bucket's
        ``executor.dispatch``, with ``executor.sketch`` (the bucket's
        sketches built and padded) and the loop's spans inside.
    """

    def __init__(
        self,
        *,
        cache_size: int = 16,
        min_bucket: int = 64,
        mesh=None,
        metrics: MetricsRegistry | None = None,
    ):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not {type(mesh).__name__}")
        self.mesh = mesh
        self.cache_size = cache_size
        self.min_bucket = min_bucket
        self.metrics = default_registry if metrics is None else metrics
        self._cache: OrderedDict[tuple, callable] = OrderedDict()
        self._fill_count = 0

    # --------------------------------------------------------------- cache

    @property
    def compile_count(self) -> int:
        """Number of cache fills so far, under the reference's name: a fill
        binds the solver to its options and compiles nothing (a repeat
        dispatch on a cached (bucket, method, options) adds none)."""
        return self._fill_count

    def _compiled(self, bucket: tuple[int, int], method: str, opts: dict):
        key = (bucket, method, tuple(sorted(opts.items())))
        fn = self._cache.get(key)
        if fn is not None:
            self._cache.move_to_end(key)
            self.metrics.counter("executor.cache_hit")
            return fn
        self.metrics.counter("executor.cache_miss")
        fn = functools.partial(get_batched_solver(method), **opts)
        self._fill_count += 1
        self._cache[key] = fn
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        self.metrics.gauge("executor.cache_entries", float(len(self._cache)))
        return fn

    # ------------------------------------------------------------ dispatch

    @staticmethod
    def _generators(problems, generators, seeds) -> list[torch.Generator] | None:
        if generators is not None and seeds is not None:
            raise TypeError("pass generators= or seeds=, not both")
        given = generators if generators is not None else seeds
        if given is None:
            return None
        if len(given) != len(problems):
            raise ValueError(f"got {len(given)} generators/seeds for {len(problems)} problems")
        if generators is not None:
            return [make_generator(p.device, g) for p, g in zip(problems, generators)]
        return [make_generator(p.device, seed=sd) for p, sd in zip(problems, seeds)]

    def solve_batch(
        self,
        problems: Sequence[OTProblem],
        *,
        method: str = "spar_sink_coo",
        generators: Sequence[torch.Generator] | None = None,
        seeds: Sequence[int] | None = None,
        robust: bool = False,
        policy=None,
        **opts,
    ) -> list[Solution]:
        """Solve B problems; returns per-problem `Solution`s in input order.

        The sketching methods need one random source a problem:
        ``generators`` (torch Generators on the problems' device) or
        ``seeds``; other methods ignore them. ``s`` and ``cap`` drive each
        group's sketch build (``cap`` may also be one capacity a problem);
        the other options (``tol``, ``max_iter``, ``stabilize``, ...) are
        bound into the cached entry, keyed on (bucket shape, method,
        options).

        ``robust=True`` inspects every element after the dispatch and runs
        the `repro_torch.robust` escalation ladder on the failed ones only:
        the batch stays one dispatch, and only failures pay for
        per-problem recovery solves. Returns `RobustSolution`s then (happy
        elements wrap their batched `Solution` with a one-attempt history).
        """
        problems = list(problems)
        gens = self._generators(problems, generators, seeds)
        ladder_opts = dict(opts) if (robust or policy is not None) else None
        solver_opts = dict(opts)
        sketch_args = None
        if method in _NEEDS_KEY:
            if gens is None:
                raise TypeError(f"method {method!r} requires per-problem generators= or seeds=")
            if "s" not in solver_opts:
                raise TypeError(f"method {method!r} requires option 's'")
            sketch_args = (solver_opts.pop("s"), solver_opts.pop("cap", None))
        caps = sketch_args[1] if sketch_args is not None else None
        per_problem_caps = caps is not None and not isinstance(caps, int)
        # the ladder's rungs draw from each source as attempt 0 found it
        starts = [g.get_state() for g in gens] if ladder_opts is not None and gens is not None else None
        out: list[Solution | None] = [None] * len(problems)
        log_sparse = method == "spar_sink_log" or (method == "spar_sink_mf" and bool(solver_opts.get("stabilize")))
        for bucket, idxs in group_by_bucket(problems, min_size=self.min_bucket).items():
            group = [problems[i] for i in idxs]
            ggens = [gens[i] for i in idxs] if gens is not None else None
            gcaps = [caps[i] for i in idxs] if per_problem_caps else caps
            sketch = None if sketch_args is None else (sketch_args[0], gcaps)
            if self.mesh is not None:
                sols = self._solve_on_mesh(method, bucket, group, ggens, sketch, solver_opts, log_sparse)
            else:
                br, elem_caps = self._dispatch_group(method, bucket, group, ggens, sketch, solver_opts)
                sols = [self._solution(method, p, br, j, log_sparse, elem_caps[j]) for j, p in enumerate(group)]
            for i, sol in zip(idxs, sols):
                out[i] = sol
        if ladder_opts is None:
            return out  # type: ignore[return-value]
        from repro_torch.robust.ladder import escalate_from

        robust_out = []
        for i, sol in enumerate(out):
            opts_i = dict(ladder_opts)
            if per_problem_caps:
                opts_i["cap"] = caps[i]
            if generators is not None:
                opts_i["generator"] = generator_at(gens[i], starts[i])
            elif seeds is not None:
                opts_i["seed"] = seeds[i]
            robust_out.append(escalate_from(problems[i], method, sol, policy=policy, metrics=self.metrics, **opts_i))
        return robust_out  # type: ignore[return-value]

    def _solve_on_mesh(self, method, bucket, group, gens, sketch_args, solver_opts, log_sparse) -> list[Solution]:
        """One bucket on the mesh: the padded batch axis laid out by
        `leading_axis_specs`, each data rank's sub-batch solved under
        `local_map`, the results gathered; returns ``group``'s solutions."""
        elements = torch.arange(_next_pow2(len(group)))
        placements = list(leading_axis_specs(self.mesh, {"b": elements})["b"])
        mine = distribute_tensor(elements, self.mesh, placements, src_data_rank=None)
        caps = sketch_args[1] if sketch_args is not None else None

        def solve_mine(local: torch.Tensor):
            # pads repeat the last element: a rank solves its real elements only
            ids = [j for j in local.tolist() if j < len(group)]
            if not ids:
                return _Solved(ids, None, [])
            sub_sketch = None if sketch_args is None else (
                sketch_args[0], [caps[j] for j in ids] if isinstance(caps, list) else caps)
            br, elem_caps = self._dispatch_group(method, bucket, [group[j] for j in ids],
                                                 [gens[j] for j in ids] if gens is not None else None,
                                                 sub_sketch, solver_opts)
            return _Solved(ids, br, elem_caps)

        solved = local_map(solve_mine, out_placements=None, in_placements=(placements,), device_mesh=self.mesh)(mine)
        # the solutions hold closures: gather the batched results, rebuild here
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, solved)
        out: dict[int, Solution] = {}
        for part in gathered:
            for k, j in enumerate(part.ids):
                if j not in out:
                    out[j] = self._solution(method, group[j], part.result, k, log_sparse, part.caps[k])
        return [out[j] for j in range(len(group))]

    def _dispatch_group(self, method, bucket, group, gens, sketch_args, solver_opts):
        """One bucket's batch: the problems padded to a power of two with
        duplicates of the last (B is then drawn from a small set), the
        unique sketches built (pad slots reuse the last element's), one
        cached solve. Returns ``(BatchedResult, each element's sketch cap
        or None)``."""
        pad = _next_pow2(len(group)) - len(group)
        b_pad = len(group) + pad
        dev = group[0].device
        with spans.span("executor.dispatch", device=dev):
            bp = BatchedProblem.from_problems(
                group + [group[-1]] * pad, bucket=bucket, materialize_cost=method not in _COSTLESS,
            )
            aux = None
            if sketch_args is not None:
                s, cap = sketch_args
                with spans.span("executor.sketch", device=dev):
                    aux = self._sketch_builder(method, solver_opts)(group, gens, s, cap)
                    if pad:
                        aux = _repeat_last(aux, pad)
            true_elems = sum(p.shape[0] * p.shape[1] for p in group)
            self.metrics.observe("executor.bucket_occupancy", len(group) / b_pad)
            self.metrics.observe("executor.padding_waste", 1.0 - true_elems / (b_pad * bucket[0] * bucket[1]))
            t0 = time.perf_counter()
            br = self._compiled(bucket, method, solver_opts)(bp, aux)
            if bp.device.type == "cuda":
                torch.cuda.synchronize(bp.device)
            self.metrics.observe("executor.dispatch_seconds", time.perf_counter() - t0)
        return br, [aux.element_cap(j) if aux is not None else None for j in range(len(group))]

    @staticmethod
    def _sketch_builder(method: str, solver_opts: dict):
        """Sketch construction per method (and its static options)."""
        if method == "spar_sink_log":
            return build_batched_log_sketch
        if method == "spar_sink_mf":
            return build_batched_mf_log_sketch if solver_opts.get("stabilize") else build_batched_mf_sketch
        return build_batched_sketch

    # ------------------------------------------------------------ assembly

    @staticmethod
    def _solution(method: str, problem: OTProblem, br: BatchedResult, j: int, log_sparse: bool,
                  cap: int | None) -> Solution:
        n, m = problem.shape
        status = br.status[j] if br.status is not None else None
        tr = None
        if br.trace is not None:
            tr = SolverTrace(br.trace.err[j], br.trace.marg[j], br.trace.n_matvec[j])
        res = SinkhornResult(br.u[j, :n], br.v[j, :m], br.n_iter[j], br.err[j], status, tr)
        cert = None if br.certificate is None else Certificate(*(field[j] for field in br.certificate))
        if br.rows is not None:
            rows, cols, vals, nnz = br.rows[j, :cap], br.cols[j, :cap], br.vals[j, :cap], br.nnz[j]

            # everything the thunk needs is bound as defaults, so a long-lived
            # Solution pins only its own O(cap) slices, not the whole batch
            if log_sparse:
                eps = float(problem.eps)

                def sparse_plan(res=res, rows=rows, cols=cols, vals=vals, nnz=nnz, n=n, m=m, eps=eps):
                    sk = LogSparseKernelCOO(rows, cols, vals, nnz, n, m)
                    return SparsePlan(rows, cols, log_plan_entries(sk, res, eps), nnz, n, m)

            else:

                def sparse_plan(res=res, rows=rows, cols=cols, vals=vals, nnz=nnz, n=n, m=m):
                    return SparsePlan(rows, cols, res.u[rows] * vals * res.v[cols], nnz, n, m)

            return Solution(
                method=method, problem=problem, value=br.value[j], result=res,
                domain="log" if log_sparse else "scaling", nnz=nnz,
                overflowed=br.overflowed[j] if br.overflowed is not None else None,
                certificate=cert, _plan_thunk=sparse_plan,
            )
        if method in _LOG_DOMAIN:
            def thunk(res=res, p=problem):
                return plan_from_potentials(res.u, p.log_kernel(), res.v, float(p.eps))

            domain = "log"
        else:
            def thunk(res=res, p=problem):
                return plan_from_scalings(res.u, p.kernel(), res.v)

            domain = "scaling"
        return Solution(method=method, problem=problem, value=br.value[j], result=res, domain=domain,
                        certificate=cert, _plan_thunk=thunk)


class _Solved:
    """A rank's batched result and the element indices it holds: one opaque
    output of `local_map` (not a tree of tensors to place)."""

    def __init__(self, ids: list[int], result: BatchedResult | None, caps: list):
        self.ids, self.result, self.caps = ids, result, caps


def _repeat_last(sketch: BatchedSketch, pad: int) -> BatchedSketch:
    """The sketch with ``pad`` more elements, each a copy of the last."""

    def rep(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return x + (x[-1],) * pad
        return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])

    return BatchedSketch(*(rep(field) for field in sketch))
