"""repro_torch.obs: solver traces, quality certificates and host-side metrics.

The port of ``repro.obs``, with its names:

* `trace`: ring-buffer iteration telemetry carried through the Sinkhorn
  loops (`SolverTrace`), sketch-quality stats (`SketchStats`) and the
  per-solve `Diagnostics` record (``Solution.diagnostics``). Enable with
  ``solve(..., trace=True)``; the ``trace=False`` default dispatches no
  extra op (guarded by tests).
* `certify`: a posteriori quality certificates (`Certificate`: duality
  gap, marginal-violation bound, importance-sampling confidence interval)
  in O(nnz + n) from converged potentials. Enable with
  ``solve(..., certify=True)``.
* `metrics`: a thread-safe `MetricsRegistry` (counters, gauges,
  p50/p95/p99 histograms) and `export` to JSON or Prometheus text.
* `spans`: where each layer's time goes. `solve`, the sketch
  (``solve.sketch``), the loop's set-up (``sinkhorn.setup``) and the
  Sinkhorn loop (``sinkhorn.loop``, with its ``launched``/``element_iters``
  counts), the objective (``solve.value``), the executor's dispatch and its
  sketch (``executor.dispatch``, ``executor.sketch``) and the server
  (``serve.batch``, and ``serve.queue`` a request) each record a
  `Span`: host start and end on `time.perf_counter`, parent and trace ids,
  CUDA events for its device time, counts. Recording is off unless inside
  `recording()` or a `torch.profiler` session; off, a span site records
  nothing and creates no CUDA event (guarded by tests).
"""
from repro_torch.obs.certify import (
    DEFAULT_Z,
    Certificate,
    dense_certificate,
    importance_ess,
    sparse_certificate,
)
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    HISTOGRAM_WINDOW,
    MetricsRegistry,
    default_registry,
    export,
)
from repro_torch.obs.spans import Span, recording
from repro_torch.obs.trace import (
    DEFAULT_TRACE_LEN,
    Diagnostics,
    SketchStats,
    SolverTrace,
    empty_trace,
    record_iteration,
    resolve_trace_len,
    sketch_diagnostics,
    trim_trace,
)

__all__ = [
    "Certificate",
    "DEFAULT_BUCKETS",
    "DEFAULT_TRACE_LEN",
    "DEFAULT_Z",
    "Diagnostics",
    "HISTOGRAM_WINDOW",
    "MetricsRegistry",
    "SketchStats",
    "SolverTrace",
    "Span",
    "default_registry",
    "dense_certificate",
    "empty_trace",
    "export",
    "importance_ess",
    "record_iteration",
    "recording",
    "resolve_trace_len",
    "sketch_diagnostics",
    "sparse_certificate",
    "trim_trace",
]
