"""Batched OT execution engine: B independent problems a dispatch.

    from repro_torch.batch import BucketedExecutor
    from repro_torch import OTProblem, PointCloudGeometry, s0

    executor = BucketedExecutor()
    sols = executor.solve_batch(problems, method="spar_sink_mf",
                                seeds=range(len(problems)), s=8 * s0(512))
    sols[0].value, sols[0].plan()   # ordinary Solutions, O(cap) plans

The port of ``repro.batch``, with its names. Layers:

* `repro_torch.batch.problems`: `BatchedProblem` padded batches + shape buckets
* `repro_torch.batch.solvers`: whole-batch solvers (dense / log / fixed-cap
  batched COO Spar-Sink, scaling and log domain, matrix-free) behind
  `register_batched_solver`
* `repro_torch.batch.executor`: `BucketedExecutor`, an LRU cache keyed on
  (bucket shape, method, static options)
* `repro_torch.launch.serve_ot`: the microbatching request-queue server
"""
from repro_torch.batch.executor import BucketedExecutor
from repro_torch.batch.problems import BatchedProblem, bucket_shape, group_by_bucket
from repro_torch.batch.solvers import (
    BatchedResult,
    BatchedSketch,
    batchable_methods,
    batched_coo_sketch,
    batched_log_loop,
    batched_scaling_loop,
    batched_sparse_log_loop,
    build_batched_log_sketch,
    build_batched_mf_log_sketch,
    build_batched_mf_sketch,
    build_batched_sketch,
    get_batched_solver,
    register_batched_solver,
    sparse_log_potentials,
)

__all__ = [
    "BatchedProblem",
    "BatchedResult",
    "BatchedSketch",
    "BucketedExecutor",
    "batchable_methods",
    "batched_coo_sketch",
    "batched_log_loop",
    "batched_scaling_loop",
    "batched_sparse_log_loop",
    "bucket_shape",
    "build_batched_log_sketch",
    "build_batched_mf_log_sketch",
    "build_batched_mf_sketch",
    "build_batched_sketch",
    "get_batched_solver",
    "group_by_bucket",
    "register_batched_solver",
    "sparse_log_potentials",
]
