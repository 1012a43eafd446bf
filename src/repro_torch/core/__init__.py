"""Spar-Sink numerics on torch tensors: costs, loops, sketches, objectives,
the paper's competitors, and the composite workloads built on `solve`
(the Sinkhorn divergence, fixed-support barycenters, proximal OT).

The names of the reference's ``repro.core``, each the port's counterpart:
the unified API (`Geometry`, `OTProblem`/`UOTProblem`, `solve`,
`Solution`), the engine layer beneath it (cost builders, the Sinkhorn
loops and their statuses, plans and objectives, the sampling
probabilities) and the legacy free functions. Where the reference takes a
JAX ``key``, the port takes ``generator=`` (a `torch.Generator`) or
``seed=``.
"""
from repro_torch.core.geometry import (
    euclidean_cost,
    gibbs_kernel,
    grid_support_2d,
    log_gibbs_kernel,
    normalize_cost,
    squared_euclidean_cost,
    wfr_cost,
    wfr_log_kernel,
)
from repro_torch.core.sinkhorn import (
    STATUS_CONVERGED,
    STATUS_DEGENERATE,
    STATUS_LABELS,
    STATUS_MAX_ITER,
    STATUS_NONFINITE,
    STATUS_STALL,
    SinkhornResult,
    entropy,
    kl_divergence,
    ot_cost_from_plan,
    plan_from_potentials,
    plan_from_scalings,
    sinkhorn,
    sinkhorn_log,
    sinkhorn_uot,
    sinkhorn_uot_log,
    uot_cost_from_plan,
)
from repro_torch.core.spar_sink import (
    SparSinkSolution,
    default_cap,
    default_max_blocks,
    s0,
    spar_sink_ot,
    spar_sink_uot,
)
from repro_torch.core.sparsify import (
    ot_sampling_probs,
    uniform_prob_factors,
    uniform_probs,
    uot_sampling_probs,
)
from repro_torch.core.api import (
    Geometry,
    InvalidProblem,
    OTProblem,
    PointCloudGeometry,
    Solution,
    SparsePlan,
    UOTProblem,
    available_methods,
    build_coo_log_sketch,
    build_coo_sketch,
    build_mf_log_sketch,
    build_mf_sketch,
    register_solver,
    solve,
)
from repro_torch.core.barycenter import ibp, solve_barycenter, spar_ibp
from repro_torch.core.baselines import greenkhorn, nys_sink, screenkhorn_lite
from repro_torch.core.divergence import sinkhorn_divergence, spar_sink_divergence

__all__ = [
    "Geometry",
    "InvalidProblem",
    "OTProblem",
    "PointCloudGeometry",
    "STATUS_CONVERGED",
    "STATUS_DEGENERATE",
    "STATUS_LABELS",
    "STATUS_MAX_ITER",
    "STATUS_NONFINITE",
    "STATUS_STALL",
    "SinkhornResult",
    "Solution",
    "SparSinkSolution",
    "SparsePlan",
    "UOTProblem",
    "available_methods",
    "build_coo_log_sketch",
    "build_coo_sketch",
    "build_mf_log_sketch",
    "build_mf_sketch",
    "default_cap",
    "default_max_blocks",
    "entropy",
    "euclidean_cost",
    "gibbs_kernel",
    "greenkhorn",
    "grid_support_2d",
    "ibp",
    "kl_divergence",
    "log_gibbs_kernel",
    "normalize_cost",
    "nys_sink",
    "ot_cost_from_plan",
    "ot_sampling_probs",
    "plan_from_potentials",
    "plan_from_scalings",
    "register_solver",
    "s0",
    "screenkhorn_lite",
    "sinkhorn",
    "sinkhorn_divergence",
    "sinkhorn_log",
    "sinkhorn_uot",
    "sinkhorn_uot_log",
    "solve",
    "solve_barycenter",
    "spar_ibp",
    "spar_sink_divergence",
    "spar_sink_ot",
    "spar_sink_uot",
    "squared_euclidean_cost",
    "uniform_prob_factors",
    "uniform_probs",
    "uot_cost_from_plan",
    "uot_sampling_probs",
    "wfr_cost",
    "wfr_log_kernel",
]
