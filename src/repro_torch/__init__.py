"""PyTorch/CUDA port of the Spar-Sink package ``repro`` for one NVIDIA H100.

The main path is the paper's matrix-free estimator:
``solve(problem, method="spar_sink_mf")`` on an `OTProblem`/`UOTProblem`
over a `PointCloudGeometry`, with the dense ``dense``/``log`` solvers as
its accuracy oracle. The other sketch solvers (``spar_sink_coo``, the
paper's estimator as it writes it, ``spar_sink_log``, ``spar_sink_dense``,
``spar_sink_block_ell``) and the paper's competitors (``rand_sink``,
``greenkhorn``, ``nys_sink``, ``screenkhorn_lite``) share `solve`;
``available_methods()`` lists all eleven. Every method takes ``certify=``
and all but the three competitors ``trace=``, both of which fill
``Solution.diagnostics`` (`repro_torch.obs`). Built on `solve`: the
Sinkhorn divergence and fixed-support barycenters (IBP, Spar-IBP). Entry
points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"`` or CPU tensors); see `repro_torch._device`.
"""
from repro_torch import obs
from repro_torch.core.api import (
    DEFAULT_TOL,
    Geometry,
    InvalidProblem,
    OTProblem,
    PointCloudGeometry,
    Solution,
    SparsePlan,
    UOTProblem,
    available_methods,
    build_block_ell_sketch,
    build_coo_log_sketch,
    build_coo_sketch,
    build_mf_log_sketch,
    build_mf_sketch,
    get_solver,
    mix_uniform,
    register_solver,
    sampling_probs,
    solve,
)
from repro_torch.core.barycenter import ibp, solve_barycenter, spar_ibp
from repro_torch.core.baselines import greenkhorn, nys_sink, screenkhorn_lite
from repro_torch.core.divergence import sinkhorn_divergence, spar_sink_divergence
from repro_torch.core.geometry import grid_support_2d
from repro_torch.core.spar_sink import SparSinkSolution, default_cap, s0, spar_sink_ot, spar_sink_uot
from repro_torch.core.sparsify import uniform_prob_factors

__all__ = [
    "DEFAULT_TOL",
    "Geometry",
    "InvalidProblem",
    "OTProblem",
    "PointCloudGeometry",
    "Solution",
    "SparSinkSolution",
    "SparsePlan",
    "UOTProblem",
    "available_methods",
    "build_block_ell_sketch",
    "build_coo_log_sketch",
    "build_coo_sketch",
    "build_mf_log_sketch",
    "build_mf_sketch",
    "default_cap",
    "get_solver",
    "greenkhorn",
    "grid_support_2d",
    "ibp",
    "mix_uniform",
    "nys_sink",
    "obs",
    "register_solver",
    "s0",
    "sampling_probs",
    "screenkhorn_lite",
    "sinkhorn_divergence",
    "solve",
    "solve_barycenter",
    "spar_ibp",
    "spar_sink_divergence",
    "spar_sink_ot",
    "spar_sink_uot",
    "uniform_prob_factors",
]
