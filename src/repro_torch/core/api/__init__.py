"""The unified API: geometries, problems, `solve()` and `Solution`."""
from repro_torch.core.api.geometry import Geometry, PointCloudGeometry
from repro_torch.core.api.problems import InvalidProblem, OTProblem, UOTProblem
from repro_torch.core.api.registry import available_methods, get_solver, register_solver, solve
from repro_torch.core.api.solution import Solution, SparsePlan
from repro_torch.core.api.solvers import (
    DEFAULT_TOL,
    build_block_ell_sketch,
    build_coo_log_sketch,
    build_coo_sketch,
    build_mf_log_sketch,
    build_mf_sketch,
    mix_uniform,
    sampling_probs,
)

__all__ = [
    "DEFAULT_TOL",
    "Geometry",
    "InvalidProblem",
    "OTProblem",
    "PointCloudGeometry",
    "Solution",
    "SparsePlan",
    "UOTProblem",
    "available_methods",
    "build_block_ell_sketch",
    "build_coo_log_sketch",
    "build_coo_sketch",
    "build_mf_log_sketch",
    "build_mf_sketch",
    "get_solver",
    "mix_uniform",
    "register_solver",
    "sampling_probs",
    "solve",
]
