"""PyTorch/CUDA port of the Spar-Sink package ``repro`` for one NVIDIA H100.

The main path is the paper's matrix-free estimator:
``solve(problem, method="spar_sink_mf")`` on an `OTProblem`/`UOTProblem`
over a `PointCloudGeometry`, with the dense ``dense``/``log`` solvers as
its accuracy oracle; ``method="spar_sink_block_ell"`` draws the sketch at
tile granularity instead. Entry points run on the CUDA card unless the caller
asks for the CPU (``device="cpu"`` or CPU tensors); see `repro_torch._device`.
"""
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
    build_mf_log_sketch,
    build_mf_sketch,
    get_solver,
    register_solver,
    solve,
)
from repro_torch.core.spar_sink import default_cap, s0

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
    "build_mf_log_sketch",
    "build_mf_sketch",
    "default_cap",
    "get_solver",
    "register_solver",
    "s0",
    "solve",
]
