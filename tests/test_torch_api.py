"""The port's package boundary: import hygiene, the device rule, the
registry's errors and problem validation."""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread a process: the suite runs under six xdist workers, and
# torch's default of one thread a core would put 48 threads on 8 cores
torch.set_num_threads(1)

import repro_torch
from repro_torch import interop
from repro_torch.core.api import (
    Geometry,
    InvalidProblem,
    OTProblem,
    PointCloudGeometry,
    UOTProblem,
    available_methods,
    solve,
)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)|from repro\b(?!_torch))", re.M)


def test_import_pulls_in_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.interop, repro_torch.kernels, repro_torch.kernels.ops, "
        "repro_torch.kernels.library, repro_torch.kernels.gather_kernel, "
        "repro_torch.kernels.fused_sinkhorn, repro_torch.kernels.block_ell, repro_torch.kernels.ref, "
        "repro_torch.core.sparsify, repro_torch.core.spar_sink, repro_torch.data.pointclouds\n"
        "repro_torch.available_methods()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_no_source_of_the_port_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert not offenders


def test_numpy_data_without_device_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).uniform(size=(16, 2))
    a = np.full(16, 1 / 16)
    for build in (
        lambda: PointCloudGeometry(x),
        lambda: Geometry.from_points(x),
        lambda: OTProblem(np.ones((16, 16)), a, a, 0.1),
        lambda: interop.problem_from_numpy(x, a, a, 0.1),
        lambda: PointCloudGeometry(x, device="cuda"),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    # asking for the CPU, by device= or by CPU tensors, is honoured
    assert PointCloudGeometry(x, device="cpu").device.type == "cpu"
    geom = PointCloudGeometry(torch.as_tensor(x))
    problem = OTProblem(geom, a, a, 0.1)  # numpy marginals follow the geometry
    assert problem.a.device.type == "cpu" and problem.a.dtype == torch.float64


def _problem(kind="ot", n=32):
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(n, 2))
    a, b = rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))
    if kind == "ot":
        return OTProblem(PointCloudGeometry(x, device="cpu"), a, b, 0.1)
    return UOTProblem(PointCloudGeometry(x, device="cpu"), a, b, 0.1, lam=math.inf)


def test_registry_lists_methods_and_rejects_bad_calls():
    methods = ["dense", "greenkhorn", "log", "nys_sink", "rand_sink", "screenkhorn_lite",
               "spar_sink_block_ell", "spar_sink_coo", "spar_sink_dense", "spar_sink_log", "spar_sink_mf"]
    assert available_methods() == methods
    assert repro_torch.available_methods() == available_methods()
    problem = _problem()
    with pytest.raises(KeyError, match="available: " + ", ".join(methods)):
        solve(problem, method="sinkhorn_knopp")
    for opt in (dict(init=(None, None)), dict(key=0)):
        with pytest.raises(TypeError, match="unexpected option"):
            solve(problem, method="spar_sink_mf", s=100.0, seed=0, **opt)
    # the small-n test mode is an option of spar_sink_mf now
    sol = solve(problem, method="spar_sink_mf", s=100.0, seed=0, shared_variates=True)
    assert sol.method == "spar_sink_mf" and math.isfinite(float(sol.value)) and int(sol.nnz) > 0
    with pytest.raises(TypeError, match=r"requires option\(s\) \['s'\]"):
        solve(problem, method="spar_sink_mf", seed=0)
    with pytest.raises(TypeError, match="exactly one of generator"):
        solve(problem, method="spar_sink_mf", s=100.0)
    with pytest.raises(TypeError, match="PointCloudGeometry"):
        dense = OTProblem(Geometry.from_points(problem.geom.x), problem.a, problem.b, 0.1)
        solve(dense, method="spar_sink_mf", s=100.0, seed=0)


def test_uot_lam_inf_degenerates_to_ot():
    ot, uot = _problem("ot"), _problem("uot")
    assert uot.is_balanced and uot.fe == 1.0
    for method, opts in (("dense", {}), ("log", {}), ("spar_sink_mf", dict(s=400.0, seed=5))):
        v_ot = float(solve(ot, method=method, **opts).value)
        v_uot = float(solve(uot, method=method, **opts).value)
        assert v_ot == v_uot, method


def test_invalid_problems_are_refused():
    x = np.random.default_rng(2).uniform(size=(8, 2))
    a = np.full(8, 1 / 8)
    geom = PointCloudGeometry(x, device="cpu")
    for a_bad, eps, lam, match in (
        (np.where(np.arange(8) == 0, np.nan, a), 0.1, 1.0, "non-finite"),
        (-a, 0.1, 1.0, "negative"),
        (0 * a, 0.1, 1.0, "no mass"),
        (a, 0.0, 1.0, "eps must be"),
        (a, 0.1, -1.0, "lam must be"),
    ):
        with pytest.raises(InvalidProblem, match=match):
            UOTProblem(geom, a_bad, a, eps, lam=lam)
    bad_pts = PointCloudGeometry(np.where(x > 0.5, np.inf, x), device="cpu")
    with pytest.raises(InvalidProblem, match="point cloud"):
        OTProblem(bad_pts, a, a, 0.1)
    with pytest.raises(InvalidProblem, match="NaN or -inf"):
        OTProblem(Geometry(np.full((8, 8), -np.inf), device="cpu"), a, a, 0.1)
    unchecked = OTProblem(geom, -a, a, 0.1, validate=False)
    assert unchecked.a[0] < 0
