"""The port's slice end to end: ``solve(..., method="spar_sink_mf")``.

* Accuracy against the reference: over 6 seeds at n=256, s=16 s0, the
  port's mean relative error against the dense value stays below
  ``max(2 x JAX's, 0.25)`` on the same seeds (the bound of the reference's
  ``test_mf_value_within_sampling_noise``): OT in both domains, and UOT.
* The Õ(n) guard: at n = 2^17, s = 1e5 and ``max_iter=2`` no tensor that
  the solve allocates, in either domain, reaches 100 n elements.
* The `Solution` contract of a sketch solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.api import Geometry as JGeometry
from repro.core.api import OTProblem as JOTProblem
from repro.core.api import PointCloudGeometry as JPointCloudGeometry
from repro.core.api import UOTProblem as JUOTProblem
from repro.core.api import solve as jsolve
from repro_torch import s0
from repro_torch.core.api import Geometry, OTProblem, PointCloudGeometry, SparsePlan, UOTProblem, solve
from repro_torch.core.sinkhorn import STATUS_LABELS

EPS = 0.1
N = 256


def _points(n, d=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, d)), rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))


def _pair(kind):
    """(port problem, port dense problem, JAX mf problem, JAX dense problem)."""
    x, a, b = _points(N)
    if kind == "ot":
        return (
            OTProblem(PointCloudGeometry(x, device="cpu"), a, b, EPS),
            OTProblem(Geometry.from_points(x, device="cpu"), a, b, EPS),
            JOTProblem(JPointCloudGeometry(jnp.asarray(x)), jnp.asarray(a), jnp.asarray(b), EPS),
            JOTProblem(JGeometry.from_points(jnp.asarray(x)), jnp.asarray(a), jnp.asarray(b), EPS),
        )
    a, b = 5 * a, 3 * b
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    return (
        UOTProblem(PointCloudGeometry(x, cost="wfr", eta=0.5, device="cpu"), a, b, EPS, lam=0.5),
        UOTProblem(Geometry.wfr(x, eta=0.5, device="cpu"), a, b, EPS, lam=0.5),
        JUOTProblem(JPointCloudGeometry(jnp.asarray(x), cost="wfr", eta=0.5), ja, jb, EPS, lam=0.5),
        JUOTProblem(JGeometry.wfr(jnp.asarray(x), eta=0.5), ja, jb, EPS, lam=0.5),
    )


@pytest.mark.parametrize("kind,stabilize", [("ot", False), ("ot", True), ("uot", False)],
                         ids=["ot-scaling", "ot-log", "uot"])
def test_mf_value_within_reference_sampling_noise(kind, stabilize):
    tp, tdense, jp, jdense = _pair(kind)
    opts = dict(s=16 * s0(N), tol=1e-9, max_iter=20_000, stabilize=stabilize)
    truth_t = float(solve(tdense, method="dense", tol=1e-9, max_iter=20_000).value)
    truth_j = float(jsolve(jdense, method="dense", tol=1e-9, max_iter=20_000).value)
    np.testing.assert_allclose(truth_t, truth_j, rtol=1e-10)
    sols = [solve(tp, method="spar_sink_mf", seed=i, **opts) for i in range(6)]
    err_t = np.mean([abs(float(s.value) - truth_t) / abs(truth_t) for s in sols])
    err_j = np.mean([
        abs(float(jsolve(jp, method="spar_sink_mf", key=jax.random.PRNGKey(i), **opts).value)
            - truth_j) / abs(truth_j)
        for i in range(6)
    ])
    assert all(np.isfinite(float(s.value)) and not bool(s.overflowed) for s in sols)
    assert err_t < max(2.0 * err_j, 0.25), (err_t, err_j)


class _LargestAllocation(TorchDispatchMode):
    """Records the element count of the largest tensor any op produces."""

    def __init__(self):
        super().__init__()
        self.biggest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.biggest = max(self.biggest, t.numel())
        return out


@pytest.mark.parametrize("stabilize", [False, True], ids=["scaling", "log"])
def test_mf_solve_never_allocates_n_squared(stabilize):
    """The Õ(n) guarantee (the bound of the reference's
    ``test_mf_solve_never_allocates_n_squared``): sketch, iteration and
    objective at n = 2^17 allocate nothing near n*m = 1.7e10 elements."""
    n = 2 ** 17
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(size=(n, 2)), dtype=torch.float32)
    a = torch.as_tensor(rng.dirichlet(np.ones(n)))
    b = torch.as_tensor(rng.dirichlet(np.ones(n)))
    problem = OTProblem(PointCloudGeometry(x), a, b, EPS if not stabilize else 1e-3)
    with _LargestAllocation() as mode:
        sol = solve(problem, method="spar_sink_mf", seed=0, s=100_000.0, tol=1e-3,
                    max_iter=2, stabilize=stabilize)
        value = float(sol.value)
    assert np.isfinite(value) and int(sol.nnz) > 0
    assert mode.biggest < 100 * n, mode.biggest  # O(n + cap)


def test_sketch_solution_contract():
    tp, _, _, _ = _pair("ot")
    sol = solve(tp, method="spar_sink_mf", seed=3, s=16 * s0(N), tol=1e-9, max_iter=5000)
    again = solve(tp, method="spar_sink_mf", generator=torch.Generator().manual_seed(3),
                  s=16 * s0(N), tol=1e-9, max_iter=5000)
    assert float(sol.value) == float(again.value)  # seed= builds the same generator
    assert int(sol.n_iter) == int(again.n_iter)
    assert sol.status_label in STATUS_LABELS and sol.domain == "scaling"
    assert sol.diagnostics is None and sol.certificate is None
    plan = sol.plan()
    assert isinstance(plan, SparsePlan) and plan.cap == plan.rows.shape[0]
    dense = sol.plan(dense=True)
    assert dense.shape == (N, N)
    rows, cols = sol.marginals()
    torch.testing.assert_close(rows, dense.sum(1), rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(cols, dense.sum(0), rtol=1e-12, atol=1e-15)
    f, g = sol.potentials
    u, v = sol.scalings
    torch.testing.assert_close(torch.exp(f[u > 0] / EPS), u[u > 0], rtol=1e-12, atol=0)
    assert torch.isneginf(g[v == 0]).all()
    log_sol = solve(tp, method="spar_sink_mf", seed=3, s=16 * s0(N), tol=1e-9,
                    max_iter=5000, stabilize=True)
    assert log_sol.domain == "log"
    torch.testing.assert_close(log_sol.plan().vals.sum(), log_sol.plan(dense=True).sum())
