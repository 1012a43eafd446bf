"""Quickstart: approximate entropic OT and UOT distances with Spar-Sink
through the unified Geometry/Problem/Solver API, on the PyTorch port.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu] [--n 1000]

The counterpart of ``examples/quickstart.py``. The three core objects:

* ``Geometry``   — ground cost; lazily builds K = exp(-C/eps) per eps
* ``OTProblem``/``UOTProblem`` — marginals + regularization on a Geometry
* ``solve(problem, method=...)`` — one front end over every solver; returns
  a ``Solution`` with ``.value``, ``.potentials``, ``.marginals()`` and a
  lazy ``.plan()``

Where the reference passes a JAX ``key``, the port takes ``seed=`` (or
``generator=``, a `torch.Generator` on the problem's device). Data runs on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import Geometry, OTProblem, UOTProblem, available_methods, s0, solve
from repro_torch.robust import corrupt_scaling_kernel


def main(argv=None):
    ap = argparse.ArgumentParser(description="Spar-Sink OT and UOT against dense Sinkhorn")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=1000, help="support points")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n, d = args.n, 5
    x = torch.as_tensor(rng.uniform(size=(n, d)), device=device)
    a = torch.as_tensor(rng.dirichlet(np.ones(n)), device=device)
    b = torch.as_tensor(rng.dirichlet(np.ones(n)), device=device)

    print("registered solvers:", ", ".join(available_methods()))

    # ---------------- OT ----------------
    eps = 0.02  # smaller eps => transport term dominates the entropic value
    geom = Geometry.from_points(x, normalize=True)  # cost scaled to [0,1]
    problem = OTProblem(geom, a, b, eps)

    ref = solve(problem, method="dense", tol=1e-9, max_iter=10_000)
    truth = float(ref.value)
    print(f"entropic OT  (dense Sinkhorn, {int(ref.n_iter)} iters): {truth:.6f}")

    s = 8 * s0(n)  # paper's budget: s = 8 * 1e-3 * n * log^4 n  (~O(n))
    sol = solve(problem, method="spar_sink_coo", seed=0, s=s)
    print(f"entropic OT  (Spar-Sink, nnz={int(sol.nnz)}/{n*n}): "
          f"{float(sol.value):.6f}  (rel err {abs(float(sol.value) - truth) / abs(truth):.3%})")

    # The plan stays sparse — O(cap) memory — unless explicitly densified.
    plan = sol.plan()
    row, col = sol.marginals()
    print(f"sparse plan: {type(plan).__name__} cap={plan.cap} "
          f"mass={float(plan.total_mass()):.4f} "
          f"marginal err row={float(torch.abs(row - a).sum()):.2e} "
          f"col={float(torch.abs(col - b).sum()):.2e}")

    # ---------------- UOT / WFR ----------------
    a5, b3 = a * 5.0, b * 3.0  # unbalanced masses (paper Sec. 5.1)
    lam = 0.1
    wfr_geom = Geometry.wfr(x, eta=0.2)  # transport blocked beyond pi*eta
    uot = UOTProblem(wfr_geom, a5, b3, eps, lam=lam)

    ref_u = solve(uot, method="dense", tol=1e-9, max_iter=10_000)
    truth_u = float(ref_u.value)
    print(f"entropic UOT (dense, WFR cost): {truth_u:.6f}")

    value_u = float(solve(uot, method="spar_sink_coo", seed=1, s=s).value)
    print(f"entropic UOT (Spar-Sink):       {value_u:.6f}  "
          f"(rel err {abs(value_u - truth_u) / abs(truth_u):.3%})")

    # ---------------- observability: trace + quality certificate ----------
    # trace=True records per-iteration telemetry in the loop's state;
    # certify=True attaches an O(nnz + n) a posteriori error certificate
    # (duality gap, coverage deficit, marginal bound, sampling CI).
    sol = solve(problem, method="spar_sink_coo", seed=0, s=s, trace=True, certify=True)
    cert = sol.certificate
    print(f"certificate: gap={float(cert.gap):.2e} "
          f"error_bound={float(cert.error_bound):.2e} "
          f"ci=[{float(cert.ci_low):.6f}, {float(cert.ci_high):.6f}] "
          f"ess={float(cert.ess):.0f}")
    print(f"  actual |value - dense| = {abs(float(sol.value) - truth):.2e}")
    print("diagnostics summary:", sol.diagnostics.summary())

    # ---------------- robustness: the self-healing escalation ladder ------
    # Corrupt the scaling-domain kernel (the chaos harness's injected
    # fault: the plain solve exits `degenerate`), then let robust=True
    # escalate to the clean log domain and recover. `.attempts` is the
    # honest per-rung history.
    small = OTProblem(Geometry.from_points(x[:200], normalize=True),
                      a[:200] / a[:200].sum(), b[:200] / b[:200].sum(), eps)
    broken = corrupt_scaling_kernel(small, 2, mode="zero")
    rsol = solve(broken, method="dense", robust=True)
    print(f"robust solve recovered={rsol.recovered} "
          f"(final status: {rsol.status_label})")
    for t in rsol.attempts:
        print(f"  attempt {t.index}: {t.action:>10s} via {t.method:<6s} "
              f"eps={t.eps:g} -> {t.status} ({t.matvecs} matvecs)")
    return {"ot": (truth, float(sol.value)), "uot": (truth_u, value_u), "recovered": bool(rsol.recovered)}


if __name__ == "__main__":
    main()
