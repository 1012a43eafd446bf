"""Color transfer with Spar-Sink (paper Appendix D.1), on the PyTorch port:
move a synthetic "sunset" palette onto a "daytime" image via the entropic
OT plan between RGB point clouds, with nearest-neighbor plan extension.

    PYTHONPATH=src python examples_torch/color_transfer.py [--device cpu] [--n 2000]

The counterpart of ``examples/color_transfer.py``; the sketch draws from
``seed=0`` where the reference passes ``PRNGKey(0)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import Geometry, OTProblem, s0, solve


def synth_image(kind: str, n: int, seed: int) -> np.ndarray:
    """RGB point clouds: 'day' (blues/greens) vs 'sunset' (oranges/purples)."""
    rng = np.random.default_rng(seed)
    if kind == "day":
        sky = rng.normal([0.45, 0.65, 0.95], 0.07, size=(n // 2, 3))
        sea = rng.normal([0.15, 0.45, 0.60], 0.07, size=(n - n // 2, 3))
        return np.clip(np.concatenate([sky, sea]), 0, 1)
    warm = rng.normal([0.95, 0.45, 0.15], 0.08, size=(n // 2, 3))
    dusk = rng.normal([0.45, 0.20, 0.50], 0.08, size=(n - n // 2, 3))
    return np.clip(np.concatenate([warm, dusk]), 0, 1)


def _synced(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main(argv=None):
    ap = argparse.ArgumentParser(description="color transfer by dense and Spar-Sink OT plans")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=2000, help="pixels a cloud")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n = args.n
    x = torch.as_tensor(synth_image("day", n, 0), device=device)  # source pixels
    y = torch.as_tensor(synth_image("sunset", n, 1), device=device)  # target palette
    a = torch.full((n,), 1.0 / n, dtype=torch.float64, device=device)
    b = torch.full((n,), 1.0 / n, dtype=torch.float64, device=device)
    eps = 0.01
    problem = OTProblem(Geometry.from_points(x, y), a, b, eps)

    # dense Sinkhorn plan
    t0 = _synced(device)
    sol_dense = solve(problem, method="dense", tol=1e-8, max_iter=5000)
    T_dense = sol_dense.plan()
    t_dense = _synced(device) - t0

    # spar-sink plan — stays a SparsePlan, the color map runs in O(cap)
    s = 8 * s0(n)
    t0 = _synced(device)
    sol_spar = solve(problem, method="spar_sink_coo", seed=0, s=float(s), tol=1e-8, max_iter=5000)
    plan = sol_spar.plan()
    t_spar = _synced(device) - t0

    # barycentric color map: x_i -> sum_j T_ij y_j / sum_j T_ij
    def transfer(T):
        denom = torch.clamp_min(T.sum(1, keepdim=True), 1e-12)
        return ((T @ y) / denom).cpu().numpy()

    out_dense = transfer(T_dense)
    # sparse barycentric map directly on the COO plan entries
    numer = np.zeros((n, 3))
    np.add.at(numer, plan.rows.cpu().numpy(),
              plan.vals.cpu().numpy()[:, None] * y.cpu().numpy()[plan.cols.cpu().numpy()])
    denom = np.maximum(plan.row_marginal().cpu().numpy(), 1e-12)[:, None]
    out_spar = numer / denom

    diff = np.abs(out_dense - out_spar).mean()
    print(f"sinkhorn: {t_dense:.2f}s   spar-sink: {t_spar:.2f}s "
          f"({t_dense / t_spar:.1f}x)   mean |color diff| = {diff:.4f}")
    print("source mean RGB ", x.mean(0).cpu().numpy().round(3))
    print("target mean RGB ", y.mean(0).cpu().numpy().round(3))
    print("transferred RGB ", out_spar.mean(0).round(3), "(spar-sink)")
    return {"seconds_dense": t_dense, "seconds_spar_sink": t_spar, "color_diff": float(diff)}


if __name__ == "__main__":
    main()
