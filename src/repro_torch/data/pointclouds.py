"""Synthetic OT/UOT measures: the paper's data patterns C1-C3 (Sec. 5.1).

A copy of ``make_measures``, ``make_uot_measures`` and ``wfr_eta_for_density``
from the JAX package's ``repro.data.pointclouds``, kept here so the port
imports nothing of it.

C1: a,b ~ empirical N(1/3, 1/20) and N(1/2, 1/20);    x_i ~ U(0,1)^d
C2: a,b as C1;  x_i ~ N(0, Sigma), Sigma_jk = 0.5^|j-k|
C3: a,b ~ empirical t5(1/3, 1/20) and t5(1/2, 1/20);  x_i ~ U(0,1)^d
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_measures", "make_uot_measures", "wfr_eta_for_density"]


def _empirical_hist(rng, n: int, kind: str, loc: float, scale: float) -> np.ndarray:
    """Gaussian/t5-SHAPED histogram over the index grid (the POT
    ``make_1D_gauss`` convention the paper's setup follows): weights vary by
    orders of magnitude, which is what makes the eq.(9) importance
    probabilities informative. ``scale`` is the density's std."""
    t = (np.arange(n) + 0.5) / n
    z = (t - loc) / scale
    if kind == "gauss":
        w = np.exp(-0.5 * z**2)
    elif kind == "t5":
        w = (1.0 + z**2 / 5.0) ** (-3.0)
    else:
        raise ValueError(kind)
    w = w + 1e-12
    return w / w.sum()


def make_measures(pattern: str, n: int, d: int, seed: int = 0):
    """Returns (a, b, x) — two histograms on shared support x (n, d)."""
    rng = np.random.default_rng(seed)
    if pattern in ("C1", "C3"):
        x = rng.uniform(0.0, 1.0, size=(n, d))
    elif pattern == "C2":
        idx = np.arange(d)
        sigma = 0.5 ** np.abs(idx[:, None] - idx[None, :])
        chol = np.linalg.cholesky(sigma)
        x = rng.standard_normal((n, d)) @ chol.T
    else:
        raise ValueError(pattern)
    kind = "t5" if pattern == "C3" else "gauss"
    a = _empirical_hist(rng, n, kind, 1.0 / 3.0, 1.0 / 20.0)
    b = _empirical_hist(rng, n, kind, 1.0 / 2.0, 1.0 / 20.0)
    return a.astype(np.float64), b.astype(np.float64), x.astype(np.float64)


def make_uot_measures(
    pattern: str, n: int, d: int, seed: int = 0, mass_a: float = 5.0, mass_b: float = 3.0
):
    """Paper's UOT setting: total masses 5 and 3 (Sec. 5.1)."""
    a, b, x = make_measures(pattern, n, d, seed)
    return a * mass_a, b * mass_b, x



def wfr_eta_for_density(x: np.ndarray, target_density: float) -> float:
    """Pick eta so ~``target_density`` of the WFR kernel is non-zero
    (entries with d_ij < pi * eta). R1/R2/R3 = 0.7 / 0.5 / 0.3."""
    d = np.sqrt(
        np.maximum(
            (x**2).sum(1)[:, None] + (x**2).sum(1)[None, :] - 2 * x @ x.T, 0.0
        )
    )
    q = np.quantile(d.ravel(), target_density)
    return float(q / np.pi)
