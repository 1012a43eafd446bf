"""Cardiac-cycle identification with Spar-Sink WFR distances (paper Sec. 6),
on the PyTorch port.

Builds synthetic echo videos for three subjects (healthy / heart failure /
arrhythmia), computes the pairwise WFR distance matrix with Spar-Sink, runs
classical MDS, and prints the recovered cycle structure. Writes
``echo_distance_<subject>.png`` under ``--out-dir`` if matplotlib is
available. `predict_ed` is the paper's Table-1 task (predict the
end-diastole frame from the end-systole frame) as the reference's
``benchmarks/bench_echo.py`` computes it.

    PYTHONPATH=src python examples_torch/echocardiogram.py [--device cpu]

The counterpart of ``examples/echocardiogram.py``. Three differences:

* each subject's video and sketches have a fixed seed (`SUBJECT_SEEDS`);
  the reference seeds them with ``hash(name) % 100``, which Python salts
  anew in every process, so its videos differ from run to run;
* a `torch.Generator` seeded from the integers of each ``fold_in`` chain
  (`generator`) takes the place of the JAX key: the sketches are other
  draws of the same distribution (Philox, not threefry);
* `predict_ed` makes no prediction (error NaN) where a candidate's
  distance is not finite; the reference's ``max`` skips a NaN candidate,
  or picks it where it comes first.
"""
from __future__ import annotations

import argparse
import math
import os
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (
    STATUS_LABELS,
    Geometry,
    UOTProblem,
    gibbs_kernel,
    plan_from_scalings,
    s0,
    sinkhorn_uot,
    solve,
    spar_sink_uot,
    uniform_probs,
    uot_cost_from_plan,
    wfr_cost,
)
from repro_torch.data import synth_echo_video

EPS, LAM, ETA = 0.01, 0.5, 0.1
TABLE1_METHODS = ("sinkhorn", "spar_sink", "rand_sink")
SUBJECTS = {
    "healthy": dict(arrhythmia=0.0, failure=0.0),
    "heart_failure": dict(arrhythmia=0.0, failure=0.8),
    "arrhythmia": dict(arrhythmia=0.5, failure=0.0),
}
SUBJECT_SEEDS = {"healthy": 0, "heart_failure": 1, "arrhythmia": 2}


def generator(device, *path: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``path``, where the
    reference folds the same integers into a key one by one."""
    seed = int(np.random.SeedSequence(list(path)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def frame_measure(frame, stride=4, device=None):
    """A frame's pixel intensities as a probability vector on ``device``,
    and its pixel grid in [0, 1)^2 (numpy)."""
    f = frame[::stride, ::stride]
    h, w = f.shape
    ys, xs = np.mgrid[0:h, 0:w]
    pts = np.stack([ys.ravel() / h, xs.ravel() / w], -1)
    mass = f.ravel().astype(np.float64)
    return torch.as_tensor(mass / mass.sum(), device=resolve_device(device)), pts


def wfr_matrix(video, seed, stride=4, device=None):
    """Pairwise WFR distances ``UOT^(1/2)`` between a video's frames, each
    by ``spar_sink_coo`` at s = 8 s0(n); pair (i, j) draws from
    ``generator(device, *seed, i * T + j)``."""
    dev = resolve_device(device)
    measures = [frame_measure(f, stride, dev) for f in video]
    pts = measures[0][1]
    # one shared Geometry: the WFR Gibbs kernel is built once for all frame
    # pairs (the lazy per-eps cache), not once per pair
    geom = Geometry.wfr(pts, eta=ETA, device=dev)
    n = pts.shape[0]
    s = 8 * s0(n)
    t_frames = len(video)
    D = np.zeros((t_frames, t_frames))
    for i in range(t_frames):
        for j in range(i + 1, t_frames):
            problem = UOTProblem(geom, measures[i][0], measures[j][0], EPS, lam=LAM)
            v = float(
                solve(problem, method="spar_sink_coo", generator=generator(dev, *seed, i * t_frames + j),
                      s=s, tol=1e-7, max_iter=1500).value
            )
            D[i, j] = D[j, i] = max(v, 0.0) ** 0.5  # WFR = UOT^(1/2)
    return D


def classical_mds(D, k=2):
    n = D.shape[0]
    J = np.eye(n) - np.ones((n, n)) / n
    B = -0.5 * J @ (D**2) @ J
    w, v = np.linalg.eigh(B)
    idx = np.argsort(w)[::-1][:k]
    return v[:, idx] * np.sqrt(np.maximum(w[idx], 0.0))


# --------------------------------------------------------------------------
# Table 1: ED prediction from ES (the reference's benchmarks/bench_echo.py)
# --------------------------------------------------------------------------


def pool(video):
    """2 x 2 mean pooling of every frame (Table 1's panel (b))."""
    t, h, w = video.shape
    return video.reshape(t, h // 2, 2, w // 2, 2).mean(axis=(2, 4))


def echo_distance(a, b, C, method, seed, s, n_seeds: int = 2):
    """The entropic UOT value between two frames on the WFR cost ``C`` by
    ``method``: ``(value, [(n_iter, status), ...] of its solves)``.

    ``sinkhorn`` is the dense scaling loop and the value of its plan;
    ``spar_sink`` (eq. 11 probabilities) and ``rand_sink`` (uniform ones)
    average ``n_seeds`` sketches drawn from ``generator(device, *seed, i)``
    (the estimator is unbiased, eq. 7). Through the legacy functions, as
    ``benchmarks/bench_echo.py:47-63`` (``_dist``) calls them."""
    if method == "sinkhorn":
        K = gibbs_kernel(C, EPS)
        res = sinkhorn_uot(K, a, b, LAM, EPS, tol=1e-7, max_iter=2000)
        T = plan_from_scalings(res.u, K, res.v)
        value = float(uot_cost_from_plan(T, C, a, b, LAM, EPS))
        return value, [_solve_report(res)]
    if method not in ("spar_sink", "rand_sink"):
        raise ValueError(f"unknown method {method!r}; one of {TABLE1_METHODS}")
    probs = uniform_probs(a.shape[0], b.shape[0], C.dtype, device=C.device) if method == "rand_sink" else None
    vals, solves = [], []
    with warnings.catch_warnings():  # the legacy shim's deprecation notice, once a call
        warnings.simplefilter("ignore", DeprecationWarning)
        for i in range(n_seeds):
            sol = spar_sink_uot(C, a, b, LAM, EPS, s, generator=generator(C.device, *seed, i), probs=probs,
                                tol=1e-7, max_iter=2000)
            vals.append(float(sol.value))
            solves.append(_solve_report(sol.result))
    return float(np.mean(vals)), solves


def _solve_report(res) -> tuple[int, str]:
    return int(res.n_iter), STATUS_LABELS[int(res.status)]


class Prediction(NamedTuple):
    error: float  # |1 - (t_hat - t_es) / (t_ed - t_es)|; NaN where no prediction was made
    t_hat: int | None  # None where a candidate's distance is not finite
    dists: dict  # candidate frame -> distance from the ES frame
    seconds: dict  # candidate frame -> seconds of its distance (synced)
    solves: dict  # candidate frame -> [(n_iter, status)] of its solves, seed by seed


def predict_ed(video, t_es, t_ed, method, seed, stride, s_mult, eta=0.1, *, device=None, n_seeds: int = 2):
    """Predict the ED frame as the candidate farthest (in WFR) from the ES
    frame within one cardiac cycle, as ``benchmarks/bench_echo.py:66-85``
    (``_predict_ed``); ``seed`` is the tuple of integers the sketches'
    generators start from (the reference's key). Where a candidate's
    distance is not finite the prediction fails: ``t_hat`` None and
    ``error`` NaN, never an argmax over the other candidates."""
    dev = resolve_device(device)
    m_es, pts = frame_measure(video[t_es], stride, dev)
    C = wfr_cost(torch.as_tensor(pts, device=dev), eta=eta)
    n = pts.shape[0]
    s = s_mult * s0(n)
    # candidates restricted to ONE cardiac cycle (paper Sec. 6: predict the
    # ED "within one cycle"; a symmetric window spans two equally valid EDs)
    half = max(abs(t_ed - t_es) + 2, 4)
    if t_ed > t_es:
        cand = [t for t in range(t_es + 1, min(t_es + half + 1, len(video)))]
    else:
        cand = [t for t in range(max(t_es - half, 0), t_es)]
    dists, seconds, solves = {}, {}, {}
    for t in cand:
        m_t, _ = frame_measure(video[t], stride, dev)
        t0 = time.perf_counter()
        dists[t], solves[t] = echo_distance(m_es, m_t, C, method, (*seed, t), s, n_seeds)
        seconds[t] = time.perf_counter() - t0
    if not all(math.isfinite(d) for d in dists.values()):
        return Prediction(math.nan, None, dists, seconds, solves)
    t_hat = max(dists, key=dists.get)
    return Prediction(abs(1.0 - (t_hat - t_es) / (t_ed - t_es)), t_hat, dists, seconds, solves)


def table1_video(v: int, size: int, pooled: bool = False, n_frames: int = 30):
    """Video ``v`` of Table 1 as bench_echo makes it, with its ES frame (the
    middle one) and the ED frame nearest to it: ``(video, t_es, t_ed)``."""
    video, t_eds, t_ess = synth_echo_video(
        n_frames=n_frames, size=size, period=10 + 2 * (v % 3), seed=v,
        arrhythmia=0.2 if v % 2 else 0.0,
    )
    if pooled:
        video = pool(video)
    t_es = t_ess[len(t_ess) // 2]
    t_ed = min(t_eds, key=lambda t: abs(t - t_es) if t != t_es else 99)
    return video, t_es, t_ed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--out-dir", default=".", help="where the PNGs go")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = {}
    os.makedirs(args.out_dir, exist_ok=True)
    for k, (name, kw) in enumerate(SUBJECTS.items()):
        video, t_ed, t_es = synth_echo_video(n_frames=args.frames, size=args.size, period=10,
                                             seed=SUBJECT_SEEDS[name], **kw)
        D = wfr_matrix(video, (0, k), args.stride, device)
        xy = classical_mds(D)
        radius = np.linalg.norm(xy - xy.mean(0), axis=1)
        results[name] = D
        print(f"[{name}] frames={len(video)} ED={t_ed} ES={t_es}")
        print(f"  mean WFR dist {D[D>0].mean():.4f}; MDS loop radius "
              f"{radius.mean():.3f} +- {radius.std():.3f}"
              + ("  <- irregular cycle sizes" if radius.std() > 0.3 * radius.mean() else ""))
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, axes = plt.subplots(1, 2, figsize=(9, 4))
            axes[0].imshow(D, cmap="magma")
            axes[0].set_title(f"WFR distance matrix ({name})")
            sc = axes[1].scatter(xy[:, 0], xy[:, 1], c=np.arange(len(xy)), cmap="viridis")
            axes[1].plot(xy[:, 0], xy[:, 1], alpha=0.4)
            axes[1].set_title("MDS (colored by time)")
            fig.colorbar(sc, ax=axes[1])
            fig.tight_layout()
            path = os.path.join(args.out_dir, f"echo_distance_{name}.png")
            fig.savefig(path, dpi=100)
            plt.close(fig)
            print(f"  wrote {path}")
        except Exception:
            pass
    return results


if __name__ == "__main__":
    main()
