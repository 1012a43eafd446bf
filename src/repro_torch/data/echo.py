"""Synthetic echocardiogram videos for the paper's Table-1 task (Sec. 6).

A copy of ``synth_echo_video`` from the JAX package's ``repro.data.echo``,
kept here so the port imports nothing of it; numpy only, so the videos and
the ED/ES lists are bitwise the reference's. The real EchoNet-Dynamic
videos are not redistributable offline: each video here is a pulsating
bright annulus ("myocardium") around a dark chamber whose radius follows
the cardiac phase, ED frames at the largest chamber, ES at the smallest.
The ground-truth ED/ES times follow from the phase, so the task (predict
t_ED from t_ES by WFR distances) runs end to end.
"""
from __future__ import annotations

import numpy as np

__all__ = ["synth_echo_video"]


def synth_echo_video(
    n_frames: int = 60,
    size: int = 112,
    period: int = 20,
    *,
    seed: int = 0,
    noise: float = 0.03,
    arrhythmia: float = 0.0,  # >0 => per-cycle period jitter (irregular rhythm)
    failure: float = 0.0,  # 0..1 => reduced ejection fraction (small radius swing)
):
    """Returns (video (T, H, W) float32 in [0,1], t_ed list, t_es list)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    cy = cx = size / 2.0
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / size

    # phase with optional per-cycle period jitter
    phases = []
    t, phase = 0, 0.0
    cur_period = period
    while t < n_frames:
        phases.append(phase)
        phase += 2 * np.pi / cur_period
        if phase >= 2 * np.pi:
            phase -= 2 * np.pi
            cur_period = period * (1.0 + arrhythmia * rng.uniform(-0.4, 0.4))
        t += 1
    phases = np.asarray(phases)

    swing = 0.08 * (1.0 - 0.7 * failure)
    radius = 0.22 + swing * np.cos(phases)  # largest at phase 0 => ED
    frames = []
    for rt in radius:
        wall = np.exp(-((r - rt) ** 2) / (2 * 0.03**2))
        chamber = 0.15 * (r < rt - 0.05)
        img = np.clip(wall + chamber + noise * rng.standard_normal(r.shape), 0, 1)
        frames.append(img)
    video = np.stack(frames).astype(np.float32)

    # ED = local maxima of radius (phase ~ 0), ES = local minima (phase ~ pi);
    # the ends reflect, so a cycle's first and last frames count too
    rpad = np.concatenate([[radius[1]], radius, [radius[-2]]])
    t_ed = [int(i) for i in range(n_frames) if rpad[i + 1] >= rpad[i] and rpad[i + 1] > rpad[i + 2]]
    t_es = [int(i) for i in range(n_frames) if rpad[i + 1] <= rpad[i] and rpad[i + 1] < rpad[i + 2]]
    return video, t_ed, t_es
