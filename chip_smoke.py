#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--profile]

Run from a checkout of the repository on a machine with an NVIDIA H100.
The first run builds the CUDA kernel from ``src/repro_torch/kernels/csrc``
into ``build/repro_torch_kernels/``. Phases (any failure exits non-zero):

1. the card's name and power limit, torch/CUDA versions, the kernel build;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes, with its time, the plain version's time and its bound;
3. the main path, ``solve(problem, method="spar_sink_mf")`` at n = 2^17
   (C1 measures, d = 5, float64, eps = 0.1, s = 4 s0(n)): (a) OT in the
   scaling domain, (b) OT with ``stabilize=True``, (c) UOT with masses 5/3
   and lam = 0.5, then (a) again, which must be bitwise equal; the kernel's
   launch counts are set to 0 just before each ``solve`` and read just after
   it (each scaling-domain solve must launch the kernel exactly once);
4. accuracy at n = 8192: ``dense`` against ``log``, and the mean relative
   error of ``spar_sink_mf`` against them over 4 seeds.

``--profile`` also runs (a) under `torch.profiler` and prints where its
device time goes. The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound of each kernel
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

K_TOL = dict(rtol=2e-3, atol=1e-6)  # the reference kernel tests' tolerances
C_TOL = dict(rtol=2e-4, atol=1e-5)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def time_ms(fn, *, warmup: int = 3, reps: int = 20) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# --------------------------------------------------------------------------


def _gathered_inputs(n: int, k: int, d: int, device, seed: int):
    """Main-path-shaped inputs: C1 points, rows ascending (as the sampler
    lays them out), columns at random."""
    import torch

    from repro_torch.data.pointclouds import make_measures

    _, _, x = make_measures("C1", n, d, seed=seed)
    x = torch.as_tensor(x, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = torch.sort(torch.randint(0, n, (k,), device=device, generator=gen)).values
    cols = torch.randint(0, n, (k,), device=device, generator=gen)
    return x, rows, cols


def _max_abs_err(out, ref) -> float:
    import torch

    finite = torch.isfinite(ref)
    return float(torch.max(torch.abs(out[finite] - ref[finite]))) if bool(finite.any()) else 0.0


def check_gathered_kernel(n: int, k: int, d: int, device) -> dict:
    import torch

    from repro_torch.kernels.ops import _launch_gathered_kernel, gathered_kernel
    from repro_torch.kernels.ref import gathered_kernel_ref

    eps = 0.1
    x, rows, cols = _gathered_inputs(n, k, d, device, seed=0)
    k_e, c_e = gathered_kernel(x, x, rows, cols, eps=eps)
    k_r, c_r = gathered_kernel_ref(x, x, rows, cols, eps=eps)
    torch.cuda.synchronize()
    torch.testing.assert_close(k_e, k_r, **K_TOL)
    torch.testing.assert_close(c_e, c_r, **C_TOL)
    err = max(_max_abs_err(k_e, k_r), _max_abs_err(c_e, c_r))
    log(f"gathered_kernel sqeuclidean k={k} n={n} d={d}: max_abs_err={err!r}")

    # WFR with blocked pairs: two clusters further apart than pi * eta
    eta = 0.2
    xw = 0.2 * x
    xw[n // 2:, 0] += 1.8
    kw = min(k, 1 << 20)
    kw_e, cw_e = gathered_kernel(xw, xw, rows[:kw], cols[:kw], eps=eps, cost="wfr", eta=eta)
    kw_r, cw_r = gathered_kernel_ref(xw, xw, rows[:kw], cols[:kw], eps=eps, cost="wfr", eta=eta)
    blocked = torch.isinf(cw_r)
    share = float(blocked.double().mean())
    check(0.1 < share < 0.9, f"WFR case blocks {share} of its pairs")
    check(bool(torch.equal(torch.isinf(cw_e), blocked)), "WFR blocked set differs from the plain version")
    check(bool((kw_e[blocked] == 0).all()) and bool(torch.isposinf(cw_e[blocked]).all()),
          "WFR blocked pairs are not exactly (0, +inf)")
    torch.testing.assert_close(kw_e[~blocked], kw_r[~blocked], **K_TOL)
    torch.testing.assert_close(cw_e[~blocked], cw_r[~blocked], **C_TOL)
    err_w = max(_max_abs_err(kw_e, kw_r), _max_abs_err(cw_e, cw_r))
    log(f"gathered_kernel wfr k={kw} blocked_share={share!r}: max_abs_err={err_w!r}")

    # an index outside the points is flagged by the kernel and raises
    bad_cols = cols[:1024].clone()
    bad_cols[-1] = n
    try:
        gathered_kernel(x, x, rows[:1024], bad_cols, eps=eps)
    except IndexError:
        pass
    else:
        check(False, "an out-of-range column index did not raise")
    log("gathered_kernel: an out-of-range index raises IndexError")

    # times at the main path's shapes: the wrapper as the path calls it
    # (float64 points cast to float32, flag zeroed, launch, flag read), the
    # bare launch, and the plain version
    ms = time_ms(lambda: gathered_kernel(x, x, rows, cols, eps=eps))
    xf = x.to(torch.float32).contiguous()
    k_out, c_out = torch.empty_like(k_e), torch.empty_like(c_e)
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    bare_ms = time_ms(lambda: _launch_gathered_kernel(xf, xf, rows, cols, k_out, c_out, flag,
                                                      eps=eps, cost="sqeuclidean", eta=1.0))
    plain_ms = time_ms(lambda: gathered_kernel_ref(x, x, rows, cols, eps=eps), reps=10)
    # least work: the points read once (x is y here), both index arrays read
    # once, both float32 outputs written once; ~6d + 6 float32 operations a pair
    nbytes = xf.numel() * 4 + 2 * k * 8 + 2 * k * 4
    ops = k * (6 * d + 6)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    # the traffic of the gather itself: two indices, 2 d float32 point
    # values and two float32 outputs per pair
    gathered_ms = k * (16 + 8 * d + 8) / HBM_BYTES_PER_S * 1e3
    log(f"gathered_kernel times: wrapper {ms!r} ms, bare launch {bare_ms!r} ms, plain {plain_ms!r} ms, "
        f"bound {max(t_bytes, t_ops)!r} ms ({nbytes} bytes, {ops} ops), "
        f"per-pair gathered traffic at HBM rate {gathered_ms!r} ms")
    return {
        "name": "gathered_kernel",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gather_kernel.cu",
        "replaces": "src/repro/kernels/gather_kernel.py:51",
        "launches": None,  # filled in from the main path's run
        "max_abs_err": max(err, err_w),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
    }


# --------------------------------------------------------------------------
# Phase 3: the main path at full width
# --------------------------------------------------------------------------


def run_main_path(n: int, device, max_iter: int = 200) -> dict[str, int]:
    """Runs (a)-(c) and the repeat of (a); returns the kernel launches made
    by their four solves."""
    import torch

    import repro_torch as rt
    from repro_torch.data.pointclouds import make_measures, make_uot_measures
    from repro_torch.kernels import ops

    d, eps = 5, 0.1
    s = 4 * rt.s0(n)
    a, b, x = make_measures("C1", n, d, seed=0)
    ot = rt.OTProblem(rt.PointCloudGeometry(x, device=device), a, b, eps)
    ua, ub, ux = make_uot_measures("C1", n, d, seed=0)
    uot = rt.UOTProblem(rt.PointCloudGeometry(ux, device=device), ua, ub, eps, lam=0.5)
    runs = [("a", ot, False), ("b", ot, True), ("c", uot, False), ("a-repeat", ot, False)]
    results = {}
    total = dict.fromkeys(ops.LAUNCHES, 0)
    for name, problem, stabilize in runs:
        # the sketch alone, timed apart from the solve (its launches are not
        # the main path's: the counts are reset after it)
        build = rt.build_mf_log_sketch if stabilize else rt.build_mf_sketch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sk, _ = build(problem, torch.Generator(device=device).manual_seed(0), s)
        torch.cuda.synchronize()
        sketch_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sol = rt.solve(problem, method="spar_sink_mf", seed=0, s=s, tol=1e-6,
                       max_iter=max_iter, stabilize=stabilize)
        value = float(sol.value)  # syncs
        solve_s = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        for kernel, count in counts.items():
            total[kernel] += count
        launches = counts["gathered_kernel"]
        row = dict(run=name, n=n, s=s, cap=sk.cap, sketch_s=sketch_s, solve_s=solve_s,
                   n_iter=int(sol.n_iter), status=sol.status_label, nnz=int(sol.nnz),
                   overflowed=bool(sol.overflowed), value=value, kernel_launches=launches)
        log("main path " + json.dumps(row))
        check(math.isfinite(value), f"({name}) value is not finite")
        check(row["nnz"] > 0, f"({name}) empty sketch")
        check(not row["overflowed"], f"({name}) sketch overflowed its capacity")
        if not stabilize:
            check(launches == 1, f"({name}) the solve launched the gathered kernel {launches} times, not once")
        results[name] = (value, int(sol.n_iter))
    check(results["a"] == results["a-repeat"],
          f"repeated run (a) differs: {results['a']} vs {results['a-repeat']}")
    log("main path: the repeated run (a) is bitwise identical")
    return total


# --------------------------------------------------------------------------
# Phase 4: accuracy against the dense oracles
# --------------------------------------------------------------------------


def check_accuracy(n: int, device, seeds: int = 4) -> None:
    import torch

    import repro_torch as rt
    from repro_torch.data.pointclouds import make_measures

    eps = 0.1
    a, b, x = make_measures("C1", n, 5, seed=1)
    dense_problem = rt.OTProblem(rt.Geometry.from_points(x, device=device), a, b, eps)
    t0 = time.perf_counter()
    dense = rt.solve(dense_problem, method="dense", tol=1e-9, max_iter=20_000)
    v_dense = float(dense.value)
    t_dense = time.perf_counter() - t0
    t0 = time.perf_counter()
    logd = rt.solve(dense_problem, method="log", tol=1e-9, max_iter=20_000)
    v_log = float(logd.value)
    t_log = time.perf_counter() - t0
    log(f"accuracy n={n}: dense {v_dense!r} ({int(dense.n_iter)} it, {dense.status_label}, "
        f"{t_dense!r} s), log {v_log!r} ({int(logd.n_iter)} it, {logd.status_label}, {t_log!r} s)")
    check(abs(v_dense - v_log) <= 1e-8 * abs(v_log), "dense and log values differ beyond rtol 1e-8")
    del dense_problem, dense, logd
    torch.cuda.empty_cache()
    mf = rt.OTProblem(rt.PointCloudGeometry(x, device=device), a, b, eps)
    errs = []
    for seed in range(seeds):
        sol = rt.solve(mf, method="spar_sink_mf", seed=seed, s=16 * rt.s0(n), tol=1e-6, max_iter=1000)
        errs.append(abs(float(sol.value) - v_log) / abs(v_log))
    rmae = sum(errs) / len(errs)
    log(f"accuracy n={n}: spar_sink_mf s=16 s0 relative errors {errs!r}, mean {rmae!r}")
    check(rmae < 0.25, f"spar_sink_mf mean relative error {rmae} >= 0.25")


def profile_main_path(n: int, device, max_iter: int = 200) -> None:
    """Run (a) once more under `torch.profiler` and print where its device
    time goes: the busiest operators by self device time, and the device's
    busy share of the run's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import repro_torch as rt
    from repro_torch.data.pointclouds import make_measures

    a, b, x = make_measures("C1", n, 5, seed=0)
    problem = rt.OTProblem(rt.PointCloudGeometry(x, device=device), a, b, 0.1)
    opts = dict(method="spar_sink_mf", seed=0, s=4 * rt.s0(n), tol=1e-6, max_iter=max_iter)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(rt.solve(problem, **opts).value)
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel events only: an operator's row repeats its kernels' device time
    rows = sorted(
        ((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    log(f"profile (a): wall {wall_us / 1e3!r} ms, kernels {busy / 1e3!r} ms "
        f"(device busy share {busy / wall_us!r})")
    for dev_us, count, key in rows[:12]:
        log(f"profile (a):   {dev_us / 1e3:10.3f} ms  {count:6d}x  {key[:100]}")


def main() -> int:
    t_start = time.perf_counter()
    profile_run = "--profile" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing runs on the CPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found: run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core.spar_sink import default_cap, s0
    from repro_torch.kernels import gather_kernel

    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    gather_kernel.load()
    log(f"built and loaded {gather_kernel.SOURCE.name} in {time.perf_counter() - t0!r} s")

    n = 2 ** 17
    entry = check_gathered_kernel(n, default_cap(4 * s0(n)), 5, device)
    launches = run_main_path(n, device)
    entry["launches"] = launches["gathered_kernel"]
    check_accuracy(8192, device)
    if profile_run:
        profile_main_path(n, device)

    log(f"total {time.perf_counter() - t_start!r} s")
    log(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
