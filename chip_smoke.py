#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --compare-with OTHER.cu [OTHER.cu ...]
    python3 chip_smoke.py --run-b-with OTHER_CHECKOUT

Run from a checkout of the repository on a machine with an NVIDIA H100.
The first run builds the CUDA kernels (every ``src/repro_torch/kernels/
csrc/*.cu``, one library) into ``build/repro_torch_kernels/``. Phases (any
failure exits non-zero):

1. the card's name, power limit and maximum SM clock, torch/CUDA versions,
   the kernels' build;
2. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with its time, the plain version's time and its bound:
   the gathered kernel and its float64 cost-only mode at the sketch's k =
   1.01e7 pairs (and WFR, d in GATHER_DIMS, float32 and float64 points, an
   odd k, y apart from x, indices 8 bytes into their storage; two launches
   and the sketch's unchecked entries bitwise the checked wrappers'; the
   pack's layout; each kernel's device time by name); ``online_matvec``
   and ``online_lse`` at n = m = 2^17 (run (a)'s points), in a WFR case at
   n = m = 2^14 with half the pairs and one whole row blocked, and over the
   shapes of the reference's kernel tests; two launches must be bitwise
   equal; the build's ``-Xptxas -v`` report of every ``online_`` kernel
   (no spills allowed outside the WFR ones), the rows a thread R and
   column slices P, and the bare launches' times over P in ``SLICE_SWEEP``
   at n = m = 2^17 and 2^14;
3. the main path, ``solve(problem, method="spar_sink_mf")`` at n = 2^17
   (C1 measures, d = 5, float64, eps = 0.1, s = 4 s0(n)): (a) OT in the
   scaling domain, (b) OT with ``stabilize=True``, (c) UOT with masses 5/3
   and lam = 0.5, then (a) again, which must be bitwise equal; each sketch
   is first built alone (wall, device time, peak memory); the launch counts
   are set to 0 just before each ``solve`` and read just after it (each
   scaling-domain solve must launch the gathered kernel exactly once, each
   log-domain solve its cost-only mode once and the gathered segment
   logsumexp twice an iteration its loop launched, and nothing else); each
   run's value beside the earlier kernel's (`EARLIER_RUNS`); then (b)'s log
   sketch with the plain float64 gather and with the cost-only kernel, in
   turns (`compare_log_sketch`); then the gathered segment logsumexp
   (``segment_lse``) on (b)'s sketch (`check_segment_lse_kernel`): the
   solve's launches, the plain loop's iterations and status on the same
   sketch, both directions against the plain version at
   `SEGMENT_LSE_RTOL`, bitwise on a repeat, its times beside its byte
   bound and ``torch.segment_reduce``'s;
4. accuracy at n = 8192: ``dense`` against ``log``, the mean relative
   error of ``spar_sink_mf`` against them over 4 seeds, and the block-wise
   objective of phase 5 validated against ``dense``;
5. the fused dense path at n = 2^17: ``fused_sinkhorn_solve`` on run (a)'s
   OT problem and on run (c)'s UOT problem (``fe = lam / (lam + eps)``),
   then ``online_lse`` for the OT solution's row marginal; the counts are set
   to 0 just before and read just after, and ``online_matvec`` must have run
   2 launches for each iteration the loop executed; then the relative error
   of run (a)'s ``spar_sink_mf`` value against the dense objective;
6. the block-ELL path at n = 8192 (run (a)'s and run (c)'s problems, block
   128, s = 16 s0): ``block_ell_matvec`` (``K~ v``) against its plain
   version on the solver's own sketch (both layouts, the transposed one
   also against a float64 scatter); the valid tiles per row-block of the OT
   and UOT sketches, and ``K~ v`` over the valid slots alone (the solver's
   launch, with the sketch's ``nblocks``) bitwise the launch over every
   slot, and with an inf in v block 0 NaN exactly where that launch and the
   plain version give NaN; ``K~ v`` over the reference test shapes, on a
   WFR sketch whose blocked rows must come out exactly 0, and batched
   (B = 8); ``block_ell_rmatvec`` (``K~^T u`` on the row layout's tiles,
   the solver's launch) against its plain version and the float64 scatter
   in float64 and float32 and at block 64, and ``K~ v`` on float64 v with
   the bits of a cast to float32, the float32 launch and a cast back; the
   times of both products as the solver calls them and as the
   transposed-layout path calls them (casts around the checked wrapper,
   ``K~^T u`` on the transposed layout), bare and on the device, beside
   cuSPARSE's BSR product on each layout; then ``solve(problem,
   method="spar_sink_block_ell")`` for OT (twice, bitwise equal) and UOT,
   with one launch of each product for each iteration the loop executed
   and no other; OT solves of this path and of the transposed-layout path
   in turns, one of each under the profiler (each product's device time
   inside the solve), and the latter's OT and UOT values against this
   path's; the mean relative error over 4 seeds
   against phase 4's ``log`` value; and the card's OT sketch solved by the
   float64 CPU path (the one labelled CPU run);
7. the RecurrentGemma-2B serving slice at full width: ``lru_scan`` (B5)
   against its plain version at the prefill shape (1, 32768, 2560), the
   training shape (1, 2048, 2560), the reference test shapes and a
   sequence shorter than one chunk, two launches bitwise equal; the
   full-width
   parameters (3.55e9, float32 masters drawn on the card) with
   ``rglru_backend="pallas"``; one RG-LRU layer's ``pallas`` and
   ``chunked`` backends against each other in float32 at (1, 32768, 2560);
   ``prefill_step`` on 1 x 32768 tokens (the counts set to 0 just before
   each call and read just after: 18 B5 launches, one per RG-LRU layer);
   the decode path against ``forward`` in float32 over a 128-token prompt;
   ``serve`` of 8 requests (32 prompt and 32 generated tokens, bf16), which
   makes no B5 launch;
8. the RecurrentGemma-2B training slice at full width and full depth, after
   phase 7's model is freed: the LRU scan's backward (B6) against its plain
   version at the training shape (1, TRAIN_SEQ, 2560), the prefill shape
   and the reference test shapes, two launches bitwise equal, with each
   shape's device time (profiler), registers, shared memory and blocks an
   SM, and at the training shape where the wrapper's host time goes; one RG-LRU
   layer's gradients (every parameter and the input, float32) by ``pallas``
   (B5 + B6) against ``chunked``; three AdamW steps of ``make_train_step``
   on 1 x TRAIN_SEQ tokens from ``TokenPipeline`` (bf16 compute, float32
   masters drawn on the card, lr 3e-4), the counts set to 0 just before
   each step and read just after (exactly 18 B5 and 18 B6 launches, one of
   each per RG-LRU layer), finite loss and gradient norm, lr = 0 and no
   parameter moved at step 0, every parameter moved at step 1; then one
   step's loss and gradients computed twice from the same state, which must
   be bitwise equal or are named leaf by leaf (the first also records the
   layout of each cotangent B6 gets); then one warm step under the profiler
   for B6's and B5's device time a launch as the step reaches them;
9. (run right after phase 4) the paper's estimator and its competitors at
   n = 8192 on phase 4's OT problem, with phase 4's ``log`` value as the
   oracle: for seed 0 the kept support of ``spar_sink_coo`` equals
   ``spar_sink_dense``'s nonzeros and ``spar_sink_log``'s, and B1's float64
   cost-only kernel on that sketch (as the shared-variates solve calls it)
   holds against its plain version and the dense cost's entries within
   ``cost64_excess``'s tolerance; ``spar_sink_coo``,
   ``spar_sink_log``, ``spar_sink_dense``, ``rand_sink`` and ``spar_sink_mf``
   (``shared_variates=True``) at s = 16 s0(n) over 4 seeds, after an untimed
   warm-up each: value, iterations, status, wall (synced), relative error,
   the counts set to 0 just before each solve and read just after (the
   shared-variates solve launches B1's cost-only mode once, ``spar_sink_log``
   the gathered segment logsumexp twice an iteration its loop launched, the
   others no hand kernel); the shared-variates scalings bitwise ``spar_sink_coo``'s and
   its value within 1e-12 relative of ``spar_sink_coo``'s, two
   ``spar_sink_coo`` solves of one seed bitwise equal, ``spar_sink_coo``'s mean
   relative error below 0.25; ``greenkhorn`` at 5(n + m) updates (with its
   launches and device time an update), ``nys_sink`` at rank n/20 and
   ``screenkhorn_lite`` at decimation 3; ``spar_sink_coo``, ``spar_sink_log``
   (eq. 11 log-probabilities) and ``rand_sink`` on run (c)'s UOT problem at n
   = 8192 against its ``log`` value; then the reference's eps sweep
   (``benchmarks/bench_rmae_vs_eps.py`` at BENCH_eps.json's settings: n =
   256, eps 1e-1, 1e-2, 1e-3, OT and UOT) with each RMAE beside the
   reference's CPU row, and its smoke acceptance on OT;
10. (run right after phase 6) traces, certificates and warm starts
   (``trace=``, ``certify=``, ``init=``) and the composite workloads: run
   (a) again with ``trace=True, certify=True``, bitwise phase 3's run (a),
   one B1 launch and no other, ``n_matvec`` twice its iterations, the last
   traced error its ``err``, the reference's ``summary()`` keys, every
   certificate field finite and the gap not below 0 (the error bound is
   printed beside the error against phase 5's fused dense objective: a
   bound below it is a finding, not a failure); the untraced, the traced,
   and the traced and certified solve in turns (median of 3 each, and each
   one's device kernels and time by the profiler) and the certify step
   alone (wall, peak memory, its certificate bitwise the solve's); run (b)
   certified (bitwise phase 3's, one cost-only launch and the gathered
   segment logsumexp's two an iteration) and warm-started from its own
   potentials at tol / 10 (the same launches); phase 6's
   block-ELL OT solve traced and certified (bitwise phase 6's, one launch
   of each B4 product an executed iteration); every method on phase 4's
   OT problem certified (and traced where it takes ``trace=``; Greenkhorn
   at n + m updates), its bound beside its error against phase 4's
   ``log`` value; then, each run twice and bitwise equal,
   ``sinkhorn_divergence`` by ``dense`` and ``spar_sink_coo`` at n = 4096,
   ``solve_barycenter`` by ``ibp`` and ``spar_ibp`` on a 64 x 64 grid with
   3 measures (and the L1 distance between them), and ``prox_sinkhorn``
   and ``prox_spar_sink`` at n = 2048. Phase 10's counted solves add their
   launches to the kernels line.
11. (run right after phase 10) OT serving: (i) the batched executor on 16
   mixed OT/UOT point-cloud problems in the 1024 and 2048 buckets, each UOT
   one with a lam of its own (`PARITY_LAMS`): ``dense``
   and ``log`` against their per-problem solves (iterations and status
   equal, values within ``DENSE_BATCH_RTOL`` of the largest entry), and
   ``spar_sink_mf`` in both domains bitwise the per-problem ``solve(seed=i)``
   (u, v, iterations, nnz, status, value, plan entries), 16 B1 (or
   cost-only, and two gathered segment logsumexps an iteration each bucket's
   loop launched) launches a dispatch, no cache fill on a repeat; the flat
   segment sums and logsumexps of a stacked sketch bitwise each element's
   own, and the gathered segment logsumexp on a B = 16 log sketch bitwise
   each element's B = 1 launch; (ii) `OTServer` on 64 requests of the serving CLI's kind (d = 3,
   sizes 2048–16384, ``spar_sink_mf`` at s = 8 s0(16384), max_batch 16,
   deadline 20 ms), scaling and log domain: a warm stream under the
   profiler (the card's busy share), then a timed stream (req/s, p50/p95/p99
   latency, mean batch, cache fills, peak memory, one B1 or cost-only
   launch a request and nothing else but, in the log domain, the gathered
   segment logsumexp; B1 and its cost-only mode on one
   served 16384-point sketch's pairs against their plain versions), then
   the same requests as 64 counted
   per-problem solves (the speedup), every served value equal to its
   per-problem one; and the launches of one batched and one per-problem
   iteration; (iii) ``solve_batch(robust=True)`` on 8 UOT problems by
   ``spar_sink_coo`` with one `undersized_cap` and one NaN `ChaosGeometry`
   kernel: only those two escalate, the rest bitwise the plain batch;
   ``OTServer(robust=True)`` with two attempts recovers the NaN one and
   fails the undersized one with ``UnrecoverableSolve``; a breaker over a
   `FlakyExecutor` opens, sheds with ``CircuitOpen`` and closes on its
   half-open probe. Phase 11's dispatched, served and per-problem solves add
   their launches to the kernels line.
12. (run right after phase 8 frees its model) the dense and MoE LM
   families, which launch no hand kernel: the stable top-k on the card
   against the CPU's on ties; OLMoE-1B-7B at full width and depth
   (6,919,100,416 float32 masters drawn on the card); layer 0's MoE on
   (1, 2048, 2048) float32, card against CPU, for each router (softmax,
   sinkhorn, spar_sink on the same CPU-drawn uniforms), the probabilities
   and output held at `MOE_PROBS_TOL`/`MOE_OUT_TOL` on every token that
   no top-k, capacity or sketch flip touched (the flips counted); a
   1 x 32768 ``prefill_step`` for each router (warm, then timed; the
   counts set to 0 just before each call and read just after: none; finite
   logits, the repeat bitwise equal; peak memory) and the router alone at
   (1, 32768, 64); one prefill and one batch-8 decode step under the
   profiler; ``serve`` at batch 8 (32 + 32 tokens) with the sinkhorn and
   spar_sink routers; then Gemma3-12B cut to its first global period (5
   local layers, 1 global; 3,358,117,632 parameters), decode against
   forward in float32 over 1280 tokens, past the 1024 window, at
   `DECODE_TOL`.
13. (run right after phase 12) the paper's applications through
   ``examples_torch/``, which launch no hand kernel (the counts, set to 0
   just before, stay 0): Table 1 at EchoNet-Dynamic's 112 x 112 frames
   (bench_echo's --full recipe at stride 1: panel (a) n = 12544, s =
   1,591,811; panel (b) 2 x 2 pooled, n = 3136), `sinkhorn`, `spar_sink`
   and `rand_sink` on `TABLE1_VIDEOS` videos, with errors, seconds a
   video and a distance, iterations, statuses, peak memory and the
   speedup; video 0's sinkhorn distances repeated bitwise, one pooled
   pair on the CPU in float64 against the card's (`ECHO_CPU_RTOL`) and
   its spar_sink mean over `ECHO_BAND_SEEDS` seeds within `ECHO_BAND`; one
   distance of each method under the profiler; the cardiac-cycle matrix
   and its MDS at 112 x 112 (`MDS_FRAMES`, `MDS_STRIDE`); quickstart,
   color_transfer, barycenter, batch_serving (bitwise) and ssae (finite
   loss) at their defaults; the MoE trainer's `HUNDRED_M` at 1 x 8 x 512
   for `MOE_STEPS` steps with each router (its loss falls).
14. (run right after phase 13) the ssm, vlm and audio families at full width
   and depth, random float32 masters drawn on the card, each model freed
   before the next; plain torch, so the counts, set to 0 just before the
   phase (and before each prefill and serve), read 0 after it. Mamba2-130M
   (128,940,480 parameters): the SSD's cross-chunk scan alone at the
   chunk states of 1 x 32768 and 1 x 524288, the model's odd/even scan
   against the doubling scan (ms, kernels, peak memory, agreement); a
   1 x 32768 ``prefill_step`` (warm under the
   profiler, then timed; finite logits, the repeat bitwise equal; wall,
   tokens/s, peak memory), the same at long_500k's 1 x 524288 or the
   longest of `LONG_LENS` that fits, decode against forward in float32
   over `SSM_DECODE_LEN` tokens at `DECODE_TOL`, ``serve`` at batch 8 (32 +
   32) and one decode step under the profiler, and three AdamW steps at 1
   x TRAIN_SEQ from one state with ``remat="none"`` and ``"full"``: losses
   bitwise equal, gradients finite and bitwise equal or named leaf by leaf,
   each step's time and peak memory. Whisper-large-v3 (2,020,421,120; 1500
   stub frames) and Llama-3.2-Vision-11B (9,775,157,248; 1600 stub image
   tokens): a 1 x 32768 prefill with the stub memory, ``serve`` at batch 8
   (the cross cache filled) and a profiled decode step, then decode in
   float32 over `CROSS_DECODE_LEN` tokens with the cross cache against
   without it (`DECODE_TOL`) and against ``forward``: Llama's at
   `DECODE_TOL`, Whisper's printed as C-15's measure (its forward runs the
   FFN before the cross-attention, its decode after).
15. (run right after phase 14) the mesh slice: (iii) first starts the
   dry-run in subprocesses (a fake process group cannot share a process
   with NCCL): one cell of each family (`DRYRUN_FAMILIES`), ``decode_32k``,
   on the 16x16 and the 2x16x16 mesh, and RecurrentGemma-2B's train step
   at 1 x TRAIN_SEQ on a 1x1 mesh (its default ``chunked`` scan: the
   dry-run's parameters lie on ``meta``, where B5 does not run); then (i) builds a 1x1 CUDA mesh (a world-1
   NCCL group) and runs RecurrentGemma-2B's train step at full width, 1 x
   TRAIN_SEQ, ``rglru_backend="pallas"``, three steps placed by
   ``param_specs``, then the same three steps unsharded from the same seed,
   each state freed before the next: losses, and each parameter's float64
   sum, sum of squares and first 4096 entries after step 3, bitwise equal;
   each step's time and peak memory, and B5/B6's launches (counts set to 0
   just before each step and read just after: one of each an RG-LRU
   layer, nothing else); (ii) ``BucketedExecutor(mesh=<1x1>)`` on 8 of
   phase 11's problems with ``spar_sink_mf``, bitwise ``mesh=None``'s
   solutions, one B1 launch a problem; then (iii)'s records: each one's
   collectives, their bytes, ``model_flops_global``, per-device bytes and
   seconds, and the 1x1 estimate beside (i)'s measured peak.

``--profile`` also runs (a), one prefill, one serving decode step and one
train step of RecurrentGemma under `torch.profiler` and prints where their
device time goes (phase 12 profiles OLMoE's prefill and decode step always).
``--compare-with`` runs no phase but 1: it builds each other source (an
earlier ``fused_sinkhorn.cu``, ``block_ell.cu``, ``lru_scan.cu`` or
``gather_kernel.cu``, or a variant of the current one) apart and times its
bare launches in turns with the current ones, by CUDA events and the
profiler's device time (`compare_sources`, which also prints both online
kernels' inner-loop SASS mix; `compare_block_ell`, both products;
`compare_lru_scan`, B5 and B6; `compare_gather`, B1 bare and as the sketch
calls it, bitwise or not, with its loads and stores in the SASS).
``--run-b-with`` runs no phase but 1: it solves phase 3's runs (b) and (a)
from another checkout (say the parent commit, ``git archive`` unpacked
under ``build/``) and from this one in turns (`compare_run_b`).
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound of each kernel
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12  # outside the tensor cores (NVIDIA data sheet)
# exponentials (MUFU.EX2) per clock per SM on compute capability 9.0 (CUDA
# C++ Programming Guide, arithmetic instruction throughput); times the SMs
# and the maximum SM clock that nvidia-smi reports
SFU_PER_CLOCK_PER_SM = 16

K_TOL = dict(rtol=2e-3, atol=1e-6)  # the reference kernel tests' tolerances
C_TOL = dict(rtol=2e-4, atol=1e-5)
# the float64 cost-only kernel against the float64 plain version: 1e-13
# relative, plus COST64_ULPS ulps of |x|^2 + |y|^2 carried through the cost
# (`cost64_excess`: the two sum over d in different orders)
COST64_RTOL, COST64_ULPS = 1e-13, 64
# the gathered segment logsumexp against its plain version on the card, on
# finite outputs, relative to max(|out|, 1): the kernel sums a segment's
# exponentials in its own fixed order, the plain chain in cub's
SEGMENT_LSE_RTOL = 1e-13
# the point dimensions of phase 2's gathered-kernel cases
GATHER_DIMS = (1, 3, 5, 8, 13)
MATVEC_TOL = dict(rtol=2e-4, atol=2e-5)
LSE_TOL = dict(rtol=2e-4, atol=5e-4)
# column slices P over which phase 2 times the bare online launches
SLICE_SWEEP = (1, 2, 4, 8, 16)
# the shapes (n, m, d) of the reference's online-kernel tests (tests/test_kernels.py)
SWEEP_SHAPES = [(64, 64, 2), (256, 128, 5), (300, 257, 3), (512, 512, 50), (100, 700, 8)]
NEG_INF = -1e30
# the reference's block-ELL kernel tests (tests/test_kernels_cpu.py): tolerance and shapes
BLOCK_ELL_TOL = dict(rtol=2e-4, atol=1e-6)
BLOCK_ELL_SHAPES = [(8, 2, 4), (16, 4, 8), (32, 3, 4)]
# the reference's LRU scan test (tests/test_kernels.py::test_lru_scan_kernel_sweep):
# tolerance and shapes; the serving slice's prefill shape (B, S, W) and the
# training slice's come first (both timed), a sequence shorter than a chunk last
LRU_TOL = dict(rtol=1e-5, atol=1e-5)
LRU_SHAPES = [(1, 32768, 2560), (1, 2048, 2560), (2, 64, 32), (1, 300, 130), (2, 512, 256), (2, 20, 40)]
# the decode-matches-forward tolerances of tests/test_models.py
DECODE_TOL = dict(rtol=2e-2, atol=2e-3)
PREFILL_LEN = 32768  # the prefill_32k cell's sequence length
# the training slice's sequence length at global batch 1 (train_4k's 256 x
# 4096 does not fit one card beside the 42.6 GB of params and moments)
TRAIN_SEQ = 2048
# the reference LRU scan test's gradient tolerance (tests/test_kernels.py:120-121)
LRU_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# B6's shapes: the training step's, the prefill's (comparable with B5), the reference test's
LRU_BWD_SHAPES = [(1, TRAIN_SEQ, 2560), (1, PREFILL_LEN, 2560), (2, 64, 32), (1, 300, 130), (2, 512, 256)]
# one RG-LRU layer's float32 gradients, pallas against chunked: the largest
# difference over the largest entry of each gradient
LAYER_GRAD_RTOL = 1e-3


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


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.split()[0]) * 1e6


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


def device_ms(fn, reps: int = 20) -> float | None:
    """Mean device time of the kernels that one ``fn()`` launches, from
    `torch.profiler` over ``reps`` calls (a launch shorter than its host
    overhead leaves the card idle between CUDA events); None if the
    profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return total_us / reps / 1e3 if total_us > 0 else None


def device_ms_by_kernel(fn, reps: int = 20) -> dict[str, float]:
    """The mean device milliseconds of each kernel that ``fn()`` launches,
    by kernel name (shortened), from `torch.profiler` over ``reps`` calls:
    a kernel's time over the launches the profiler recorded (where that
    is not ``reps``, the name says how many it recorded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = re.sub(r"^.*?(\w+(?:<[^>]*>)?)\(.*$", r"\1", e.key)[:60]
            out[name if e.count == reps else f"{name} ({e.count} of {reps} launches recorded)"] = (
                e.self_device_time_total / e.count / 1e3)
    return out


def ptxas_report(log_text: str, marker: str) -> dict[str, dict[str, int]]:
    """Registers, static shared memory, stack frame and spill bytes of
    every kernel whose (mangled) name holds ``marker``, from the build's
    ``-Xptxas -v`` log (dynamic shared memory is the launch's, not
    listed)."""
    report, name = {}, None
    for line in log_text.splitlines():
        if found := re.search(r"Compiling entry function '([^']+)'", line):
            name = found.group(1) if marker in found.group(1) else None
        elif name and (found := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                           r"(\d+) bytes spill loads", line)):
            report.setdefault(name, {}).update(
                stack=int(found.group(1)), spill_stores=int(found.group(2)), spill_loads=int(found.group(3)))
        elif name and (found := re.search(r"Used (\d+) registers", line)):
            report.setdefault(name, {})["registers"] = int(found.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            report[name]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return report


def log_ptxas(marker: str) -> None:
    """Print the build's ptxas report (registers, stack, spills) of every
    kernel whose mangled name holds ``marker``."""
    from repro_torch.kernels import library

    for name, res in sorted(ptxas_report(library.ptxas_log().read_text(), marker).items()):
        log(f"ptxas {name}: {json.dumps(res)}")


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


def cost64_excess(x, y, rows, cols, c64, c64_r, cost: str, eta: float) -> float:
    """The largest ``|C - C_ref| / (COST64_RTOL |C_ref| + COST64_ULPS eps64
    (|x|^2 + |y|^2)_max |dC/dsq|)`` over the finite plain costs: the kernel
    sums over d in its own order, torch in another, so sq = |x|^2 + |y|^2 -
    2 <x, y> differs by a few ulps of the norms (not of sq); the cost
    carries that through its derivative (1 for sqeuclidean; tan z /
    (2 eta sqrt(sq)) for WFR, large near the blocked range). At most 1
    passes."""
    import torch

    from repro_torch.kernels.ref import gathered_cost_ref

    scale = float((x.double() ** 2).sum(1).max() + (y.double() ** 2).sum(1).max())
    finite = torch.isfinite(c64_r)
    ref = c64_r[finite]
    slope = torch.ones_like(ref)
    if cost == "wfr":
        dist = torch.sqrt(gathered_cost_ref(x, y, rows, cols)[finite] + 1e-30)
        z = torch.clamp_max(dist / (2.0 * eta), math.pi / 2.0)
        slope = torch.tan(z) / (2.0 * eta * dist)
    tol = COST64_RTOL * ref.abs() + COST64_ULPS * torch.finfo(torch.float64).eps * scale * slope
    return float(((c64[finite] - ref).abs() / tol).max()) if ref.numel() else 0.0


def _gathered_case(x, y, rows, cols, *, eps: float, cost: str, eta: float) -> float:
    """Both gathered kernels on one case, checked (`ops.gathered_kernel`,
    `ops.gathered_cost`) and unchecked (the sketch's entries), against their
    plain versions: K and C at K_TOL / C_TOL, the float64 costs within
    `cost64_excess`'s rounding-level tolerance,
    blocked WFR pairs exactly (0, +inf) and +inf; two launches and the two
    entries bitwise equal. Returns the largest error."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gathered_cost_ref, gathered_kernel_ref

    k_e, c_e = ops.gathered_kernel(x, y, rows, cols, eps=eps, cost=cost, eta=eta)
    k_s, c_s = ops.gathered_sketch_kernel(x, y, rows, cols, eps=eps, cost=cost, eta=eta)
    c64 = ops.gathered_cost(x, y, rows, cols, cost=cost, eta=eta)
    c64_s = ops.gathered_sketch_cost(x, y, rows, cols, cost=cost, eta=eta)
    k_r, c_r = gathered_kernel_ref(x, y, rows, cols, eps=eps, cost=cost, eta=eta)
    c64_r = gathered_cost_ref(x, y, rows, cols, cost=cost, eta=eta)
    torch.cuda.synchronize()
    what = f"{cost} d={x.shape[1]} {x.dtype} k={rows.shape[0]}"
    check(c64.dtype == torch.float64 and k_e.dtype == c_e.dtype == torch.float32, f"{what}: output types")
    for a, b, name in ((k_e, k_s, "K"), (c_e, c_s, "C"), (c64, c64_s, "float64 C")):
        check(bool(torch.equal(a, b)), f"{what}: the sketch's {name} is not bitwise the checked wrapper's")
    blocked = torch.isinf(c_r)
    check(bool(torch.equal(torch.isinf(c_e), blocked)) and bool(torch.equal(torch.isinf(c64), torch.isinf(c64_r))),
          f"{what}: the blocked set differs from the plain version")
    check(bool((k_e[blocked] == 0).all()) and bool(torch.isposinf(c_e[blocked]).all())
          and bool(torch.isposinf(c64[torch.isinf(c64_r)]).all()), f"{what}: blocked pairs are not (0, +inf)")
    torch.testing.assert_close(k_e[~blocked], k_r[~blocked], **K_TOL)
    torch.testing.assert_close(c_e[~blocked], c_r[~blocked], **C_TOL)
    finite = torch.isfinite(c64_r)
    excess = cost64_excess(x, y, rows, cols, c64, c64_r, cost, eta)
    check(excess <= 1.0, f"{what}: the float64 costs miss the plain version's by {excess!r} x the tolerance")
    again = ops.gathered_sketch_kernel(x, y, rows, cols, eps=eps, cost=cost, eta=eta)
    again64 = ops.gathered_sketch_cost(x, y, rows, cols, cost=cost, eta=eta)
    check(bool(torch.equal(again[0], k_s)) and bool(torch.equal(again[1], c_s)) and bool(torch.equal(again64, c64_s)),
          f"{what}: two launches are not bitwise equal")
    return max(_max_abs_err(k_e, k_r), _max_abs_err(c_e, c_r), _max_abs_err(c64, c64_r))


def check_gathered_kernel(n: int, k: int, d: int, device) -> list[dict]:
    """Phase 2 for B1 and its float64 cost-only mode: both against their
    plain versions at the main path's shape, with WFR's blocked pairs, over
    d in GATHER_DIMS, float32 and float64 points, k not a multiple of the
    pairs a thread, y apart from x and indices 8 bytes into their storage;
    the pack's layout; the range checks; then the times, the device time of
    each kernel by name and the registers. Returns the two ``kernels``
    entries."""
    import torch

    from repro_torch.kernels import library, ops
    from repro_torch.kernels.gather_kernel import _launch_gathered_cost, _launch_gathered_kernel, _packed, packed_stride
    from repro_torch.kernels.ref import gathered_cost_ref, gathered_kernel_ref, packed_rows_ref

    eps = 0.1
    lib = library.load()
    check(all(lib.gathered_packed_stride(dd) == packed_stride(dd) for dd in range(1, 65)),
          "the C and Python packed strides differ")
    x, rows, cols = _gathered_inputs(n, k, d, device, seed=0)
    err = _gathered_case(x, x, rows, cols, eps=eps, cost="sqeuclidean", eta=1.0)
    log(f"gathered_kernel/gathered_cost sqeuclidean k={k} n={n} d={d} float64 points: max_abs_err={err!r}, "
        f"two launches bitwise equal, the sketch's entries bitwise the checked wrappers'")

    # WFR with blocked pairs: two clusters further apart than pi * eta
    eta = 0.2
    xw = 0.2 * x
    xw[n // 2:, 0] += 1.8
    kw = min(k, 1 << 20) - 1
    share = float(torch.isinf(gathered_cost_ref(xw, xw, rows[:kw], cols[:kw], cost="wfr", eta=eta)).double().mean())
    check(0.1 < share < 0.9, f"WFR case blocks {share} of its pairs")
    err_w = _gathered_case(xw, xw, rows[:kw], cols[:kw], eps=eps, cost="wfr", eta=eta)
    log(f"gathered_kernel/gathered_cost wfr k={kw} blocked_share={share!r}: max_abs_err={err_w!r}")

    # d, point types, y apart from x (m != n), k odd, indices 8 bytes into
    # their storage (no 16-byte index loads)
    errs = {}
    gen = torch.Generator(device=device).manual_seed(1)
    for dd in GATHER_DIMS:
        for dtype in (torch.float32, torch.float64):
            xs = torch.rand((4096, dd), dtype=torch.float64, device=device, generator=gen).to(dtype)
            ys = torch.rand((3001, dd), dtype=torch.float64, device=device, generator=gen).to(dtype)
            ri = torch.sort(torch.randint(0, 4096, (100_004,), device=device, generator=gen)).values
            ci = torch.randint(0, 3001, (100_004,), device=device, generator=gen)
            e = _gathered_case(xs, ys, ri[:100_003], ci[:100_003], eps=eps, cost="sqeuclidean", eta=1.0)
            e = max(e, _gathered_case(xs, ys, ri[1:], ci[1:], eps=eps, cost="sqeuclidean", eta=1.0))
            # WFR on two clusters, as the reference's kernel tests draw them:
            # each pair well inside the range pi * eta (diameter 0.4 < 0.63)
            # or beyond it, the clusters centred at -1 and +1 on the first
            # axis. In float32 the formula |x|^2 + |y|^2 - 2 <x, y> loses
            # the digits that C_TOL asks for near the range (where -2 log cos
            # is ill-conditioned) and for points far from the origin (where
            # it cancels); there the kernel and the plain version, which
            # round in other places, differ by more than C_TOL
            xw2 = xs * (0.4 / math.sqrt(dd))
            xw2[:2048, 0] -= 1.0
            xw2[2048:, 0] += 1.0
            cw = torch.randint(0, 4096, (100_003,), device=device, generator=gen)
            e = max(e, _gathered_case(xw2, xw2, ri[:100_003], cw, eps=eps, cost="wfr", eta=0.2))
            errs[f"d{dd} {str(dtype)[6:]}"] = e
            # the pack's rows against the plain layout: coordinates bitwise,
            # zeros, the norm to its rounding (float32: fused there, not here)
            for out_dtype, launch_fn, outs, kw in (
                (torch.float32, _launch_gathered_kernel, (torch.empty(8, device=device),) * 2, dict(eps=eps)),
                (torch.float64, _launch_gathered_cost, (torch.empty(8, dtype=torch.float64, device=device),), {}),
            ):
                packed = _packed(xs, ys, out_dtype)
                launch_fn(xs, ys, ri[:8], ci[:8], *outs, None, cost="sqeuclidean", eta=1.0, packed=packed, **kw)
                stride = packed_stride(dd)
                want = torch.cat([packed_rows_ref(xs, out_dtype), packed_rows_ref(ys, out_dtype)])
                torch.cuda.synchronize()
                got = packed.reshape(-1, stride)
                check(bool(torch.equal(got[:, :dd], want[:, :dd])) and bool((got[:, dd + 1:] == 0).all()),
                      f"the packed {out_dtype} rows of d = {dd} differ from the plain layout")
                torch.testing.assert_close(got[:, dd], want[:, dd], rtol=dd * torch.finfo(out_dtype).eps, atol=0)
    log(f"gathered_kernel/gathered_cost over d in {GATHER_DIMS} x (float32, float64 points) x (sqeuclidean, "
        f"wfr), y apart from x, k = 100,003, and indices 8 bytes into their storage: max_abs_err {json.dumps(errs)}; "
        f"the packed rows match the plain layout")

    # an index outside the points is flagged by the kernels and raises
    bad_cols = cols[:1024].clone()
    bad_cols[-1] = n
    for fn, kwargs in ((ops.gathered_kernel, dict(eps=eps)), (ops.gathered_cost, {})):
        try:
            fn(x, x, rows[:1024], bad_cols, **kwargs)
        except IndexError:
            pass
        else:
            check(False, f"{fn.__name__}: an out-of-range column index did not raise")
    log("gathered_kernel, gathered_cost: an out-of-range index raises IndexError")
    log_ptxas("gathered_")

    # times at the main path's shapes: the wrappers as the sketches call
    # them (no flag), the checked wrappers, the bare launches (the pack and
    # the kernel, outputs and scratch allocated once), each kernel's device
    # time by name, and the plain versions
    k_out, c_out, c64_out = (torch.empty(k, dtype=dt, device=device) for dt in (torch.float32,) * 2 + (torch.float64,))
    packed32, packed64 = _packed(x, x, torch.float32), _packed(x, x, torch.float64)
    entries = []
    for name, sketch_call, checked_call, bare, plain, out_bytes, ops_per_pair, rate in (
        ("gathered_kernel",
         lambda: ops.gathered_sketch_kernel(x, x, rows, cols, eps=eps, cost="sqeuclidean", eta=1.0),
         lambda: ops.gathered_kernel(x, x, rows, cols, eps=eps),
         lambda: _launch_gathered_kernel(x, x, rows, cols, k_out, c_out, None, eps=eps, cost="sqeuclidean",
                                         eta=1.0, packed=packed32),
         lambda: gathered_kernel_ref(x, x, rows, cols, eps=eps), 8, 6 * d + 6, FP32_OPS_PER_S),
        ("gathered_cost",
         lambda: ops.gathered_sketch_cost(x, x, rows, cols, cost="sqeuclidean", eta=1.0),
         lambda: ops.gathered_cost(x, x, rows, cols),
         lambda: _launch_gathered_cost(x, x, rows, cols, c64_out, None, cost="sqeuclidean", eta=1.0,
                                       packed=packed64),
         lambda: gathered_cost_ref(x, x, rows, cols), 8, 6 * d + 4, FP64_OPS_PER_S),
    ):
        ms = time_ms(sketch_call)
        checked_ms = time_ms(checked_call)
        bare_ms = time_ms(bare)
        by_kernel = device_ms_by_kernel(bare)
        plain_ms = time_ms(plain, reps=10)
        # least work: the points read once (x is y here, float64 as the path
        # holds them), both index arrays read once, the outputs written
        # once; the operations of a pair at the rate of their type
        nbytes = x.numel() * 8 + 2 * k * 8 + k * out_bytes
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, k * ops_per_pair / rate * 1e3
        log(f"{name} times: as the sketch calls it {ms!r} ms, checked wrapper {checked_ms!r} ms, bare launch "
            f"{bare_ms!r} ms, device ms by kernel (profiler) {json.dumps(by_kernel)}, plain {plain_ms!r} ms, "
            f"bound {max(t_bytes, t_ops)!r} ms ({nbytes} bytes {t_bytes!r} ms, {k * ops_per_pair} ops {t_ops!r} ms)")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gather_kernel.cu",
            # the cost-only mode is B1's too: the reference gathers these
            # costs with XLA outside Pallas (src/repro/core/geometry.py:107)
            "replaces": "src/repro/kernels/gather_kernel.py:51",
            "launches": None,  # filled in from the main path's run
            "max_abs_err": max(err, err_w, *errs.values()),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,  # no single PyTorch call computes this function
        })
    return entries


def online_bound(n: int, m: int, d: int, ops_per_pair: int, sm_clock_hz: float, sms: int):
    """(bound ms, bound_by, detail) of a streaming kernel over n x m pairs:
    the larger of its float32 operations at the card's float32 rate, its
    n*m exponentials at the SFU rate, and its bytes (points, weights and
    output each moved once) at the HBM rate."""
    pairs = n * m
    nbytes = 4 * ((n + m) * d + m + n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * ops_per_pair / FP32_OPS_PER_S * 1e3
    t_exp = pairs / (SFU_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3
    bound = max(t_bytes, t_ops, t_exp)
    detail = (f"{pairs} pairs, float32 ops {t_ops!r} ms ({ops_per_pair}/pair), exp {t_exp!r} ms "
              f"({SFU_PER_CLOCK_PER_SM}/clock/SM x {sms} SMs at {sm_clock_hz / 1e6!r} MHz), "
              f"bytes {t_bytes!r} ms ({nbytes} B)")
    return bound, ("bytes" if t_bytes >= max(t_ops, t_exp) else "operations"), detail


def _wfr_clusters(x, n: int):
    """Two clusters of n/2 points further apart than pi * eta at eta = 0.2
    (about half the pairs blocked) as targets y, and the same points as x
    but for x_0, moved out of range of every target (a fully blocked row)."""
    y = 0.2 * x[:n].clone()
    y[n // 2:, 0] += 1.8
    xw = y.clone()
    xw[0, 1] += 10.0
    return xw, y


def check_online_kernels(n: int, device, sm_clock_hz: float) -> list[dict]:
    """online_matvec and online_lse against their plain versions: at the
    fused path's shape (run (a)'s points, n = m = 2^17, d = 5, eps = 0.1),
    in a WFR case, and over the reference tests' shapes; two launches
    bitwise equal; the kernels' registers and spills (none allowed outside
    the WFR kernels), rows a thread R and column slices P; times of the wrapper, the bare launch (at
    the chosen P and at each P of `SLICE_SWEEP`) and the plain version at
    2^17, and of the wrapper and the bare launch at n = m = 2^14."""
    import numpy as np
    import torch

    from repro_torch.data.pointclouds import make_measures
    from repro_torch.kernels import library
    from repro_torch.kernels.fused_sinkhorn import (
        ROWS_PER_THREAD,
        _launch_online_lse,
        _launch_online_matvec,
        slices_for,
    )
    from repro_torch.kernels.ops import online_lse, online_matvec
    from repro_torch.kernels.ref import online_lse_ref, online_matvec_ref

    eps, d = 0.1, 5
    _, _, x = make_measures("C1", n, d, seed=0)
    x = torch.as_tensor(x, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    v = torch.rand(n, dtype=torch.float64, device=device, generator=gen)
    g = 0.1 * torch.randn(n, dtype=torch.float64, device=device, generator=gen)
    xw, yw = _wfr_clusters(x, min(n, 1 << 14))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    kernels = [
        ("online_matvec", online_matvec, online_matvec_ref, _launch_online_matvec, v, MATVEC_TOL,
         "src/repro/kernels/fused_sinkhorn.py:110", 2 * d + 7),
        ("online_lse", online_lse, online_lse_ref, _launch_online_lse, g, LSE_TOL,
         "src/repro/kernels/fused_sinkhorn.py:142", 2 * d + 10),
    ]
    report = ptxas_report(library.ptxas_log().read_text(), "online_")
    check(len(report) > 0, "no online_ kernel in the -Xptxas -v log")

    def short(mangled: str) -> str:  # online_f32<D, kWfr, kLse> as "d5 sq lse"
        if found := re.search(r"online_f32ILi(\d+)ELb([01])ELb([01])E", mangled):
            return f"d{found.group(1)} {('sq', 'wfr')[int(found.group(2))]} {('matvec', 'lse')[int(found.group(3))]}"
        return mangled.split("online_")[-1][:40]

    log("ptxas (registers, spill stores, spill loads, stack bytes) of the online kernels: " + json.dumps(
        {short(k): [res["registers"], res["spill_stores"], res["spill_loads"], res["stack"]]
         for k, res in sorted(report.items())}))
    spilled = [short(k) for k, res in report.items() if res["spill_stores"] or res["spill_loads"]]
    # the WFR kernels save registers around the calls of their accurate
    # library functions; no other kernel may spill
    check(not [k for k in spilled if " wfr " not in k], f"ptxas reports spills outside the WFR kernels {spilled}")
    log(f"ptxas: kernels with spills {sorted(spilled)}")
    entries = []
    for name, wrapper, plain, bare, w, tol, replaces, ops_per_pair in kernels:
        lse = name == "online_lse"
        # the sqeuclidean d = 5 kernel's mangled name: online_f32<5, false, lse>
        main_kernel = [res for k, res in report.items() if f"online_f32ILi5ELb0ELb{int(lse)}E" in k]
        check(len(main_kernel) == 1, f"{name}: the d = 5 kernel is not in the -Xptxas -v log")
        log(f"{name} d=5 sqeuclidean kernel: R = {ROWS_PER_THREAD} rows a thread, "
            f"P = {slices_for(n, n, d, cost='sqeuclidean', lse=lse)} slices at n = m = {n}, "
            f"P = {slices_for(1 << 14, 1 << 14, d, cost='sqeuclidean', lse=lse)} at n = m = {1 << 14}, "
            f"{main_kernel[0]['registers']} registers, {main_kernel[0]['spill_stores']} B spill stores, "
            f"{main_kernel[0]['spill_loads']} B spill loads, {main_kernel[0]['stack']} B stack")
        out = wrapper(x, x, w, eps=eps)
        again = wrapper(x, x, w, eps=eps)
        ref = plain(x, x, w, eps=eps)
        torch.cuda.synchronize()
        check(bool(torch.equal(out, again)), f"{name}: two launches differ")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        torch.testing.assert_close(out, ref, **tol)
        err = _max_abs_err(out, ref)
        log(f"{name} sqeuclidean n=m={n} d={d}: max_abs_err={err!r}, two launches bitwise equal")

        # WFR: half the pairs blocked, row 0 blocked from every target
        ww = w[: yw.shape[0]]
        out_w = wrapper(xw, yw, ww, eps=eps, cost="wfr", eta=0.2)
        ref_w = plain(xw, yw, ww, eps=eps, cost="wfr", eta=0.2)
        torch.cuda.synchronize()
        check(not bool(torch.isnan(out_w).any()), f"{name} wfr: NaN in the output")
        if name == "online_matvec":
            check(float(out_w[0]) == 0.0 and float(ref_w[0]) == 0.0, f"{name} wfr: blocked row is not 0")
        else:
            check(float(out_w[0]) <= NEG_INF / 2 and float(ref_w[0]) <= NEG_INF / 2,
                  f"{name} wfr: fully blocked row {float(out_w[0])!r} is not at the -1e30 sentinel")
        torch.testing.assert_close(out_w[1:], ref_w[1:], **tol)
        err_w = _max_abs_err(out_w[1:], ref_w[1:])
        blocked = sum(int((torch.cdist(yw[r:r + 4096], yw) >= math.pi * 0.2).sum())
                      for r in range(0, yw.shape[0], 4096))
        log(f"{name} wfr n=m={yw.shape[0]} blocked_share={blocked / yw.shape[0] ** 2!r} "
            f"(and row 0 wholly): max_abs_err={err_w!r}, blocked row {float(out_w[0])!r}")

        # the shapes of the reference's kernel tests: ragged tiles, d = 50
        err_s = 0.0
        for shape in SWEEP_SHAPES:
            for cost in ("sqeuclidean", "wfr"):
                rng = np.random.default_rng(sum(shape))
                xs = torch.as_tensor(rng.uniform(size=shape[::2]), dtype=torch.float32, device=device)
                ys = torch.as_tensor(rng.uniform(size=shape[1:]), dtype=torch.float32, device=device)
                ws = torch.as_tensor(rng.uniform(size=shape[1]) if name == "online_matvec"
                                     else 0.1 * rng.standard_normal(shape[1]),
                                     dtype=torch.float32, device=device)
                e = 0.1 if name == "online_matvec" else 0.05
                o = wrapper(xs, ys, ws, eps=e, cost=cost, eta=0.3)
                r = plain(xs, ys, ws, eps=e, cost=cost, eta=0.3)
                torch.testing.assert_close(o, r, **tol)
                err_s = max(err_s, _max_abs_err(o, r))
        log(f"{name} over the reference test shapes {SWEEP_SHAPES} x (sqeuclidean, wfr): "
            f"max_abs_err={err_s!r}")

        # times at the fused path's shape: the wrapper as the loop calls it
        # (float64 weights cast to float32), the bare launch, the plain version
        ms = time_ms(lambda: wrapper(x, x, w, eps=eps))
        xf, wf = x.to(torch.float32).contiguous(), w.to(torch.float32).contiguous()
        buf = torch.empty(n, dtype=torch.float32, device=device)
        bare_ms = time_ms(lambda: bare(xf, xf, wf, buf, eps=eps, cost="sqeuclidean", eta=1.0))
        plain_ms = time_ms(lambda: plain(x, x, w, eps=eps), warmup=1, reps=5)
        bound, bound_by, detail = online_bound(n, n, d, ops_per_pair, sm_clock_hz, sms)
        log(f"{name} times: wrapper {ms!r} ms, bare launch {bare_ms!r} ms, plain {plain_ms!r} ms, "
            f"bound {bound!r} ms ({bound_by}: {detail})")
        # the bare launch over each slice count, and the small-n behaviour of the split
        n_small = min(n, 1 << 14)
        xs, ws = xf[:n_small].contiguous(), wf[:n_small].contiguous()
        for size, pts, wts in ((n, xf, wf), (n_small, xs, ws)):
            out_p = torch.empty(size, dtype=torch.float32, device=device)
            sweep = {p: time_ms(lambda p=p: bare(pts, pts, wts, out_p, eps=eps, cost="sqeuclidean",
                                                  eta=1.0, slices=p), reps=10 if size == n else 20)
                     for p in SLICE_SWEEP}
            line = f"{name} bare launch at n=m={size} by slices P: {json.dumps(sweep)}"
            if size == n_small:
                small_ms = time_ms(lambda: wrapper(x[:size], x[:size], w[:size], eps=eps))
                small_bare = time_ms(lambda: bare(xs, xs, ws, out_p, eps=eps, cost="sqeuclidean", eta=1.0))
                small_bound = online_bound(size, size, d, ops_per_pair, sm_clock_hz, sms)[0]
                line += (f"; at the chosen P: wrapper {small_ms!r} ms, bare {small_bare!r} ms, "
                         f"bound {small_bound!r} ms")
            log(line)
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_sinkhorn.cu",
            "replaces": replaces,
            "launches": None,  # filled in from the fused path's run
            "max_abs_err": max(err, err_w, err_s),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes this function
        })
    return entries


def sass_loop_mix(lib_path: Path, marker: str, pairs: int | None) -> dict:
    """The instruction mix of the innermost loop that holds MUFU.EX2 in the
    kernel whose mangled name holds ``marker``, from ``cuobjdump -sass``
    (the unrolled loop with the most exponentials, if there are several):
    counts by opcode class, and the same per pair, for ``pairs`` pairs an
    iteration (None: one a MUFU, a matvec's unrolled loop). The counts are
    static: a branch inside the loop that rarely runs (the lazy LSE's
    rescaling) counts in full."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = marker in line
        elif inside and (found := re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)):
            body.append((int(found.group(1), 16), found.group(2).strip()))
    check(len(body) > 0, f"no SASS for a kernel named like {marker} in {lib_path}")
    loops = []
    for addr, ins in body:
        target = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", ins)
        if target and target.group(1) and int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))

    def mix(lo, hi):
        counts = {}
        for addr, ins in body:
            if lo <= addr <= hi:
                op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]
                counts[op] = counts.get(op, 0) + 1
        return counts

    with_exp = [(lo, hi, mix(lo, hi)) for lo, hi in loops]
    with_exp = [(lo, hi, c) for lo, hi, c in with_exp if c.get("MUFU", 0)]
    check(len(with_exp) > 0, f"no loop with MUFU in {marker}")
    innermost = [(lo, hi, c) for lo, hi, c in with_exp
                 if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi) for l2, h2, _ in with_exp)]
    lo, hi, counts = max(innermost, key=lambda item: item[2]["MUFU"])
    pairs = pairs or counts["MUFU"]
    classes = ("FFMA", "FADD", "FMUL", "FMNMX", "MUFU", "LDS")
    per_pair = {op: counts.get(op, 0) / pairs for op in classes}
    per_pair["all"] = sum(counts.values()) / pairs
    return {"pairs_per_iteration": pairs, "counts": counts, "per_pair": per_pair}


def sampled_clocks(fn):
    """Run ``fn()`` while nvidia-smi samples the SM clock (MHz) and power
    draw (W) every 100 ms; returns fn's result and the samples' medians."""
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        result = fn()
    finally:
        sampler.terminate()
        out = sampler.communicate()[0]
    rows = [[float(v) for v in line.split(",")] for line in out.splitlines() if line.count(",") == 1]
    medians = {"sm_mhz": statistics.median(r[0] for r in rows), "power_w": statistics.median(r[1] for r in rows),
               "samples": len(rows)} if rows else None
    return result, medians


def build_apart(source: Path, marker: str):
    """Build another CUDA source into a library of its own under
    ``build/compare/`` (the current library's flags) and print the ptxas
    report of its kernels named like ``marker``; returns the loaded library
    and its path."""
    import ctypes

    from repro_torch.kernels import library

    out_dir = library.BUILD_DIR.parent / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libold_{source.stem}.so"
    t0 = time.perf_counter()
    built = subprocess.run([library._nvcc(), *library.NVCC_FLAGS, *library.PTXAS_FLAGS, "-shared", "-o",
                            str(lib_path), str(source)], capture_output=True, text=True, check=True)
    log(f"compare: built {source} in {time.perf_counter() - t0!r} s")
    for kname, res in sorted(ptxas_report(built.stdout + built.stderr, marker).items()):
        log(f"compare: old ptxas {kname}: {json.dumps(res)}")
    return ctypes.CDLL(str(lib_path)), lib_path


def c_arity(source_text: str, function: str) -> int:
    """The number of parameters of the C function ``function`` in a source."""
    return len(re.search(rf"int {function}\(([^)]*)\)", source_text).group(1).split(","))


def compare_sources(old_source: Path, device) -> None:
    """``--compare-with OLD_SOURCE``: another ``fused_sinkhorn.cu`` (an
    earlier one, whose launch functions take (x, y, w, n, m, d, eps, wfr,
    eta, out, stream), or a variant of the current one, which also takes
    slices and scratch) is built into a library of its own under
    ``build/compare/``; its bare
    online_matvec and online_lse launches and the current ones are timed in
    turns (old, new, new, old) on run (a)'s points at n = m = 2^17 and 2^14,
    d = 5, eps = 0.1, after a check that both agree with the plain version,
    with the SM clock and power draw sampled meanwhile;
    then the SASS instruction mix of each d = 5 sqeuclidean kernel's inner
    loop, old and new."""
    import ctypes

    import torch

    from repro_torch.data.pointclouds import make_measures
    from repro_torch.kernels import library
    from repro_torch.kernels.fused_sinkhorn import ROWS_PER_THREAD, _launch_online_lse, _launch_online_matvec
    from repro_torch.kernels.ref import online_lse_ref, online_matvec_ref

    old, old_lib_path = build_apart(old_source, "online_")
    sliced = len(library.SIGNATURES["online_matvec"]) == c_arity(old_source.read_text(), "online_matvec_launch")
    for fn in (old.online_matvec_launch, old.online_lse_launch):
        fn.argtypes = list(library.SIGNATURES["online_matvec"]) if sliced else [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    if sliced:
        old.online_slices.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        old.online_slices.restype = ctypes.c_int

    eps, d = 0.1, 5
    _, _, x = make_measures("C1", 1 << 17, d, seed=0)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    v = torch.rand(x.shape[0], dtype=torch.float32, device=device, generator=gen)
    g = 0.1 * torch.randn(x.shape[0], dtype=torch.float32, device=device, generator=gen)
    kernels = [("online_matvec", old.online_matvec_launch, _launch_online_matvec, online_matvec_ref, v, MATVEC_TOL),
               ("online_lse", old.online_lse_launch, _launch_online_lse, online_lse_ref, g, LSE_TOL)]
    for size in (1 << 17, 1 << 14):
        pts = x[:size].contiguous()
        for name, old_fn, new_fn, plain, w, tol in kernels:
            wts = w[:size].contiguous()
            out = torch.empty(size, dtype=torch.float32, device=device)

            lse = name == "online_lse"
            extra = ()
            if sliced:
                p = old.online_slices(size, size, d, 0, int(lse))
                part = torch.empty((2 if lse else 1) * p * size, dtype=torch.float32, device=device)
                extra = (p, part.data_ptr())
                log(f"compare {name} n=m={size}: the other source takes P = {p}")

            def run_old():
                code = old_fn(pts.data_ptr(), pts.data_ptr(), wts.data_ptr(), size, size, d, eps, 0, 1.0,
                              *extra, out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
                check(code == 0, f"old {name} launch failed ({code})")

            def run_new():
                new_fn(pts, pts, wts, out, eps=eps, cost="sqeuclidean", eta=1.0)

            want = plain(pts, pts, wts, eps=eps)
            for label, fn in (("old", run_old), ("new", run_new)):
                fn()
                torch.cuda.synchronize()
                torch.testing.assert_close(out, want, **tol)
                log(f"compare {name} n=m={size}: {label} max_abs_err {_max_abs_err(out, want)!r}")
            reps = 10 if size == 1 << 17 else 40
            times, clocks = sampled_clocks(lambda: [(label, time_ms(fn, reps=reps)) for label, fn in (
                ("old", run_old), ("new", run_new), ("new", run_new), ("old", run_old))])
            log(f"compare {name} n=m={size} bare launch ms in turns: {json.dumps(times)}; "
                f"during them (nvidia-smi medians): {json.dumps(clocks)}")
    new_lib_path = library._build()
    # pairs an inner-loop iteration: the current source's R rows x 8 columns;
    # the earlier one's 4 columns (matvec, one MUFU each) and 16 (LSE)
    rk = ROWS_PER_THREAD * 8
    new_markers = (("online_matvec", "online_f32ILi5ELb0ELb0E", rk), ("online_lse", "online_f32ILi5ELb0ELb1E", rk))
    old_markers = new_markers if sliced else (("online_matvec", "online_matvec_f32ILi5ELb0E", None),
                                              ("online_lse", "online_lse_f32ILi5ELb0E", 16))
    for label, lib_path, markers in (
        ("old", old_lib_path, old_markers),
        ("new", new_lib_path, new_markers),
    ):
        for name, marker, pairs in markers:
            log(f"compare SASS {label} {name} d=5 inner loop: {json.dumps(sass_loop_mix(lib_path, marker, pairs))}")


def in_turns(runs, reps: int):
    """Each ``(label, fn)`` timed in turns, ``fn()`` a bare launch: a list of
    (label, median ms) in the order given, with the SM clock and power
    medians of nvidia-smi meanwhile."""
    return sampled_clocks(lambda: [(label, time_ms(fn, reps=reps)) for label, fn in runs])


def compare_block_ell(old_source: Path, device) -> None:
    """``--compare-with OLD_BLOCK_ELL_CU``: another ``block_ell.cu`` built
    apart: an earlier one (one launch function on float32 v and no dtype
    switch; or a dtype switch, every slot walked and a ``K~^T u`` of its
    own) or a variant of the current one (the valid counts). On the n = 8192
    OT sketch of phase 6: its ``K~ v`` on the row layout against the
    current one as the solver launches it (the valid slots alone) and over
    every slot; its ``K~^T u`` (the oldest: its ``K~ v`` kernel on the
    transposed layout) against the current one. Each is first held against
    the plain version, then timed in turns (old, new, new, old) as bare
    launches on float32 v, by CUDA events and by the profiler's device
    time; the current ones on float64 v too."""
    import ctypes

    import torch

    import repro_torch as rt
    from repro_torch.kernels import library
    from repro_torch.kernels.block_ell import _launch_block_ell_matvec, _launch_block_ell_rmatvec
    from repro_torch.kernels.ref import block_ell_matvec_ref, block_ell_rmatvec_ref

    old, _ = build_apart(old_source, "block_ell")
    text = old_source.read_text()
    arity = c_arity(text, "block_ell_matvec_launch")  # 13: no dtype switch, 14: a dtype switch, 15: valid counts
    P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    old.block_ell_matvec_launch.argtypes = ([P, P, P, P] + ([P] if arity == 15 else []) + [I64, I64, I64, INT, I64, I64]
                                            + ([INT] if arity >= 14 else []) + [P, P, P])
    old.block_ell_matvec_launch.restype = ctypes.c_int
    old_rmatvec = "block_ell_rmatvec_launch" in text
    if old_rmatvec:
        old.block_ell_rmatvec_launch.argtypes = list(library.SIGNATURES["block_ell_rmatvec"])
        old.block_ell_rmatvec_launch.restype = ctypes.c_int
    n = 8192
    ot, _ = block_ell_problems(n, device)
    sk = rt.build_block_ell_sketch(ot, torch.Generator(device=device).manual_seed(0), 16 * rt.s0(n))
    skt = transposed32(sk)
    gen = torch.Generator(device=device).manual_seed(1)
    v = torch.rand(n, dtype=torch.float64, device=device, generator=gen)
    v32 = v.to(torch.float32)
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    out = torch.empty(n, dtype=torch.float32, device=device)
    out64 = torch.empty(n, dtype=torch.float64, device=device)
    part = torch.empty(sk.columns.units * sk.block, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def old_launch(lay):  # the old K~ v, with the valid counts where it takes them
        nblocks = (lay.nblocks.data_ptr(),) if arity == 15 else ()
        code = old.block_ell_matvec_launch(
            lay.vals32.data_ptr(), lay.col_idx.data_ptr(), v32.data_ptr(),
            None if lay.row_ptr is None else lay.row_ptr.data_ptr(), *nblocks, lay.n // lay.block,
            lay.vals.shape[0], lay.max_blocks, lay.block, lay.m // lay.block, lay.n // lay.block,
            *([0] if arity >= 14 else []), out.data_ptr(), flag.data_ptr(), stream)
        check(code == 0, f"old block_ell_matvec launch failed ({code})")

    def old_rmatvec_launch():
        cols = sk.columns
        code = old.block_ell_rmatvec_launch(
            sk.vals32.data_ptr(), cols.tile.data_ptr(), cols.urow.data_ptr(), cols.col_ptr.data_ptr(),
            cols.col_unit_ptr.data_ptr(), v32.data_ptr(), cols.units, sk.vals.shape[0] * sk.max_blocks,
            n // sk.block, sk.block, n // sk.block, 0, part.data_ptr(), out.data_ptr(), flag.data_ptr(), stream)
        check(code == 0, f"old block_ell_rmatvec launch failed ({code})")

    def new_matvec(w, o, nblocks):
        return lambda: _launch_block_ell_matvec(sk.vals32, sk.col_idx, w, None, o, flag, col_blocks=n // sk.block,
                                                row_blocks_per_sketch=n // sk.block, nblocks=nblocks)

    def new_rmatvec(w, o):
        return lambda: _launch_block_ell_rmatvec(sk.vals32, sk.columns, w, o, flag)

    products = (
        ("K~ v", lambda: old_launch(sk), new_matvec(v32, out, sk.nblocks), new_matvec(v, out64, sk.nblocks),
         {"new over every slot": new_matvec(v32, out, None)},
         block_ell_matvec_ref(sk.vals32, sk.col_idx, v32.reshape(-1, sk.block)).reshape(-1)),
        ("K~^T u", old_rmatvec_launch if old_rmatvec else lambda: old_launch(skt), new_rmatvec(v32, out),
         new_rmatvec(v, out64), {}, block_ell_rmatvec_ref(sk.vals32, sk.columns, v32.reshape(-1, sk.block)).reshape(-1)),
    )
    for name, run_old, run_new, run_new64, others, want in products:
        results = {}
        for label, fn, o in (("old", run_old, out), ("new", run_new, out), ("new float64", run_new64, out64),
                             *((label, fn, out) for label, fn in others.items())):
            fn()
            torch.cuda.synchronize()
            torch.testing.assert_close(o.float(), want, **BLOCK_ELL_TOL)
            results[label] = o.float().clone()
            log(f"compare block-ELL {name}: {label} max_abs_err {_max_abs_err(o.float(), want)!r}")
        log(f"compare block-ELL {name}: new and old bitwise equal: {bool(torch.equal(results['new'], results['old']))}"
            + "".join(f"; {label} and new: {bool(torch.equal(results[label], results['new']))}" for label in others))
        turns = (("old", run_old), ("new", run_new), ("new", run_new), ("old", run_old))
        times, clocks = in_turns(turns, reps=50)
        dev = device_in_turns(turns + tuple(others.items()) + (("new float64", run_new64),), reps=50)
        log(f"compare block-ELL {name} n={n}: bare launch ms in turns (float32 v) {json.dumps(times)}; "
            f"device ms (profiler) in turns, then the others {json.dumps(dev)}; the new launch on float64 v "
            f"{time_ms(run_new64, reps=50)!r} ms; during the turns (nvidia-smi medians) {json.dumps(clocks)}")
    check(int(flag) == 0, "a compared block-ELL launch flagged an index")


def device_in_turns(runs, reps: int) -> list:
    """Each ``(label, fn)``'s profiler device time (`device_ms`), in the
    order given: a list of (label, ms)."""
    return [(label, device_ms(fn, reps=reps)) for label, fn in runs]


def compare_lru_scan(old_source: Path, device) -> None:
    """``--compare-with OLD_LRU_SCAN_CU``: another ``lru_scan.cu`` (an
    earlier one, or a variant of the current one) built apart. Its forward
    (B5; the oldest walks each channel in one thread and takes no chunk or
    scratch) and backward (B6; before the chunked one, one thread a channel
    with no chunk or scratch) and the current ones are held against their
    plain versions, then timed in turns (old, new, new, old) as bare
    launches at the prefill shape (1, 32768, 2560) and the training shape
    (1, 2048, 2560), by CUDA events and by the profiler's device time."""
    import ctypes

    import torch

    from repro_torch.kernels.library import load
    from repro_torch.kernels.lru_scan import _launch_lru_scan_bwd, _launch_lru_scan_fwd
    from repro_torch.kernels.ref import lru_scan_bwd_ref, lru_scan_ref

    old, _ = build_apart(old_source, "lru_")
    text = old_source.read_text()
    chunked = c_arity(text, "lru_scan_fwd_launch") == 9
    chunked_bwd = c_arity(text, "lru_scan_bwd_launch") == 11
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    old.lru_scan_fwd_launch.argtypes = [P, P, P, I64, I64, I64] + ([I64, P] if chunked else []) + [P]
    old.lru_scan_fwd_launch.restype = ctypes.c_int
    old.lru_scan_bwd_launch.argtypes = [P, P, P, P, P, I64, I64, I64] + ([I64, P] if chunked_bwd else []) + [P]
    old.lru_scan_bwd_launch.restype = ctypes.c_int
    rules = [old.lru_scan_chunk] if chunked else []
    if chunked_bwd:  # a variant of the current source: a rule of its own
        rules.append(old.lru_scan_bwd_chunk)
    for rule in rules:
        rule.argtypes = [I64, I64, I64]
        rule.restype = I64
    for shape in ((1, PREFILL_LEN, 2560), (1, TRAIN_SEQ, 2560)):
        gen = torch.Generator(device=device).manual_seed(sum(shape))
        a = 0.7 + 0.299 * torch.rand(shape, device=device, generator=gen)
        b = 0.1 * torch.randn(shape, device=device, generator=gen)
        g = torch.randn(shape, device=device, generator=gen)
        h = torch.empty_like(a)
        da, db = torch.empty_like(a), torch.empty_like(a)
        scratch = []  # the old launches' scratch, kept alive while they run

        def extra(rule):
            if rule is None:
                return ()
            chunk = rule(*shape)
            scratch.append(torch.empty(3 * shape[0] * -(-shape[1] // chunk) * shape[2], device=device))
            return chunk, scratch[-1].data_ptr()

        fwd_extra = extra(old.lru_scan_chunk if chunked else None)
        bwd_extra = extra(old.lru_scan_bwd_chunk if chunked_bwd else None)
        stream = torch.cuda.current_stream(device).cuda_stream

        def run_old():
            code = old.lru_scan_fwd_launch(a.data_ptr(), b.data_ptr(), h.data_ptr(), *shape, *fwd_extra, stream)
            check(code == 0, f"old lru_scan_fwd launch failed ({code})")

        def run_new():
            _launch_lru_scan_fwd(a, b, h)

        def run_old_bwd():
            code = old.lru_scan_bwd_launch(a.data_ptr(), h_ref.data_ptr(), g.data_ptr(), da.data_ptr(),
                                           db.data_ptr(), *shape, *bwd_extra, stream)
            check(code == 0, f"old lru_scan_bwd launch failed ({code})")

        def run_new_bwd():
            _launch_lru_scan_bwd(a, h_ref, g, da, db)

        reps = 20 if shape[1] == PREFILL_LEN else 50
        h_ref = lru_scan_ref(a, b)
        bits = {}
        for label, fn in (("old", run_old), ("new", run_new)):
            fn()
            torch.cuda.synchronize()
            torch.testing.assert_close(h, h_ref, **LRU_TOL)
            bits[label] = h.clone()
            log(f"compare lru_scan_fwd {shape}: {label} max_abs_err {_max_abs_err(h, h_ref)!r}")
        log(f"compare lru_scan_fwd {shape}: old and new bitwise equal: {bool(torch.equal(bits['old'], bits['new']))}")
        del bits
        da_r, db_r = lru_scan_bwd_ref(a, h_ref, g)
        for label, fn in (("old", run_old_bwd), ("new", run_new_bwd)):
            fn()
            torch.cuda.synchronize()
            torch.testing.assert_close(da, da_r, **LRU_GRAD_TOL)
            torch.testing.assert_close(db, db_r, **LRU_GRAD_TOL)
            log(f"compare lru_scan_bwd {shape}: {label} max_abs_err da {_max_abs_err(da, da_r)!r}, "
                f"db {_max_abs_err(db, db_r)!r}")
        del da_r, db_r
        for name, run_o, run_n, streams, rule in (("lru_scan_fwd", run_old, run_new, 3, load().lru_scan_chunk),
                                                   ("lru_scan_bwd", run_old_bwd, run_new_bwd, 5,
                                                    load().lru_scan_bwd_chunk)):
            turns = (("old", run_o), ("new", run_n), ("new", run_n), ("old", run_o))
            times, clocks = in_turns(turns, reps)
            dev = device_in_turns(turns, reps)
            log(f"compare {name} {shape} (the new launch's chunks of {rule(*shape)}): bare launch ms in turns "
                f"{json.dumps(times)}; device ms (profiler) in turns {json.dumps(dev)}; bound "
                f"{streams * a.numel() * 4 / HBM_BYTES_PER_S * 1e3!r} ms (bytes); during the turns "
                f"(nvidia-smi medians) {json.dumps(clocks)}")
        del a, b, g, h, h_ref, da, db, scratch


def sass_memory_ops(lib_path: Path, markers: tuple[str, ...]) -> dict[str, int]:
    """The global and local load and store instructions (opcode with its
    width and cache modifiers) in the SASS of the kernel whose mangled name
    holds the first of ``markers`` that the library has, counted statically
    over the whole kernel (its paths for a ragged or misaligned end and for
    cos's large arguments included), from ``cuobjdump -sass``."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    marker = next((mk for mk in markers if mk in sass), markers[0])
    counts, inside, seen = {"kernel": marker}, False, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = marker in line and not seen
            seen = seen or inside
        elif inside and (found := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?((?:LDG|STG|LDL|STL)\S*)", line)):
            counts[found.group(1)] = counts.get(found.group(1), 0) + 1
    check(seen, f"no SASS for a kernel named like {marker} in {lib_path}")
    return counts


def compare_gather(old_source: Path, device) -> None:
    """``--compare-with OLD_GATHER_KERNEL_CU``: another ``gather_kernel.cu``
    (the earlier one-lane source, whose launch takes float32 points and no
    pack scratch, or a variant of the current one) built apart. At the
    main path's shapes (k = 1.01e7 pairs, n = 2^17, d = 5, run (a)'s
    float64 points, as `check_gathered_kernel`), and on WFR points with
    blocked pairs: both kernels' (K_e, C_e) against the plain version and
    each other (bitwise or not); then in turns (old, new, new, old) the
    bare launches (the earlier one's on points cast beforehand; the
    current one packs inside) and the wrappers as the sketch calls them
    (the earlier one's: the cast, the zeroed flag, the launch, the flag
    read) by CUDA events, each kernel's device time by the profiler, and
    the SM clock; the current launch with the columns sorted and equal to
    the rows; the ptxas report and the load and store instructions of each
    d = 5 kernel in the SASS."""
    import ctypes

    import torch

    from repro_torch.core.spar_sink import default_cap, s0
    from repro_torch.kernels import library, ops
    from repro_torch.kernels.gather_kernel import _launch_gathered_kernel, _packed
    from repro_torch.kernels.ref import gathered_kernel_ref

    old, old_lib_path = build_apart(old_source, "gathered_")
    packed_api = c_arity(old_source.read_text(), "gathered_kernel_launch") == len(library.SIGNATURES["gathered_kernel"])
    P, I64, INT, F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    old.gathered_kernel_launch.argtypes = list(library.SIGNATURES["gathered_kernel"]) if packed_api else [
        P, P, P, P, I64, I64, I64, INT, F32, INT, F32, P, P, P, P]
    old.gathered_kernel_launch.restype = ctypes.c_int
    n, d, eps = 1 << 17, 5, 0.1
    k = default_cap(4 * s0(n))
    x, rows, cols = _gathered_inputs(n, k, d, device, seed=0)
    xw = 0.2 * x
    xw[n // 2:, 0] += 1.8
    stream = torch.cuda.current_stream(device).cuda_stream
    k_old, c_old, k_new, c_new = (torch.empty(k, dtype=torch.float32, device=device) for _ in range(4))
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    packed_old, packed_new = _packed(x, x, torch.float32), _packed(x, x, torch.float32)

    def old_launch(pts, pts32, k_out, c_out, wfr, eta, bad):
        if packed_api:
            code = old.gathered_kernel_launch(pts.data_ptr(), pts.data_ptr(), 1, rows.data_ptr(), cols.data_ptr(), n,
                                              n, k, d, eps, wfr, eta, packed_old.data_ptr(), k_out.data_ptr(),
                                              c_out.data_ptr(), bad, stream)
        else:
            code = old.gathered_kernel_launch(pts32.data_ptr(), pts32.data_ptr(), rows.data_ptr(), cols.data_ptr(),
                                              n, n, k, d, eps, wfr, eta, k_out.data_ptr(), c_out.data_ptr(), bad,
                                              stream)
        check(code == 0, f"old gathered_kernel launch failed ({code})")

    for cost, pts, eta in (("sqeuclidean", x, 1.0), ("wfr", xw, 0.2)):
        pts32 = pts.to(torch.float32).contiguous()
        old_launch(pts, pts32, k_old, c_old, int(cost == "wfr"), eta, flag.data_ptr())
        _launch_gathered_kernel(pts, pts, rows, cols, k_new, c_new, None, eps=eps, cost=cost, eta=eta,
                                packed=packed_new)
        k_r, c_r = gathered_kernel_ref(pts, pts, rows, cols, eps=eps, cost=cost, eta=eta)
        torch.cuda.synchronize()
        for label, k_e, c_e in (("old", k_old, c_old), ("new", k_new, c_new)):
            ok = torch.isfinite(c_r)
            check(bool(torch.equal(torch.isinf(c_e), ~ok)), f"{label} {cost}: the blocked set differs")
            if cost == "sqeuclidean":
                torch.testing.assert_close(k_e, k_r, **K_TOL)
                torch.testing.assert_close(c_e, c_r, **C_TOL)
            # WFR (the clusters of check_gathered_kernel at all k pairs):
            # pairs where float32's expansion cancels, counted, not checked
            outside = ~torch.isclose(c_e[ok], c_r[ok], **C_TOL) | ~torch.isclose(k_e[ok], k_r[ok], **K_TOL)
            log(f"compare gathered_kernel {cost}: {label} max_abs_err "
                f"{max(_max_abs_err(k_e, k_r), _max_abs_err(c_e, c_r))!r}, pairs outside K_TOL/C_TOL "
                f"{int(outside.sum())} of {int(ok.sum())}")
        same = bool(torch.equal(k_old, k_new)) and bool(torch.equal(c_old, c_new))
        detail = "" if same else (
            f" ({int((k_old != k_new).sum())} K and {int((c_old != c_new).sum())} C values differ, by at most "
            f"{float((k_old - k_new).abs().nan_to_num().max())!r} and {float((c_old - c_new).abs().nan_to_num().max())!r})")
        log(f"compare gathered_kernel {cost}: old and new bitwise equal: {same}{detail}")
        del k_r, c_r, pts32
    check(int(flag) == 0, "a compared gathered launch flagged an index")
    x32 = x.to(torch.float32).contiguous()

    def run_old():
        old_launch(x, x32, k_old, c_old, 0, 1.0, None if packed_api else flag.data_ptr())

    def run_new():
        _launch_gathered_kernel(x, x, rows, cols, k_new, c_new, None, eps=eps, cost="sqeuclidean", eta=1.0,
                                packed=packed_new)

    def wrap_old():  # the earlier wrapper as the sketch called it
        pts32 = x.to(torch.float32).contiguous()
        bad = torch.zeros(1, dtype=torch.int32, device=device)
        k_o, c_o = torch.empty(k, dtype=torch.float32, device=device), torch.empty(k, dtype=torch.float32,
                                                                                   device=device)
        old_launch(x, pts32, k_o, c_o, 0, 1.0, bad.data_ptr())
        check(not bool(bad), "old wrapper flagged an index")

    def wrap_new():
        ops.gathered_sketch_kernel(x, x, rows, cols, eps=eps, cost="sqeuclidean", eta=1.0)

    turns = (("old", run_old), ("new", run_new), ("new", run_new), ("old", run_old))
    times, clocks = in_turns(turns, 50)
    wraps = (("old", wrap_old), ("new", wrap_new), ("new", wrap_new), ("old", wrap_old))
    wrap_times, _ = in_turns(wraps if not packed_api else wraps[1:3], 50)
    dev = [(label, device_ms_by_kernel(fn, reps=50)) for label, fn in turns]
    nbytes = x.numel() * 8 + 2 * k * 8 + 2 * k * 4
    log(f"compare gathered_kernel k={k} n={n} d={d}: bare launch ms in turns {json.dumps(times)}; the wrappers as "
        f"the sketch calls them, ms in turns {json.dumps(wrap_times)}; device ms by kernel (profiler) in turns "
        f"{json.dumps(dev)}; bound {nbytes / HBM_BYTES_PER_S * 1e3!r} ms (bytes); during the bare turns "
        f"(nvidia-smi medians) {json.dumps(clocks)}")
    # where the time goes: the same launch with the columns in order (y read
    # as x is, row after row) and with the columns equal to the rows
    sorted_cols = torch.sort(cols).values
    diag = {}
    for label, cc in (("columns sorted", sorted_cols), ("columns = rows", rows)):
        diag[label] = device_ms_by_kernel(lambda cc=cc: _launch_gathered_kernel(
            x, x, rows, cc, k_new, c_new, None, eps=eps, cost="sqeuclidean", eta=1.0, packed=packed_new), reps=50)
    log(f"compare gathered_kernel: the current launch's device ms (profiler) with other columns {json.dumps(diag)}")
    del sorted_cols
    log_ptxas("gathered_")
    markers = ("gathered_kernel_f32_halvesILi5E", "gathered_kernel_f32ILi5E", "gathered_kernel_f32EPKf")
    log(f"compare SASS gathered_kernel d=5 global and local loads and stores: old "
        f"{json.dumps(sass_memory_ops(old_lib_path, markers))}; new "
        f"{json.dumps(sass_memory_ops(library._build(), markers))}; new float64 cost "
        f"{json.dumps(sass_memory_ops(library._build(), ('gathered_cost_f64ILi5E',)))}")


# --------------------------------------------------------------------------
# Phase 3: the main path at full width
# --------------------------------------------------------------------------


#: runs (a), (b) and (c) as the earlier one-lane gathered kernel and the plain
#: float64 gather gave them on the H100 80GB HBM3 (PERF.md): iterations and
#: value, which this run's are compared with (and reported)
EARLIER_RUNS = {"a": (130, -1.2851739752317646), "b": (130, -1.2851739747877857), "c": (64, -5.46044113146657)}


def run_main_path(n: int, device, max_iter: int = 200) -> tuple[dict[str, int], dict, tuple]:
    """Runs (a)-(c) and the repeat of (a), each sketch first built alone
    (wall, device time, peak memory); returns the kernel launches made by
    their four solves, each run's ``(value, n_iter)`` and run (a)'s
    scalings."""
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

        def sketch():
            return build(problem, torch.Generator(device=device).manual_seed(0), s)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sk, _ = sketch()
        torch.cuda.synchronize()
        sketch_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        cap = sk.cap
        del sk
        sketch_dev_ms = device_ms(sketch, reps=3)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sol, launched = loop_launched(lambda: rt.solve(problem, method="spar_sink_mf", seed=0, s=s, tol=1e-6,
                                                       max_iter=max_iter, stabilize=stabilize))
        value = float(sol.value)  # syncs
        solve_s = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        for kernel, count in counts.items():
            total[kernel] += count
        launches, cost_launches = counts["gathered_kernel"], counts["gathered_cost"]
        row = dict(run=name, n=n, s=s, cap=cap, sketch_s=sketch_s,
                   sketch_device_ms=sketch_dev_ms, sketch_peak_bytes=peak, solve_s=solve_s,
                   n_iter=int(sol.n_iter), status=sol.status_label, nnz=int(sol.nnz),
                   overflowed=bool(sol.overflowed), value=value, kernel_launches=launches,
                   cost_kernel_launches=cost_launches)
        log("main path " + json.dumps(row))
        check(math.isfinite(value), f"({name}) value is not finite")
        check(row["nnz"] > 0, f"({name}) empty sketch")
        check(not row["overflowed"], f"({name}) sketch overflowed its capacity")
        want = (0, 1) if stabilize else (1, 0)
        check((launches, cost_launches) == want,
              f"({name}) the solve launched gathered_kernel {launches} and gathered_cost {cost_launches} times, "
              f"not {want[0]} and {want[1]}")
        lse = 2 * launched if stabilize else 0
        check(counts["segment_lse"] == lse and sum(counts.values()) == 1 + lse,
              f"({name}) the solve launched {counts}, not one sketch kernel and {lse} segment_lse")
        results[name] = (value, int(sol.n_iter))
        if name == "a":
            scalings_a = sol.result.u, sol.result.v
        it0, v0 = EARLIER_RUNS[name.split("-")[0]]
        log(f"main path ({name}) against the earlier kernel's run: iterations {int(sol.n_iter)} ({it0}), value "
            f"{value!r} ({v0!r}), bitwise {value == v0}, relative difference {abs(value - v0) / abs(v0)!r}")
    check(results["a"] == results["a-repeat"],
          f"repeated run (a) differs: {results['a']} vs {results['a-repeat']}")
    log("main path: the repeated run (a) is bitwise identical")
    compare_log_sketch(ot, s, device)
    return total, results, scalings_a


def compare_log_sketch(problem, s: float, device, rounds: int = 2) -> None:
    """Run (b)'s log-domain sketch with the plain float64 gather (the
    earlier `build_mf_log_sketch`: torch's `gathered_cost`) and with the cost-only
    kernel, in turns (plain, kernel, kernel, plain) ``rounds`` times: each
    build's wall (synced), peak device memory above what was allocated
    before (reset just before) and device time (profiler); the two
    sketches' draws bitwise equal, their log-values and costs at the float64
    kernel's tolerance."""
    import torch

    import repro_torch as rt
    from repro_torch.core import sparsify
    from repro_torch.core.api import solvers
    from repro_torch.core.geometry import gathered_cost
    from repro_torch.core.spar_sink import default_cap

    geom = problem.geom

    def plain():
        ra, rb, thin = solvers._proposal(problem)
        return sparsify.sparsify_coo_mf_log(
            torch.Generator(device=device).manual_seed(0), ra, rb, s, default_cap(s),
            lambda r, c: gathered_cost(geom.x, geom.y, r, c, cost=geom.cost_name, eta=geom.eta),
            float(problem.eps), thin_scale=thin)

    def kernel():
        return rt.build_mf_log_sketch(problem, torch.Generator(device=device).manual_seed(0), s)

    (sk_p, c_p), (sk_k, c_k) = plain(), kernel()
    torch.cuda.synchronize()
    for field in ("rows", "cols", "nnz", "csort", "n_proposed", "n_accepted"):
        check(bool(torch.equal(getattr(sk_p, field), getattr(sk_k, field))), f"log sketch: {field} differs")
    live = torch.isfinite(sk_p.logvals)
    check(bool(torch.equal(live, torch.isfinite(sk_k.logvals))), "log sketch: the live entries differ")
    lv_err = float((sk_k.logvals[live] - sk_p.logvals[live]).abs().max())
    c_err = float(((c_k - c_p).abs()).max())
    log(f"log sketch n={geom.x.shape[0]}: plain gather and cost kernel give the same draw; logvals max abs "
        f"difference {lv_err!r} (max |logvals| {float(sk_p.logvals[live].abs().max())!r}), costs max abs "
        f"difference {c_err!r}, bitwise equal: {bool(torch.equal(sk_p.logvals, sk_k.logvals))}")
    del sk_p, c_p, sk_k, c_k
    rows = []
    for label, fn in (("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)) * rounds:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        del out
        rows.append((label, wall * 1e3, peak))
    dev = [(label, device_ms(fn, reps=3)) for label, fn in (("plain", plain), ("kernel", kernel))]
    log(f"log sketch n={geom.x.shape[0]} in turns (label, wall ms, peak bytes above the start): {json.dumps(rows)}; "
        f"device ms (profiler) {json.dumps(dev)}")


def loop_launched(fn):
    """``fn()`` with the program's spans recorded: its result and the
    iterations that its ``sinkhorn.loop`` spans launched."""
    from repro_torch.obs import spans

    spans.clear()
    with spans.recording():
        out = fn()
    launched = sum(int(sp.counts["launched"]) for sp in spans.recorded() if sp.name == "sinkhorn.loop")
    spans.clear()
    return out, launched


def lse_mismatch(out, ref) -> tuple[bool, float]:
    """Whether ``out`` holds ``-inf``, ``+inf`` and NaN where ``ref`` does,
    and the largest ``|out - ref| / max(|ref|, 1)`` over the finite rest (an
    output near 0 is ``mx + log(sum)`` cancelling, so its error is that of
    terms of size 1)."""
    import torch

    same = all(torch.equal(fn(out), fn(ref)) for fn in (torch.isnan, torch.isneginf, torch.isposinf))
    fin = torch.isfinite(ref)
    worst = float(((out[fin] - ref[fin]).abs() / ref[fin].abs().clamp_min(1.0)).max()) if bool(fin.any()) else 0.0
    return same, worst


def check_segment_lse_kernel(n: int, device) -> dict:
    """The gathered segment logsumexp (``segment_lse``, `ops.
    bind_coo_gather_logsumexp`) on run (b)'s n = 2^17 C1 log sketch: a
    ``spar_sink_mf(stabilize=True)`` solve with two launches an iteration its
    loop launched and the plain loop's iterations and status on the same
    sketch; both directions as `sparse_log_potentials` calls them against
    the plain version at `SEGMENT_LSE_RTOL`, on zero potentials, the
    solve's, the solve's with every fifth atom dead, and the solve's with
    a NaN and a +inf potential, bitwise on a repeat; the times (wrapper, bound launch, device,
    plain, and ``torch.segment_reduce``'s max and sum as the library
    yardstick) beside the byte bound. Returns the ``kernels`` entry."""
    import torch

    import repro_torch as rt
    from repro_torch.batch import batched_sparse_log_loop, sparse_log_potentials
    from repro_torch.core.sinkhorn import _masked_log
    from repro_torch.data.pointclouds import make_measures
    from repro_torch.kernels import ops

    d, eps, max_iter = 5, 0.1, 200
    s = 4 * rt.s0(n)
    a, b, x = make_measures("C1", n, d, seed=0)
    problem = rt.OTProblem(rt.PointCloudGeometry(x, device=device), a, b, eps)
    sk, _ = rt.build_mf_log_sketch(problem, torch.Generator(device=device).manual_seed(0), s)
    rows, cols, logvals, csort = sk.rows[None], sk.cols[None], sk.logvals[None], sk.csort[None]
    loga, logb = _masked_log(problem.a)[None], _masked_log(problem.b)[None]
    epsv = torch.tensor([eps], dtype=loga.dtype, device=device)
    fe = torch.tensor([problem.fe], dtype=loga.dtype, device=device)

    # the solve, its launches, and the plain loop on the same sketch
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sol, launched = loop_launched(lambda: rt.solve(problem, method="spar_sink_mf", seed=0, s=s, tol=1e-6,
                                                   max_iter=max_iter, stabilize=True))
    counts = {name: count for name, count in ops.LAUNCHES.items() if count}
    check(counts == {"gathered_cost": 1, "segment_lse": 2 * launched},
          f"segment_lse: the stabilized solve launched {counts} over {launched} launched iterations")
    check(int(sol.nnz) == int(sk.nnz), "segment_lse: the solve's sketch is not the one built here")
    row_off = ops.batched_offsets(rows, n, indices_are_sorted=True)[1]
    col_off = ops.batched_offsets(cols.gather(1, csort), n, indices_are_sorted=True)[1]
    logvals_c, rows_c = logvals.gather(1, csort), rows.gather(1, csort)
    plain = batched_sparse_log_loop(
        lambda g: ops.coo_gather_logsumexp_ref(row_off, logvals, cols, g, epsv),
        lambda f: ops.coo_gather_logsumexp_ref(col_off, logvals_c, rows_c, f, epsv),
        loga, logb, epsv, fe, tol=1e-6, max_iter=max_iter)
    kernel = sparse_log_potentials(rows, cols, logvals, csort, loga, logb, epsv, fe, n=n, m=n, tol=1e-6,
                                   max_iter=max_iter)
    check(int(sol.n_iter) == int(kernel[2][0]), "segment_lse: the solve is not sparse_log_potentials on its sketch")
    check(int(kernel[2][0]) == int(plain[2][0]) and int(kernel[4][0]) == int(plain[4][0]),
          f"segment_lse: the kernel's loop ran {int(kernel[2][0])} iterations to status {int(kernel[4][0])}, the "
          f"plain loop's {int(plain[2][0])} to {int(plain[4][0])}")
    same_dead = all(torch.equal(torch.isneginf(kernel[k]), torch.isneginf(plain[k])) for k in (0, 1))
    check(same_dead, "segment_lse: the kernel's loop and the plain loop pin different atoms to -inf")
    pot_err = max(float((kernel[k] - plain[k])[torch.isfinite(plain[k])].abs().max()) for k in (0, 1))
    log(f"segment_lse: spar_sink_mf(stabilize=True) n={n}: {int(sol.n_iter)} iterations ({sol.status_label}), "
        f"{launched} launched, launches {counts}; the plain loop on its sketch {int(plain[2][0])} iterations, "
        f"status equal, the same dead atoms, finite potentials within {pot_err!r}")

    # both directions against the plain version, repeated
    f_sol, g_sol = kernel[0], kernel[1]
    dead = torch.zeros_like(f_sol, dtype=torch.bool)
    dead[:, ::5] = True
    def non_finite(y):  # NaN at the last atom, which the padding's entries gather, and +inf at atom 5
        y = y.clone()
        y[:, -1], y[:, 5] = math.nan, math.inf
        return y

    cases = {"zero": (torch.zeros_like(f_sol), torch.zeros_like(g_sol)), "solved": (f_sol, g_sol),
             "dead_atoms": (f_sol.masked_fill(dead, -math.inf), g_sol.masked_fill(dead, -math.inf)),
             "non_finite": (non_finite(f_sol), non_finite(g_sol))}
    directions = {"row": (row_off, logvals, cols, 1), "col": (col_off, logvals_c, rows_c, 0)}
    worst = 0.0
    for case, pots in cases.items():
        for direction, (off, vals, idx, side) in directions.items():
            y = pots[side]
            out = ops.bind_coo_gather_logsumexp(off, vals, idx, epsv)(y)
            same, err = lse_mismatch(out, ops.coo_gather_logsumexp_ref(off, vals, idx, y, epsv))
            check(same and err <= SEGMENT_LSE_RTOL,
                  f"segment_lse {case} {direction}: against the plain version, non-finite places equal {same}, "
                  f"error {err!r} (tolerance {SEGMENT_LSE_RTOL})")
            worst = max(worst, err)
            again = ops.bind_coo_gather_logsumexp(off, vals, idx, epsv)(y)
            nan = torch.isnan(out)
            check(torch.equal(nan, torch.isnan(again)) and torch.equal(out[~nan], again[~nan]),
                  f"segment_lse {case} {direction}: two launches differ")
    log(f"segment_lse n={n} cap={sk.cap}: both directions on zero, solved, dead-atom and non-finite potentials within "
        f"{worst!r} of the plain version (tolerance {SEGMENT_LSE_RTOL}, relative to max(|out|, 1)), non-finite "
        f"places equal; two launches bitwise equal")

    # times as the loop calls it (the solved potentials), one iteration's pair
    z_r = (logvals + (g_sol / epsv[:, None]).gather(1, cols)).reshape(-1)
    z_c = (logvals_c + (f_sol / epsv[:, None]).gather(1, rows_c)).reshape(-1)
    rows_out = {}
    for direction, off, vals, idx, y, z in (("row", row_off, logvals, cols, g_sol, z_r),
                                            ("col", col_off, logvals_c, rows_c, f_sol, z_c)):
        bound = ops.bind_coo_gather_logsumexp(off, vals, idx, epsv)

        def library():
            mx = torch.segment_reduce(z, "max", offsets=off, initial=-math.inf)
            return mx, torch.segment_reduce(z, "sum", offsets=off, initial=0.0)

        rows_out[direction] = dict(
            ms=time_ms(lambda: ops.bind_coo_gather_logsumexp(off, vals, idx, epsv)(y)),
            bare_ms=time_ms(lambda: bound(y)),
            device_ms=device_ms(lambda: bound(y)),
            plain_ms=time_ms(lambda: ops.coo_gather_logsumexp_ref(off, vals, idx, y, epsv), reps=10),
            library_ms=time_ms(library, reps=10))
    # least bytes of a half-step: each slot's value and index once, the
    # offsets once, the potentials read once and the output written once
    # (float64, int64 ids); the loop's pair is both directions
    nbytes = 2 * (sk.cap * 16 + (n + 1) * 8 + n * 8 + n * 8)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    pair = {k: rows_out["row"][k] + rows_out["col"][k] for k in rows_out["row"] if rows_out["row"][k] is not None
            and rows_out["col"][k] is not None}
    log(f"segment_lse times an iteration (row + col): {json.dumps(pair)}, by direction {json.dumps(rows_out)}; "
        f"bound {bound_ms!r} ms ({nbytes} bytes)")
    log_ptxas("segment_lse")
    return {
        "name": "segment_lse",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_lse.cu",
        "replaces": None,  # no TPU kernel: the reference leaves these segment reductions to XLA
        "launches": None,  # filled in from the main path's run
        "max_abs_err": worst,
        "ms": pair["ms"],
        "bare_ms": pair["bare_ms"],
        "device_ms": pair.get("device_ms"),
        "plain_ms": pair["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": pair["library_ms"],  # torch.segment_reduce's max and sum, which the port does not call
    }


# --------------------------------------------------------------------------
# Phase 4: accuracy against the dense oracles
# --------------------------------------------------------------------------


def blockwise_ot_value(x, u, v, eps: float, rows: int = 256) -> float:
    """Entropic OT objective <T, C> - eps H(T) of T = diag(u) K diag(v) on
    the points x (x is y), in float64, built a block of rows at a time: both
    terms are sums over the entries, so the blocks' values add up."""
    import torch

    from repro_torch.core.geometry import gibbs_kernel, squared_euclidean_cost
    from repro_torch.core.sinkhorn import ot_cost_from_plan, plan_from_scalings

    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for r0 in range(0, x.shape[0], rows):
        c = squared_euclidean_cost(x[r0:r0 + rows], x)
        total += ot_cost_from_plan(plan_from_scalings(u[r0:r0 + rows], gibbs_kernel(c, eps), v), c, eps)
    return float(total)


def check_accuracy(n: int, device, seeds: int = 4) -> float:
    import torch

    import repro_torch as rt
    from repro_torch.core.sinkhorn import STATUS_LABELS
    from repro_torch.data.pointclouds import make_measures
    from repro_torch.kernels import fused_sinkhorn_solve

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
    # phase 5's block-wise objective: on dense's own scalings it must give
    # dense's value up to summation order (rtol 1e-10); on the fused solve's
    # float32-kernel scalings, within the float32-level rtol 1e-4
    xt, at, bt = (torch.as_tensor(t, device=device) for t in (x, a, b))
    v_blocks = blockwise_ot_value(xt, *dense.scalings, eps)
    fused = fused_sinkhorn_solve(xt, xt, at, bt, eps=eps, tol=1e-6, max_iter=1000)
    v_fused = blockwise_ot_value(xt, fused.u, fused.v, eps)
    log(f"accuracy n={n}: block-wise objective on dense's scalings {v_blocks!r}; "
        f"fused_sinkhorn_solve {v_fused!r} ({int(fused.n_iter)} it, "
        f"{STATUS_LABELS[int(fused.status)]}), relative to dense {abs(v_fused - v_dense) / abs(v_dense)!r}")
    check(abs(v_blocks - v_dense) <= 1e-10 * abs(v_dense), "block-wise objective differs from dense's value")
    check(abs(v_fused - v_dense) <= 1e-4 * abs(v_dense), "fused dense value differs from dense's beyond rtol 1e-4")
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
    return v_log


# --------------------------------------------------------------------------
# Phase 9: the paper's estimator and its competitors (runs after phase 4)
# --------------------------------------------------------------------------

#: phase 9's sketch solvers on phase 4's OT problem (spar_sink_mf in its
#: shared-variates test mode, the one of them that reaches a hand kernel:
#: B1's float64 cost-only mode, once a solve) and on run (c)'s UOT problem
SKETCH_SOLVERS = (("spar_sink_coo", {}), ("spar_sink_log", {}), ("spar_sink_dense", {}), ("rand_sink", {}),
                  ("spar_sink_mf", dict(shared_variates=True)))
UOT_SKETCH_SOLVERS = (("spar_sink_coo", {}), ("spar_sink_log", {}), ("rand_sink", {}))
#: the settings of the reference's BENCH_eps.json (its `run(n=256, n_rep=4)`
#: in `benchmarks.run --emit-json`), and its smoke acceptance
EPS_SWEEP = dict(n=256, d=4, eps_grid=(1e-1, 1e-2, 1e-3), s_mult=16, n_rep=4, tol=1e-9, max_iter=3000)
EPS_SWEEP_METHODS = ("spar_sink_coo", "spar_sink_log", "spar_sink_mf")


def solve_synced(problem, method: str, **opts):
    """One ``solve`` with its kernel launches counted (set to 0 just before,
    read just after): ``(Solution, value, wall s, launches)``, the wall on
    the host clock up to a device sync."""
    import torch

    import repro_torch as rt
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sol = rt.solve(problem, method=method, **opts)
    value = float(sol.value)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return sol, value, wall, {name: count for name, count in ops.LAUNCHES.items() if count}


def check_shared_support(problem, s: float, device) -> None:
    """For one generator state, the kept support of ``spar_sink_coo``'s sketch
    equals the nonzeros of ``spar_sink_dense``'s and ``spar_sink_log``'s
    support (they share one draw of uniforms); B1's float64 cost-only
    kernel on that sketch holds against its plain version and the dense
    cost's entries (`cost64_excess`)."""
    import torch

    import repro_torch as rt
    from repro_torch.core import sparsify
    from repro_torch.kernels.ref import gathered_cost_ref

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    m = problem.shape[1]
    sk = rt.build_coo_sketch(problem, gen(), s)
    lsk, _ = rt.build_coo_log_sketch(problem, gen(), s)
    Kt = sparsify.sparsify_dense(gen(), problem.kernel(), rt.sampling_probs(problem), s)
    nnz = int(sk.nnz)
    dense_support = torch.nonzero(Kt.reshape(-1))[:, 0]
    del Kt
    check(not bool(sk.overflowed), "phase 9: spar_sink_coo's sketch overflowed its capacity")
    check(torch.equal(sk.rows[:nnz] * m + sk.cols[:nnz], dense_support),
          "phase 9: spar_sink_coo's kept support is not spar_sink_dense's nonzeros")
    for field in ("rows", "cols", "nnz", "csort"):
        check(torch.equal(getattr(lsk, field), getattr(sk, field)), f"phase 9: spar_sink_log's sketch {field} differs")
    log(f"phase 9: seed 0 keeps one support of {nnz} entries (cap {sk.cap}) in spar_sink_coo, spar_sink_dense "
        f"and spar_sink_log")
    # B1's float64 cost-only kernel at this path's shape, called as
    # spar_sink_mf(shared_variates=True) calls it (on the whole padded
    # sketch), against its plain version and the dense cost's entries
    geom = problem.geom
    c64 = geom.cost_entries(sk.rows, sk.cols)
    c64_r = gathered_cost_ref(geom.x, geom.y, sk.rows, sk.cols, cost=geom.cost_name, eta=geom.eta)
    c_dense = geom.cost[sk.rows, sk.cols]
    excess = {name: cost64_excess(geom.x, geom.y, sk.rows, sk.cols, c64, ref, geom.cost_name, geom.eta)
              for name, ref in (("plain", c64_r), ("dense", c_dense))}
    for name, value in excess.items():
        check(value <= 1.0, f"phase 9: the float64 cost-only kernel misses the {name} costs of the sketch by "
              f"{value!r} x the tolerance")
    log(f"phase 9: the float64 cost-only kernel on the {sk.cap}-slot sketch: max abs err "
        f"{_max_abs_err(c64, c64_r)!r} (plain), {_max_abs_err(c64, c_dense)!r} (dense cost); "
        f"excess over the tolerance {json.dumps(excess)}")


def run_sketch_solvers(label: str, problem, v_ref: float, solvers, s: float, seeds: int = 4) -> dict:
    """Each solver over ``seeds`` seeds after one untimed warm-up solve (seed
    ``seeds``): value, iterations, status, warm wall (synced), relative
    error against ``v_ref``, with its launches checked; returns each
    method's seed-0 `Solution` and mean relative error."""
    out = {}
    for method, opts in solvers:
        solve_synced(problem, method, seed=seeds, s=s, tol=1e-6, max_iter=1000, **opts)
        runs, first = [], None
        for seed in range(seeds):
            (sol, value, wall, launches), launched = loop_launched(lambda: solve_synced(
                problem, method, seed=seed, s=s, tol=1e-6, max_iter=1000, **opts))
            want = {"gathered_cost": 1} if opts.get("shared_variates") else {}
            if sol.domain == "log":
                want["segment_lse"] = 2 * launched
            check(launches == want, f"phase 9 {label} {method}: the solve launched {launches}, not {want}")
            check(math.isfinite(value), f"phase 9 {label} {method} seed {seed}: value {value} is not finite")
            runs.append(dict(seed=seed, value=value, n_iter=int(sol.n_iter), status=sol.status_label,
                             wall_s=wall, rel_err=abs(value - v_ref) / abs(v_ref), nnz=int(sol.nnz),
                             overflowed=bool(sol.overflowed) if sol.overflowed is not None else None,
                             launches=launches))
            first = sol if first is None else first
        mean = sum(r["rel_err"] for r in runs) / seeds
        log(f"phase 9 {label} n={problem.shape[0]} {method} {json.dumps(opts)}: mean relative error {mean!r}, "
            f"runs {json.dumps(runs)}")
        out[method] = (first, mean)
    return out


def device_kernels(fn) -> tuple[int, float]:
    """The device kernels that one ``fn()`` runs and their device
    microseconds, from `torch.profiler`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.count for e in events), sum(e.self_device_time_total for e in events)


def greenkhorn_per_update(problem, updates: int = 64) -> tuple[float, float]:
    """Greenkhorn's device kernels and device microseconds an update, from
    `torch.profiler` over ``updates`` updates less a run of none."""
    from repro_torch.core.baselines import greenkhorn

    K = problem.kernel()

    def kernels(n_updates: int) -> tuple[int, float]:
        return device_kernels(lambda: greenkhorn(K, problem.a, problem.b, n_updates, fe=float(problem.fe)))

    c0, t0 = kernels(0)
    c1, t1 = kernels(updates)
    return (c1 - c0) / updates, (t1 - t0) / updates


def run_competitors(problem, v_ref: float) -> None:
    """Greenkhorn at its default 5(n + m) updates, Nys-Sink at its default
    rank n/20 and Screenkhorn-lite at decimation 3: value, relative error,
    wall (synced), and Greenkhorn's launches and device time an update."""
    n, m = problem.shape
    per_update, dev_us = greenkhorn_per_update(problem)
    runs = [("greenkhorn", {}), ("nys_sink", dict(seed=0)), ("screenkhorn_lite", {})]
    for method, opts in runs:
        if method != "greenkhorn":  # an untimed warm-up (greenkhorn's is its profiled runs)
            solve_synced(problem, method, **dict(opts, **({"seed": 1} if "seed" in opts else {})))
        sol, value, wall, launches = solve_synced(problem, method, **opts)
        check(launches == {}, f"phase 9 {method}: launched {launches}")
        check(math.isfinite(value), f"phase 9 {method}: value {value} is not finite")
        row = dict(method=method, n=n, value=value, rel_err=abs(value - v_ref) / abs(v_ref), n_iter=int(sol.n_iter),
                   status=sol.status_label, wall_s=wall)
        if method == "greenkhorn":
            updates = int(sol.n_iter)
            row.update(updates=updates, launches_per_update=per_update, device_us_per_update=dev_us,
                       host_us_per_update=wall / updates * 1e6, busy=dev_us * updates / 1e6 / wall)
            check(updates == 5 * (n + m), f"greenkhorn ran {updates} updates, not 5(n + m)")
        log("phase 9 competitor " + json.dumps(row))


def separated(n: int, d: int, seed: int = 0):
    """`benchmarks.bench_rmae_vs_eps._separated`'s recipe: uniform x, y a
    permutation of x shifted by 0.5 (costs bounded below), Dirichlet
    marginals; the permutation is drawn by numpy here (the reference draws
    it with `jax.random.permutation(PRNGKey(9), n)`)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = x[np.random.default_rng(9).permutation(n)] + 0.5
    return x, y, rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))


def run_eps_sweep(device) -> None:
    """`benchmarks.bench_rmae_vs_eps` at BENCH_eps.json's settings on the card:
    spar_sink_coo, spar_sink_log and spar_sink_mf(stabilize=True) over
    EPS_SWEEP's eps, OT and UOT (masses 5/3, lam = 0.5), RMAE against the
    ``log`` oracle at tol 1e-10, each beside the reference's CPU row; then
    the reference's smoke acceptance on OT: both log-domain methods finite
    at eps = 1e-3 and within 2x of spar_sink_coo's RMAE at eps = 1e-1."""
    import repro_torch as rt
    from repro_torch.core.sinkhorn import STATUS_LABELS

    cfg = EPS_SWEEP
    n = cfg["n"]
    reference = {r["name"]: r for r in json.loads((Path(__file__).resolve().parent / "BENCH_eps.json").read_text())
                 ["results"]}
    x, y, a, b = separated(n, cfg["d"])
    s = cfg["s_mult"] * rt.s0(n)
    geom, pc = rt.Geometry.from_points(x, y, device=device), rt.PointCloudGeometry(x, y, device=device)
    rmae = {}
    for kind, lam in (("ot", None), ("uot", 0.5)):
        for eps in cfg["eps_grid"]:
            if lam is None:
                problem, pc_problem = rt.OTProblem(geom, a, b, eps), rt.OTProblem(pc, a, b, eps)
            else:
                problem = rt.UOTProblem(geom, 5 * a, 3 * b, eps, lam=lam)
                pc_problem = rt.UOTProblem(pc, 5 * a, 3 * b, eps, lam=lam)
            oracle, truth, t_oracle, _ = solve_synced(problem, "log", tol=1e-10, max_iter=50_000)
            log(f"eps sweep {kind} eps={eps:g}: log oracle {truth!r} ({int(oracle.n_iter)} it, "
                f"{oracle.status_label}, {t_oracle!r} s)")
            for method in EPS_SWEEP_METHODS:
                prob, opts = (pc_problem, dict(stabilize=True)) if method == "spar_sink_mf" else (problem, {})
                vals, codes, walls = [], [], []
                for i in range(cfg["n_rep"]):
                    sol, value, wall, _ = solve_synced(prob, method, seed=i, s=s, tol=cfg["tol"],
                                                       max_iter=cfg["max_iter"], **opts)
                    vals.append(value)
                    codes.append(int(sol.status))
                    walls.append(wall)
                err = sum(abs(v - truth) / abs(truth) for v in vals) / len(vals)
                rmae[(kind, eps, method)] = err
                ref = reference[f"eps/{kind}/{method}/eps{eps:g}"]
                log(f"eps sweep {kind} eps={eps:g} {method}: rmae {err!r}, worst status {STATUS_LABELS[max(codes)]}, "
                    f"walls {walls!r} s; the reference's CPU figure (BENCH_eps.json, its own permutation): "
                    f"rmae {ref['rmae']!r}, worst status {ref['status']}")
    for kind in ("ot", "uot"):
        base = rmae[(kind, 1e-1, "spar_sink_coo")]
        holds = {m: rmae[(kind, 1e-3, m)] for m in ("spar_sink_log", "spar_sink_mf")}
        ok = all(math.isfinite(v) and v <= 2.0 * base for v in holds.values())
        log(f"eps sweep {kind}: RMAE at eps=1e-3 {json.dumps(holds)} against 2 x spar_sink_coo's at 1e-1 "
            f"({2.0 * base!r}): {'holds' if ok else 'fails'}")
        if kind == "ot":  # the reference's smoke asserts it on OT
            check(ok, "eps sweep: the reference's smoke acceptance fails on OT")


def run_estimators_phase(n: int, device, v_log: float) -> None:
    """Phase 9 (see the module docstring)."""
    import torch

    import repro_torch as rt
    from repro_torch.data.pointclouds import make_measures

    t_phase = time.perf_counter()
    eps = 0.1
    s = 16 * rt.s0(n)
    a, b, x = make_measures("C1", n, 5, seed=1)
    ot = rt.OTProblem(rt.PointCloudGeometry(x, device=device), a, b, eps)
    check_shared_support(ot, s, device)
    torch.cuda.empty_cache()
    ot_runs = run_sketch_solvers("OT", ot, v_log, SKETCH_SOLVERS, s)
    coo, mf = ot_runs["spar_sink_coo"][0], ot_runs["spar_sink_mf"][0]
    check(torch.equal(coo.result.u, mf.result.u) and torch.equal(coo.result.v, mf.result.v),
          "phase 9: spar_sink_mf(shared_variates=True) scalings differ from spar_sink_coo's")
    again, value, _, _ = solve_synced(ot, "spar_sink_coo", seed=0, s=s, tol=1e-6, max_iter=1000)
    check(value == float(coo.value) and torch.equal(again.result.u, coo.result.u)
          and torch.equal(again.result.v, coo.result.v), "phase 9: two spar_sink_coo solves of seed 0 differ")
    # the values differ only in the gathered costs: the kernel's against the dense cost's entries
    check(abs(float(mf.value) - float(coo.value)) <= 1e-12 * abs(float(coo.value)),
          f"phase 9: spar_sink_mf(shared_variates=True) value {float(mf.value)!r} is not spar_sink_coo's "
          f"{float(coo.value)!r} to 1e-12")
    log(f"phase 9: spar_sink_mf(shared_variates=True) scalings bitwise spar_sink_coo's, values within 1e-12 "
        f"({float(mf.value)!r}, {float(coo.value)!r}); two spar_sink_coo solves of seed 0 bitwise equal")
    rmae = ot_runs["spar_sink_coo"][1]
    check(rmae < 0.25, f"phase 9: spar_sink_coo mean relative error {rmae} >= 0.25")
    del ot_runs, coo, mf, again
    torch.cuda.empty_cache()
    run_competitors(ot, v_log)
    del ot
    torch.cuda.empty_cache()
    _, uot = block_ell_problems(n, device)
    oracle, v_uot, t_oracle, _ = solve_synced(uot, "log", tol=1e-9, max_iter=20_000)
    log(f"phase 9 UOT n={n}: log oracle {v_uot!r} ({int(oracle.n_iter)} it, {oracle.status_label}, {t_oracle!r} s)")
    del oracle
    run_sketch_solvers("UOT", uot, v_uot, UOT_SKETCH_SOLVERS, s)
    del uot
    torch.cuda.empty_cache()
    t_sweep = time.perf_counter()
    run_eps_sweep(device)
    log(f"phase 9: eps sweep {time.perf_counter() - t_sweep!r} s; phase {time.perf_counter() - t_phase!r} s")
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase 5: the fused dense path at full width
# --------------------------------------------------------------------------


def run_fused_path(n: int, device, max_iter: int = 200):
    """fused_sinkhorn_solve on run (a)'s OT and run (c)'s UOT problem, and
    online_lse for the OT solution's row marginal, with the plain versions
    made to raise. Returns the phase's kernel launches, run (a)'s points
    and the OT solution's scalings."""
    import torch

    from repro_torch.core.sinkhorn import CHECK_EVERY, STATUS_LABELS
    from repro_torch.data.pointclouds import make_measures, make_uot_measures
    from repro_torch.kernels import fused_sinkhorn_solve, online_lse, ops

    eps, lam = 0.1, 0.5
    a, b, x = (torch.as_tensor(t, device=device) for t in make_measures("C1", n, 5, seed=0))
    ua, ub, ux = (torch.as_tensor(t, device=device) for t in make_uot_measures("C1", n, 5, seed=0))
    runs = [("ot", x, a, b, 1.0), ("uot", ux, ua, ub, lam / (lam + eps))]

    def plain_called(*args, **kwargs):
        raise RuntimeError("a plain version was called on the fused path")

    saved = ops.online_matvec_ref, ops.online_lse_ref
    ops.online_matvec_ref = ops.online_lse_ref = plain_called
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        executed = 0
        for name, pts, ma, mb, fe in runs:
            t0 = time.perf_counter()
            res = fused_sinkhorn_solve(pts, pts, ma, mb, eps=eps, fe=fe, tol=1e-6, max_iter=max_iter)
            n_iter = int(res.n_iter)  # syncs
            wall_s = time.perf_counter() - t0
            status = STATUS_LABELS[int(res.status)]
            # the loop reads its active flag every CHECK_EVERY iterations, so
            # it executes up to CHECK_EVERY - 1 frozen iterations past n_iter
            executed += min(max_iter, CHECK_EVERY * math.ceil(n_iter / CHECK_EVERY))
            launches = ops.LAUNCHES["online_matvec"]
            log("fused path " + json.dumps(dict(
                run=name, n=n, fe=fe, n_iter=n_iter, status=status, err=float(res.err), wall_s=wall_s,
                ms_per_iteration=wall_s / max(n_iter, 1) * 1e3, online_matvec_launches=launches)))
            check(status not in ("non_finite", "degenerate"), f"fused {name} ended {status}")
            check(launches == 2 * executed,
                  f"fused {name}: {launches} online_matvec launches, not 2 x {executed} executed iterations")
            if name == "ot":
                u, v = res.u, res.v
                # row marginal T 1 = u * exp(LSE_j(-C_ij/eps + log v_j)), in the log domain
                row = u * torch.exp(online_lse(x, x, eps * torch.log(v), eps=eps).to(u.dtype))
                marg = float(torch.sum(torch.abs(row - a)))
                log(f"fused path ot: row marginal by online_lse, |T 1 - a|_1 = {marg!r}")
                check(math.isfinite(marg) and marg < 1e-2, f"fused ot row marginal error {marg}")
        counts = dict(ops.LAUNCHES)
    finally:
        ops.online_matvec_ref, ops.online_lse_ref = saved
    check(counts["online_lse"] == 1, f"online_lse launched {counts['online_lse']} times, not once")
    return counts, x, u, v


# --------------------------------------------------------------------------
# Phase 6: the block-ELL path at n = 8192
# --------------------------------------------------------------------------


def block_ell_problems(n: int, device, seed: int = 0):
    """Run (a)'s OT problem and run (c)'s UOT problem at n (C1 measures,
    d = 5, float64, eps = 0.1) on a PointCloudGeometry."""
    import repro_torch as rt
    from repro_torch.data.pointclouds import make_measures, make_uot_measures

    a, b, x = make_measures("C1", n, 5, seed=seed)
    ot = rt.OTProblem(rt.PointCloudGeometry(x, device=device), a, b, 0.1)
    ua, ub, ux = make_uot_measures("C1", n, 5, seed=seed)
    uot = rt.UOTProblem(rt.PointCloudGeometry(ux, device=device), ua, ub, 0.1, lam=0.5)
    return ot, uot


def transposed32(sk):
    """The sketch's transposed layout with the float32 tiles that PR 16's
    ``K~^T u`` launch read (the port's kernels read the row layout only, so
    its sketches carry no such copy; the comparisons make it here)."""
    import torch

    t = sk.transposed
    return t._replace(vals32=t.vals.to(torch.float32).contiguous())


def block_ell_bytes(sk, itemsize: int, rmatvec: bool = False) -> int:
    """Least bytes of one product on a layout, for this sketch's data: each
    valid tile read once with its column id (the zero tiles that pad the
    ELL rows to ``max_blocks`` slots are not needed, though ``K~ v``'s
    kernel reads them), ``row_ptr`` where there is one, the input read once
    and the output written once at ``itemsize`` bytes a value; for ``K~^T
    u`` (``rmatvec``) each tile's row-block and the column lists' two
    offset arrays instead of the column ids and ``row_ptr``."""
    tiles, bk, ncb = int(sk.nblocks.sum()), sk.block, sk.m // sk.block
    if rmatvec:
        index = 2 * tiles + 2 * (ncb + 1)
    else:
        index = tiles + (0 if sk.row_ptr is None else sk.row_ptr.numel())
    return 4 * (tiles * bk * bk + index) + itemsize * (sk.m + sk.n)


def block_ell_bound(nbytes: int, tiles: int, bk: int):
    """(bound ms, bound_by): bytes at the HBM rate against 2 float32
    operations per element of the ``tiles`` valid tiles at the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * tiles * bk * bk / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scatter_rmatvec64(sk, u):
    """K~^T u in float64 by the reference's per-tile products and a scatter
    over the row layout's column ids (a check only: on the card
    ``index_add_`` sums with atomics)."""
    import torch

    bk = sk.block
    contrib = torch.einsum("rkij,ri->rkj", sk.vals, u.reshape(sk.n // bk, bk))
    out = torch.zeros((sk.m // bk, bk), dtype=torch.float64, device=u.device)
    out.index_add_(0, sk.col_idx.reshape(-1).long(), contrib.reshape(-1, bk))
    return out.reshape(sk.m)


def bsr_library_ms(sk, v32):
    """Time of cuSPARSE's block-sparse mat-vec on a layout's valid tiles
    (``torch.sparse_bsr_tensor @ v`` in float32; on the transposed layout,
    ``K~^T v``), and its largest error against the kernel's plain version;
    (None, reason) where PyTorch refuses the call."""
    import torch

    from repro_torch.kernels.ref import block_ell_matvec_ref

    bk, ncb, nrb = sk.block, sk.m // sk.block, sk.n // sk.block
    valid = torch.arange(sk.max_blocks, device=v32.device)[None, :] < sk.nblocks[:, None]
    rows = sk.row_blocks_of_ell_rows()[:, None].expand_as(valid)[valid]
    cols = sk.col_idx[valid].long()
    order = torch.argsort(rows * ncb + cols)
    crow = torch.zeros(nrb + 1, dtype=torch.int64, device=v32.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=nrb), 0)
    col = v32[:, None]
    ref = block_ell_matvec_ref(sk.vals32, sk.col_idx, v32.reshape(-1, bk), sk.row_ptr).reshape(-1)
    try:  # the library call only: it is timed here and used nowhere in the port
        bsr = torch.sparse_bsr_tensor(crow, cols[order], sk.vals32[valid][order], size=(sk.n, sk.m))
        out = (bsr @ col)[:, 0]
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"{type(exc).__name__}: {exc}"
    err = _max_abs_err(out, ref)
    dev_ms = device_ms(lambda: bsr @ col)
    return time_ms(lambda: bsr @ col), f"device time {dev_ms!r} ms (profiler), max_abs_err against the plain version {err!r}"


def nblocks_spread(sk) -> str:
    """The valid tiles of a sketch's row layout per row-block: max, mean and
    the histogram over 0 .. max_blocks."""
    import torch

    nb = sk.nblocks.long()
    hist = torch.bincount(nb, minlength=sk.max_blocks + 1).tolist()
    return (f"{int(nb.sum())} valid tiles of {nb.numel() * sk.max_blocks} slots over {nb.numel()} row-blocks: "
            f"max {int(nb.max())}, mean {float(nb.double().mean())!r}, row-blocks holding 0..{sk.max_blocks} "
            f"tiles {hist}")


def valid_slot_walk(sk_ot, sk_uot, v) -> None:
    """``K~ v`` over the valid slots alone (the solver's launch, with the
    sketch's ``nblocks``) on the OT and UOT sketches: the ``nblocks`` spread,
    then bitwise the all-slot launch and within the kernel tolerance of the
    plain version, on float64 and float32 v; with an inf in v block 0, NaN in
    exactly the rows where the all-slot launch and the plain version give
    NaN."""
    import torch

    from repro_torch.core import sparsify
    from repro_torch.kernels.block_ell import _launch_block_ell_matvec
    from repro_torch.kernels.ref import block_ell_matvec_ref

    flag = torch.zeros(1, dtype=torch.int32, device=v.device)

    def launch(sk, w, nblocks):
        out = torch.empty(sk.n, dtype=w.dtype, device=w.device)
        _launch_block_ell_matvec(sk.vals32, sk.col_idx, w, None, out, flag, col_blocks=sk.m // sk.block,
                                 row_blocks_per_sketch=sk.n // sk.block, nblocks=nblocks)
        return out

    for label, sk in (("OT", sk_ot), ("UOT", sk_uot)):
        log(f"block_ell nblocks spread, {label} sketch n={sk.n}: {nblocks_spread(sk)}")
        for w in (v, v.to(torch.float32)):
            valid, every = launch(sk, w, sk.nblocks), launch(sk, w, None)
            solver = sparsify.block_ell_matvec(sk, w, flag)
            plain = block_ell_matvec_ref(sk.vals32, sk.col_idx, w.reshape(-1, sk.block)).reshape(-1)
            torch.cuda.synchronize()
            check(bool(torch.equal(valid, every)) and bool(torch.equal(solver, valid)),
                  f"K~ v over the valid slots, {label} {w.dtype}: not bitwise the all-slot launch")
            torch.testing.assert_close(valid.float(), plain, **BLOCK_ELL_TOL)
            log(f"block_ell_matvec {label} {w.dtype}: the valid-slot walk (the solver's call) bitwise equal to "
                f"the all-slot launch, max_abs_err {_max_abs_err(valid.float(), plain)!r} against the plain version")
        w = v.clone()
        w[3] = math.inf
        valid, every = launch(sk, w, sk.nblocks), launch(sk, w, None)
        plain = block_ell_matvec_ref(sk.vals32, sk.col_idx, w.reshape(-1, sk.block)).reshape(-1)
        torch.cuda.synchronize()
        nan = torch.isnan(valid)
        padded = (sk.nblocks < sk.max_blocks).repeat_interleave(sk.block)
        check(bool(torch.equal(nan, torch.isnan(every))) and bool(torch.equal(nan, torch.isnan(plain)))
              and bool(nan[padded].all()),
              f"K~ v over the valid slots, {label}, an inf in v block 0: NaN rows differ from the all-slot launch's")
        check(bool(torch.equal(valid[~nan], every[~nan])), f"K~ v, {label}, an inf in v block 0: other rows differ")
        log(f"block_ell_matvec {label} with an inf in v block 0: {int(nan.sum())} NaN rows ({int(padded.sum())} "
            f"in row-blocks with padding), the same as the all-slot launch's and the plain version's; the other "
            f"rows bitwise the all-slot launch's")
    check(int(flag) == 0, "a valid-slot launch flagged an index")


def check_block_ell_kernel(n: int, device) -> list[dict]:
    """B4 against its plain versions on the card: ``K~ v`` at the solver's
    own OT sketch (n = 8192, block 128, s = 16 s0) on both layouts, over the
    reference test shapes, on the WFR zero-mass sketch of the reference's
    kernel test, and batched (B = 8 of the solver's sketches); ``K~^T u`` on
    the row layout's tiles (the solver's launch) against its plain version
    and the float64 scatter, in float64 and float32, and at block 64; ``K~ v``
    on float64 v with the bits of a cast, the float32 launch and a cast;
    both products on tiles 4 bytes into their storage (the any-Bk kernels);
    two launches bitwise equal; times of each product as the solver calls
    it (and as the transposed-layout path calls it: casts around the
    checked wrapper, ``K~^T u`` on the transposed layout), the bare launches, the plain
    versions, cuSPARSE's BSR mat-vec on each layout and the batched launch.
    Returns the entries of both products."""
    import numpy as np
    import torch

    import repro_torch as rt
    from repro_torch.core import sparsify
    from repro_torch.core.geometry import gibbs_kernel, wfr_cost
    from repro_torch.kernels.block_ell import UNIT_TILES, _launch_block_ell_matvec, _launch_block_ell_rmatvec
    from repro_torch.kernels.ops import batched_block_ell_matvec, block_ell_matvec, block_ell_sketch_rmatvec
    from repro_torch.kernels.ref import block_ell_matvec_ref, block_ell_rmatvec_ref

    log_ptxas("block_ell")
    ot, uot = block_ell_problems(n, device)
    s = 16 * rt.s0(n)
    sk = rt.build_block_ell_sketch(ot, torch.Generator(device=device).manual_seed(0), s)
    skt = transposed32(sk)
    gen = torch.Generator(device=device).manual_seed(1)
    v = torch.rand(n, dtype=torch.float64, device=device, generator=gen)
    errs = []

    def held(name, out, again, ref, tol=BLOCK_ELL_TOL):
        torch.cuda.synchronize()
        check(bool(torch.equal(out, again)), f"{name}: two launches differ")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        torch.testing.assert_close(out, ref, **tol)
        errs.append(_max_abs_err(out, ref))
        return errs[-1]

    for name, lay in (("row layout", sk), ("transposed layout", skt)):
        out = block_ell_matvec(lay.vals32, lay.col_idx, v, row_ptr=lay.row_ptr)
        again = block_ell_matvec(lay.vals32, lay.col_idx, v, row_ptr=lay.row_ptr)
        ref = block_ell_matvec_ref(lay.vals32, lay.col_idx, v.reshape(-1, lay.block), lay.row_ptr).reshape(-1)
        err = held(f"block_ell_matvec {name}", out, again, ref)
        log(f"block_ell_matvec {name} n={n} ell_rows={lay.vals.shape[0]} max_blocks={lay.max_blocks} "
            f"valid_tiles={int(lay.nblocks.sum())}: max_abs_err={err!r}, two launches bitwise equal")
    valid_slot_walk(sk, rt.build_block_ell_sketch(uot, torch.Generator(device=device).manual_seed(0), s), v)
    # the transposed launch is K~^T v: held against the float64 scatter
    out_t = sparsify.block_ell_rmatvec(sk, v)
    ref64 = scatter_rmatvec64(sk, v)
    torch.testing.assert_close(out_t, ref64, **BLOCK_ELL_TOL)
    err64 = _max_abs_err(out_t, ref64)
    log(f"block_ell_matvec transposed layout against the float64 scatter K~^T v: max_abs_err={err64!r}")

    # K~^T u on the row layout's tiles through the column lists (the solver's
    # launch), in the path's float64 and in float32; K~ v on float64 v has
    # the bits of a cast to float32, the float32 launch and a cast back
    cols = sk.columns
    log(f"column lists: {int(cols.col_ptr[-1])} valid tiles of {sk.vals.shape[0] * sk.max_blocks} slots, "
        f"{cols.units} work units of at most {UNIT_TILES} tiles, the fullest column-block "
        f"{int(torch.diff(cols.col_ptr).max())} tiles")
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    ref_t = block_ell_rmatvec_ref(sk.vals32, cols, v.reshape(-1, sk.block)).reshape(-1)
    errs_t = []
    for dt in (torch.float64, torch.float32):
        vt = v.to(dt)
        out_t = sparsify.block_ell_rmatvec(sk, vt, flag)
        again = sparsify.block_ell_rmatvec(sk, vt, flag)
        torch.cuda.synchronize()
        check(out_t.dtype == dt and bool(torch.equal(out_t, again)), f"block_ell_rmatvec {dt}: dtype or two launches")
        check(bool(torch.isfinite(out_t).all()), f"block_ell_rmatvec {dt}: non-finite output")
        torch.testing.assert_close(out_t.float(), ref_t, **BLOCK_ELL_TOL)
        torch.testing.assert_close(out_t.double(), ref64, **BLOCK_ELL_TOL)
        errs_t += [_max_abs_err(out_t.float(), ref_t), _max_abs_err(out_t.double(), ref64)]
        mv = sparsify.block_ell_matvec(sk, vt, flag)
        check(bool(torch.equal(mv, block_ell_matvec(sk.vals32, sk.col_idx, vt).to(dt))),
              f"K~ v on {dt} v differs from cast, float32 launch, cast")
        log(f"block_ell_rmatvec {dt} n={n}: max_abs_err {errs_t[-2]!r} against its plain version, {errs_t[-1]!r} "
            f"against the float64 scatter; two launches bitwise equal; K~ v on {dt} v: the cast path's bits")
    sk64 = rt.build_block_ell_sketch(ot, torch.Generator(device=device).manual_seed(0), s, block=64)
    out_64 = sparsify.block_ell_rmatvec(sk64, v, flag)
    ref_64 = block_ell_rmatvec_ref(sk64.vals32, sk64.columns, v.reshape(-1, 64)).reshape(-1)
    torch.testing.assert_close(out_64.float(), ref_64, **BLOCK_ELL_TOL)
    check(bool(torch.equal(out_64, sparsify.block_ell_rmatvec(sk64, v, flag))), "block_ell_rmatvec bk=64: two launches")
    errs_t.append(_max_abs_err(out_64.float(), ref_64))
    log(f"block_ell_rmatvec bk=64 (any-Bk kernel): max_abs_err {errs_t[-1]!r}, two launches bitwise equal")
    check(int(flag) == 0, "a K~^T u launch flagged an index")
    del sk64, out_64, ref_64

    # tiles 4 bytes into their storage: not on 16 bytes, so both products
    # take the kernels for any Bk instead of the float4 ones
    buf = torch.empty(sk.vals32.numel() + 1, dtype=torch.float32, device=device)
    off = buf[1:].view_as(sk.vals32)
    off.copy_(sk.vals32)
    ref_mv = block_ell_matvec_ref(sk.vals32, sk.col_idx, v.reshape(-1, sk.block)).reshape(-1)
    err_off = [held("block_ell_matvec on tiles at a 4-byte offset", block_ell_matvec(off, sk.col_idx, v).float(),
                    block_ell_matvec(off, sk.col_idx, v).float(), ref_mv)]
    out_off = block_ell_sketch_rmatvec(off, cols, v, flag)
    again = block_ell_sketch_rmatvec(off, cols, v, flag)
    torch.cuda.synchronize()
    check(bool(torch.equal(out_off, again)), "block_ell_rmatvec on tiles at a 4-byte offset: two launches differ")
    torch.testing.assert_close(out_off.float(), ref_t, **BLOCK_ELL_TOL)
    errs_t.append(_max_abs_err(out_off.float(), ref_t))
    check(int(flag) == 0, "a launch on offset tiles flagged an index")
    log(f"both products on tiles 4 bytes into their storage (any-Bk kernels): max_abs_err K~ v {err_off[0]!r}, "
        f"K~^T u {errs_t[-1]!r}; two launches bitwise equal")
    del buf, off, out_off, again

    # the reference test shapes (tests/test_kernels_cpu.py), Bk 8..32
    err_s = 0.0
    for bk, maxb, nrb in BLOCK_ELL_SHAPES:
        rng = np.random.default_rng(bk * maxb)
        vals = torch.as_tensor(rng.uniform(size=(nrb, maxb, bk, bk)), dtype=torch.float32, device=device)
        ci = torch.as_tensor(rng.integers(0, nrb, (nrb, maxb)), dtype=torch.int32, device=device)
        vs = torch.as_tensor(rng.uniform(size=nrb * bk), dtype=torch.float32, device=device)
        err_s = max(err_s, held(f"block_ell_matvec bk={bk}", block_ell_matvec(vals, ci, vs),
                                block_ell_matvec(vals, ci, vs),
                                block_ell_matvec_ref(vals, ci, vs.reshape(-1, bk)).reshape(-1)))
    log(f"block_ell_matvec over the reference test shapes (bk, maxb, nrb) {BLOCK_ELL_SHAPES}: "
        f"max_abs_err={err_s!r}")

    # WFR zero-mass tiles (tests/test_kernels_cpu.py): two clusters further
    # apart than pi * eta, so every tile across them is blocked (all 0). The
    # reference's draw forces each row-block's tiles, which here include one
    # inside its own cluster, so no row is left with blocked tiles only;
    # the draws without forced tiles (seeds 3, 4, ...) are searched for the
    # first that leaves a row-block whose kept tiles are all blocked, and
    # those rows must come out exactly 0
    nw, bkw = 128, 16
    rng = np.random.default_rng(7)
    xw = np.concatenate([rng.uniform(0.0, 0.2, (nw // 2, 2)), rng.uniform(1.8, 2.0, (nw // 2, 2))])
    kw = gibbs_kernel(wfr_cost(torch.as_tensor(xw, dtype=torch.float32, device=device), eta=0.2), 0.1)
    aw = torch.as_tensor(rng.dirichlet(np.ones(nw)), dtype=torch.float32, device=device)
    tpw = sparsify.ot_tile_probs(aw, aw, bkw)
    vw = torch.as_tensor(rng.uniform(size=nw), dtype=torch.float32, device=device)

    def wfr_sketch(seed_w, ensure):
        return sparsify.sparsify_block_ell(torch.Generator(device=device).manual_seed(seed_w), kw, tpw,
                                           float(nw * 8), bkw, 4, ensure_rows=ensure)

    for seed_w in range(3, 67):
        skd = wfr_sketch(seed_w, False)
        dead = (torch.sum(sparsify.block_ell_to_dense(skd), dim=1) == 0) & (skd.nblocks > 0).repeat_interleave(bkw)
        if bool(dead.any()):
            break
    check(bool(dead.any()), "no WFR draw left a row-block whose kept tiles are all blocked")
    err_w = 0.0
    for name, skw in (("forced tiles, seed 3", wfr_sketch(3, True)), (f"no forced tiles, seed {seed_w}", skd)):
        out_w = block_ell_matvec(skw.vals32, skw.col_idx, vw)
        ref_w = block_ell_matvec_ref(skw.vals32, skw.col_idx, vw.reshape(-1, bkw)).reshape(-1)
        err_w = max(err_w, held(f"block_ell_matvec wfr {name}", out_w,
                                block_ell_matvec(skw.vals32, skw.col_idx, vw), ref_w))
    check(bool((out_w[dead] == 0).all()) and bool((ref_w[dead] == 0).all()),
          "WFR rows whose kept tiles are all blocked are not exactly 0")
    log(f"block_ell_matvec wfr n={nw} bk={bkw}: blocked share {float((kw == 0).double().mean())!r}; "
        f"{int(dead.sum())} rows with blocked tiles only (seed {seed_w}) exactly 0; max_abs_err={err_w!r}")

    # an out-of-range column id raises
    bad_ci = sk.col_idx.clone()
    bad_ci[0, 0] = n // sk.block
    try:
        block_ell_matvec(sk.vals32, bad_ci, v)
    except IndexError:
        pass
    else:
        check(False, "an out-of-range column id did not raise")
    log("block_ell_matvec: an out-of-range column id raises IndexError")

    # batched: B = 8 of the solver's sketches (seeds 0..7), one launch
    bsz = 8
    sks = [sk] + [rt.build_block_ell_sketch(ot, torch.Generator(device=device).manual_seed(i), s)
                  for i in range(1, bsz)]
    check(len({k.max_blocks for k in sks}) == 1, "the batch's sketches differ in width")
    bvals = torch.stack([k.vals32 for k in sks])
    bci = torch.stack([k.col_idx for k in sks])
    bv = torch.rand((bsz, n), dtype=torch.float32, device=device, generator=gen)
    out_b = batched_block_ell_matvec(bvals, bci, bv)
    ref_b = torch.stack([block_ell_matvec_ref(k.vals32, k.col_idx, bv[i].reshape(-1, k.block)).reshape(-1)
                         for i, k in enumerate(sks)])
    err_b = held("batched_block_ell_matvec", out_b, batched_block_ell_matvec(bvals, bci, bv), ref_b)
    log(f"batched_block_ell_matvec B={bsz} ({bvals.numel() * 4} bytes of tiles): max_abs_err={err_b!r}")

    # times: each product as the solver calls it (float64 in and out, the
    # solver's flag) and as the transposed-layout path calls them (a cast to
    # float32, the checked wrapper, a cast back; K~^T u on the transposed layout); the
    # bare launches on float32 and on float64 v; the plain versions; the
    # library's BSR mat-vec on each layout; the batch
    v32 = v.to(torch.float32)
    reps = 100  # host-bound calls of some 20-80 us: more samples for a steadier median
    ms = time_ms(lambda: sparsify.block_ell_matvec(sk, v, flag), reps=reps)
    ms_t = time_ms(lambda: sparsify.block_ell_rmatvec(sk, v, flag), reps=reps)
    tl_ms = time_ms(lambda: block_ell_matvec(sk.vals32, sk.col_idx, v.to(torch.float32),
                                               bad_index=flag).to(v.dtype), reps=reps)
    tl_ms_t = time_ms(lambda: block_ell_matvec(skt.vals32, skt.col_idx, v.to(torch.float32), row_ptr=skt.row_ptr,
                                                 bad_index=flag).to(v.dtype), reps=reps)
    bounds = {}
    bare = {}
    kernel_ms = {}
    for name, lay in (("row", sk), ("transposed", skt)):
        for w in (v32, v):
            buf = torch.empty(lay.n, dtype=w.dtype, device=device)

            def bare_launch(lay=lay, buf=buf, w=w):
                _launch_block_ell_matvec(lay.vals32, lay.col_idx, w, lay.row_ptr, buf, flag,
                                         col_blocks=lay.m // lay.block, row_blocks_per_sketch=lay.n // lay.block)

            key = name if w is v32 else f"{name} float64"
            bare[key] = time_ms(bare_launch, reps=reps)
            kernel_ms[key] = device_ms(bare_launch)
        nbytes = block_ell_bytes(lay, 4)
        bounds[name] = block_ell_bound(nbytes, int(lay.nblocks.sum()), lay.block) + (nbytes,)
    for w in (v32, v):  # K~ v as the solver launches it: the valid slots alone
        buf = torch.empty(sk.n, dtype=w.dtype, device=device)

        def valid_launch(buf=buf, w=w):
            _launch_block_ell_matvec(sk.vals32, sk.col_idx, w, None, buf, flag, col_blocks=sk.m // sk.block,
                                     row_blocks_per_sketch=sk.n // sk.block, nblocks=sk.nblocks)

        key = "valid" if w is v32 else "valid float64"
        bare[key] = time_ms(valid_launch, reps=reps)
        kernel_ms[key] = device_ms(valid_launch)
    # the entries' bounds: each product as the solver runs it, on float64
    for name, rm in (("K~ v", False), ("K~^T u", True)):
        nbytes = block_ell_bytes(sk, 8, rmatvec=rm)
        bounds[name] = block_ell_bound(nbytes, int(sk.nblocks.sum()), sk.block) + (nbytes,)
    for w in (v32, v):
        buf_t = torch.empty(sk.m, dtype=w.dtype, device=device)
        key = "rmatvec" if w is v32 else "rmatvec float64"
        bare[key] = time_ms(lambda: _launch_block_ell_rmatvec(sk.vals32, cols, w, buf_t, flag), reps=reps)
        kernel_ms[key] = device_ms(lambda: _launch_block_ell_rmatvec(sk.vals32, cols, w, buf_t, flag))
    plain_ms = time_ms(lambda: block_ell_matvec_ref(sk.vals32, sk.col_idx, v32.reshape(-1, sk.block)))
    plain_dev = device_ms(lambda: block_ell_matvec_ref(sk.vals32, sk.col_idx, v32.reshape(-1, sk.block)))
    plain_ms_t = time_ms(lambda: block_ell_rmatvec_ref(sk.vals32, cols, v32.reshape(-1, sk.block)))
    plain_dev_t = device_ms(lambda: block_ell_rmatvec_ref(sk.vals32, cols, v32.reshape(-1, sk.block)))
    lib_ms, lib_note = bsr_library_ms(sk, v32)
    lib_ms_t, lib_note_t = bsr_library_ms(skt, v32)
    bbuf = torch.empty(bsz * n, dtype=torch.float32, device=device)

    def bare_batched():
        _launch_block_ell_matvec(bvals.reshape(-1, *bvals.shape[2:]), bci.reshape(-1, bci.shape[-1]), bv,
                                 None, bbuf, flag, col_blocks=n // sk.block, row_blocks_per_sketch=n // sk.block)

    bare_b = time_ms(bare_batched)
    kernel_b = device_ms(bare_batched)
    ms_b = time_ms(lambda: batched_block_ell_matvec(bvals, bci, bv))
    tiles_b = sum(int(k.nblocks.sum()) for k in sks)
    nbytes_b = 4 * (tiles_b * (sk.block * sk.block + 1) + 2 * bv.numel())
    bound_b = block_ell_bound(nbytes_b, tiles_b, sk.block)
    check(int(flag) == 0, "the timed launches flagged a column id")
    for name, lay in (("row", sk), ("transposed", skt)):
        bound, bound_by, nbytes = bounds[name]
        log(f"block_ell_matvec times, {name} layout: bare launch {bare[name]!r} ms on float32 v, "
            f"{bare[name + ' float64']!r} on float64 (CUDA events), kernel {kernel_ms[name]!r} / "
            f"{kernel_ms[name + ' float64']!r} ms (profiler, device time), bound on float32 v {bound!r} ms "
            f"({bound_by}: {nbytes} bytes of the valid tiles; the kernel also reads "
            f"{lay.vals.shape[0] * lay.max_blocks - int(lay.nblocks.sum())} zero padding tiles)")
    log(f"block_ell_matvec times, row layout, the valid slots alone (the solver's launch): bare launch "
        f"{bare['valid']!r} ms on float32 v, {bare['valid float64']!r} on float64 (CUDA events), kernel "
        f"{kernel_ms['valid']!r} / {kernel_ms['valid float64']!r} ms (profiler, device time)")
    log(f"block_ell_matvec times, row layout (CUDA events): wrapper as the solver calls it {ms!r} ms, bound "
        f"on float64 v {bounds['K~ v'][0]!r} ms ({bounds['K~ v'][1]}: {bounds['K~ v'][2]} bytes) "
        f"(the transposed-layout path's call {tl_ms!r} ms), plain {plain_ms!r} ms (device time {plain_dev!r} ms, "
        f"profiler), library (torch.sparse_bsr_tensor @ v, float32) {lib_ms!r} ms ({lib_note})")
    log(f"block_ell_rmatvec times (K~^T u on the row layout's tiles, CUDA events): wrapper as the solver "
        f"calls it {ms_t!r} ms (the transposed-layout path's: {tl_ms_t!r} ms), bare launch "
        f"{bare['rmatvec']!r} ms on float32 u, {bare['rmatvec float64']!r} on float64, kernels "
        f"{kernel_ms['rmatvec']!r} / {kernel_ms['rmatvec float64']!r} ms (profiler, device time: units and "
        f"combine), bound on float64 u {bounds['K~^T u'][0]!r} ms ({bounds['K~^T u'][1]}: {bounds['K~^T u'][2]} "
        f"bytes: the valid tiles and the column lists), plain {plain_ms_t!r} ms "
        f"(device time {plain_dev_t!r} ms), library on the transposed tiles (torch.sparse_bsr_tensor @ u, "
        f"float32) {lib_ms_t!r} ms ({lib_note_t})")
    log(f"batched_block_ell_matvec B={bsz} times: wrapper {ms_b!r} ms, bare launch {bare_b!r} ms, "
        f"kernel {kernel_b!r} ms (profiler), bound {bound_b[0]!r} ms ({bound_b[1]}: {nbytes_b} bytes)")
    del bvals, bci, bv, sks
    entry = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_ell.cu",
        "replaces": "src/repro/kernels/block_ell.py:40",
        "launches": None,  # filled in from the block-ELL path's run
    }
    # each product's bound on the float64 vectors that the solver passes
    return [
        {"name": "block_ell_matvec", **entry, "max_abs_err": max(errs + [err64]), "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bounds["K~ v"][0], "bound_by": bounds["K~ v"][1],
         "library_ms": lib_ms},
        {"name": "block_ell_rmatvec", **entry, "max_abs_err": max(errs_t), "ms": ms_t,
         "plain_ms": plain_ms_t, "bound_ms": bounds["K~^T u"][0], "bound_by": bounds["K~^T u"][1],
         "library_ms": lib_ms_t},
    ]


def run_block_ell_path(n: int, device, max_iter: int = 1000):
    """``solve(problem, method="spar_sink_block_ell")`` at n: OT at
    s = 16 s0, the same seed again (bitwise equal), and UOT; the launch
    counts are set to 0 just before each solve and read just after it (one
    ``block_ell_matvec`` and one ``block_ell_rmatvec`` launch for each
    iteration the loop executed, and no other: ``K~^T u`` never runs on the
    transposed layout). Then both products' device time inside one OT solve
    (`solve_products_profile`), for this path and the transposed-layout
    path. Returns the
    phase's launches of each kernel and the OT sketch's seed, s and result
    for the float64 check."""
    import torch

    import repro_torch as rt
    from repro_torch.core.sinkhorn import CHECK_EVERY
    from repro_torch.kernels import ops

    ot, uot = block_ell_problems(n, device)
    s = 16 * rt.s0(n)
    names = ("block_ell_matvec", "block_ell_rmatvec")
    total = dict.fromkeys(names, 0)
    results = {}
    for name, problem in (("ot", ot), ("ot-repeat", ot), ("uot", uot)):
        # the sketch alone, timed apart from the solve (which builds it again)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.build_block_ell_sketch(problem, torch.Generator(device=device).manual_seed(0), s)
        torch.cuda.synchronize()
        sketch_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sol = rt.solve(problem, method="spar_sink_block_ell", seed=0, s=s, tol=1e-6, max_iter=max_iter)
        value = float(sol.value)  # syncs
        wall_s = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        for k in names:
            total[k] += counts[k]
        n_iter = int(sol.n_iter)
        executed = min(max_iter, CHECK_EVERY * math.ceil(n_iter / CHECK_EVERY))
        row = dict(run=name, n=n, s=s, n_iter=n_iter, executed=executed, status=sol.status_label,
                   nnz=int(sol.nnz), value=value, sketch_s=sketch_s, solve_s=wall_s,
                   ms_per_executed_iteration_after_sketch=(wall_s - sketch_s) / max(executed, 1) * 1e3,
                   peak_device_bytes=torch.cuda.max_memory_allocated(device),
                   **{f"{k}_launches": counts[k] for k in names})
        log("block-ELL path " + json.dumps(row))
        check(math.isfinite(value), f"block-ELL {name} value is not finite")
        check(sol.status_label not in ("non_finite", "degenerate"), f"block-ELL {name} ended {sol.status_label}")
        check(all(counts[k] == executed for k in names) and sum(counts.values()) == 2 * executed,
              f"block-ELL {name}: launches {counts}, not one block_ell_matvec and one block_ell_rmatvec "
              f"for each of the {executed} executed iterations")
        results[name] = (value, n_iter)
    check(results["ot"] == results["ot-repeat"],
          f"repeated block-ELL OT run differs: {results['ot']} vs {results['ot-repeat']}")
    log("block-ELL path: the repeated OT run is bitwise identical")
    solve_products_profile(ot, uot, s, max_iter, results)
    return total, s, results["ot"]


def solve_products_profile(ot, uot, s: float, max_iter: int, results) -> None:
    """The OT solve on this path and on the transposed-layout path (its
    products patched in: a cast to float32, the checked wrapper, a cast
    back, and ``K~^T u`` on the transposed layout's float32 tiles, made at
    its first call in each solve, as PR 16's sketch made them when it was
    built): 8 warm solves of each
    timed in turns (this, that, that, this), then one of each under
    `torch.profiler`, for the device
    busy share (of the profiled wall and of the median wall) and each
    product's device time a launch inside the solve, where its tiles may be
    served from the L2. In the transposed-layout path both
    products are the same kernel, and the launches alternate ``K~ v``,
    ``K~^T u`` in each iteration, so they are told apart by their order.
    Then the OT and UOT values and iterations of that path against this
    path's (``results``), held at the kernels' float32 tolerance."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import repro_torch as rt
    from repro_torch.core import sparsify
    from repro_torch.kernels import ops

    def tl_matvec(sk, v, bad_index=None):
        return ops.block_ell_matvec(sk.vals32, sk.col_idx, v, row_ptr=sk.row_ptr, bad_index=bad_index).to(v.dtype)

    made = {}  # id of a transposed layout -> (it, its float32 copy), made once a solve

    def tl_rmatvec(sk, u, bad_index=None):
        if id(sk.transposed) not in made:
            made[id(sk.transposed)] = (sk.transposed, transposed32(sk))
        return tl_matvec(made[id(sk.transposed)][1], u, bad_index)

    def solve(problem=ot):
        return rt.solve(problem, method="spar_sink_block_ell", seed=0, s=s, tol=1e-6, max_iter=max_iter)

    current = (sparsify.block_ell_matvec, sparsify.block_ell_rmatvec)
    paths = {"row layout": current, "transposed layout": (tl_matvec, tl_rmatvec)}

    def timed_solve(label):
        sparsify.block_ell_matvec, sparsify.block_ell_rmatvec = paths[label]
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(solve().value)
            return (time.perf_counter() - t0) * 1e3
        finally:
            sparsify.block_ell_matvec, sparsify.block_ell_rmatvec = current
            made.clear()

    walls = {label: [] for label in paths}
    for label in paths:
        timed_solve(label)  # warm
    for _ in range(4):  # in turns: this, that, that, this
        for label in ("row layout", "transposed layout", "transposed layout", "row layout"):
            walls[label].append(timed_solve(label))
    log("block-ELL OT solve wall ms in turns (8 solves each, host clock around a synced solve): "
        + "; ".join(f"{label}: median {statistics.median(w)!r}, all {w!r}" for label, w in walls.items()))
    for label, products in paths.items():
        sparsify.block_ell_matvec, sparsify.block_ell_rmatvec = products
        try:
            sol = solve()
            value = float(sol.value)
            wall_ms = statistics.median(walls[label])
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(solve().value)
                torch.cuda.synchronize()
                prof_wall_us = (time.perf_counter() - t0) * 1e6
            uot_sol = solve(uot)
            uot_value = float(uot_sol.value)
        finally:
            sparsify.block_ell_matvec, sparsify.block_ell_rmatvec = current
            made.clear()
        kernels = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name) for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
        busy = sum(k[1] for k in kernels)
        mv = [k[1] for k in kernels if "block_ell_bk128" in k[2]]
        rmv = [k[1] for k in kernels if "block_ell_rmatvec" in k[2]]  # two kernels a launch
        rmv_launches = len(rmv) // 2
        if label == "transposed layout":  # one kernel, launched K~ v, K~^T u, K~ v, ...
            mv, rmv = mv[0::2], mv[1::2]
            rmv_launches = len(rmv)
        per = {"K~ v": (sum(mv) / max(len(mv), 1), len(mv)),
               "K~^T u": (sum(rmv) / max(rmv_launches, 1), rmv_launches)}
        other = busy - sum(mv) - sum(rmv)
        log(f"block-ELL OT solve, {label}: {int(sol.n_iter)} iterations, value {value!r}, median wall {wall_ms!r} ms "
            f"(under the profiler {prof_wall_us / 1e3!r} ms), kernels {busy / 1e3!r} ms, device busy share "
            f"{busy / prof_wall_us!r} of the profiled wall, {busy / 1e3 / wall_ms!r} of the median wall, "
            f"{len(kernels)} kernels; device time a launch inside the solve (profiler): "
            + ", ".join(f"{k} {us!r} us over {cnt} launches" for k, (us, cnt) in per.items())
            + f"; every other kernel {other / 1e3!r} ms")
        if label != "row layout":
            for name, (v_old, it_old) in (("ot", (value, int(sol.n_iter))), ("uot", (uot_value, int(uot_sol.n_iter)))):
                v_new, it_new = results[name]
                rel = abs(v_new - v_old) / abs(v_old)
                log(f"block-ELL {name.upper()}: the transposed-layout path {v_old!r} ({it_old} it) against "
                    f"the row-layout path's {v_new!r} ({it_new} it): relative difference {rel!r}")
                check(rel <= BLOCK_ELL_TOL["rtol"],
                      f"block-ELL {name} value moved by {rel!r} against the transposed-layout path")


def check_block_ell_accuracy(n: int, device, v_log: float, s: float, ot_result, seeds: int = 4) -> None:
    """The mean relative error of spar_sink_block_ell over seeds against
    phase 4's log value at n; then the card's own OT sketch of phase 6
    solved by the port's float64 CPU path (the one labelled CPU run)."""
    import torch

    import repro_torch as rt
    from repro_torch.core.api.solvers import _block_ell_solution
    from repro_torch.core.sparsify import BlockEllKernel
    from repro_torch.data.pointclouds import make_measures

    a, b, x = make_measures("C1", n, 5, seed=1)
    problem = rt.OTProblem(rt.PointCloudGeometry(x, device=device), a, b, 0.1)
    errs = []
    for seed in range(seeds):
        sol = rt.solve(problem, method="spar_sink_block_ell", seed=seed, s=16 * rt.s0(n), tol=1e-6, max_iter=1000)
        errs.append(abs(float(sol.value) - v_log) / abs(v_log))
    rmae = sum(errs) / len(errs)
    log(f"accuracy n={n}: spar_sink_block_ell s=16 s0 relative errors {errs!r}, mean {rmae!r}")
    check(math.isfinite(rmae), "spar_sink_block_ell mean relative error is not finite")

    ot, _ = block_ell_problems(n, device)
    sk = rt.build_block_ell_sketch(ot, torch.Generator(device=device).manual_seed(0), s)

    def to_cpu(lay, transposed=None):
        return BlockEllKernel(lay.vals.cpu(), lay.col_idx.cpu(), lay.nblocks.cpu(), lay.n, lay.m,
                              row_ptr=None if lay.row_ptr is None else lay.row_ptr.cpu(), transposed=transposed)

    sk_cpu = to_cpu(sk, to_cpu(sk.transposed))
    ot_cpu, _ = block_ell_problems(n, "cpu")
    t0 = time.perf_counter()
    sol = _block_ell_solution(ot_cpu, sk_cpu, 1e-6, 1000)
    value = float(sol.value)
    log(f"float64 CPU check (labelled CPU run) n={n}: the card's OT sketch solved on the CPU in float64: "
        f"value {value!r} ({int(sol.n_iter)} it, {sol.status_label}, {time.perf_counter() - t0!r} s); "
        f"on the card with float32 kernels: value {ot_result[0]!r} ({ot_result[1]} it); "
        f"relative difference {abs(value - ot_result[0]) / abs(value)!r}")
    check(math.isfinite(value), "the float64 CPU block-ELL value is not finite")


# --------------------------------------------------------------------------
# Phase 10: traces, certificates, warm starts and the composite workloads
# --------------------------------------------------------------------------

#: the keys of the reference's `Diagnostics.summary()` for a traced and
#: certified sketch solve, and of its sketch and certificate parts
#: (src/repro/obs/trace.py, src/repro/obs/certify.py)
SUMMARY_KEYS = {"n_iter", "n_matvec", "status", "final_err", "first_traced_iteration", "sketch", "certificate"}
SKETCH_SUMMARY_KEYS = {"nnz", "cap", "fill", "ess", "ess_ratio", "overflowed", "acceptance_rate", "dup_merge_rate"}
CERT_SUMMARY_KEYS = {"value", "gap", "rel_gap", "marg_err_row", "marg_err_col", "coverage_deficit", "error_bound",
                     "ci_low", "ci_high", "ci_width", "ess"}
#: the methods whose certificate carries no sampling term: NaN CI and ESS,
#: as in the reference; every other field of every certificate is finite
UNSAMPLED = ("dense", "log", "greenkhorn", "nys_sink", "screenkhorn_lite", "spar_sink_dense", "spar_sink_block_ell")
#: phase 10's methods at n = 8192 on phase 4's OT problem (certify=True,
#: trace=True where the method takes it, s = 16 s0(n) where it takes s,
#: Greenkhorn at n + m updates)
EVERY_METHOD = (("dense", {}), ("log", {}), ("spar_sink_coo", dict(seed=0)), ("spar_sink_log", dict(seed=0)),
                ("spar_sink_mf", dict(seed=0)), ("spar_sink_mf", dict(seed=0, stabilize=True)),
                ("spar_sink_dense", dict(seed=0)), ("rand_sink", dict(seed=0)), ("spar_sink_block_ell", dict(seed=0)),
                ("greenkhorn", {}), ("nys_sink", dict(seed=0)), ("screenkhorn_lite", {}))


def check_certificate(label: str, cert, sampled: bool) -> dict:
    """A certificate's fields as floats: each finite (the CI and the ESS
    NaN where nothing was sampled, as the reference gives them), the gap
    not below 0 and the bound not below the gap."""
    fields = {f: float(getattr(cert, f)) for f in cert._fields}
    for f, v in fields.items():
        if f in ("ci_low", "ci_high", "ess") and not sampled:
            check(math.isnan(v), f"{label}: certificate {f} is {v!r}, not NaN")
        else:
            check(math.isfinite(v), f"{label}: certificate {f} is {v!r}")
    check(fields["gap"] >= 0.0 and fields["error_bound"] >= fields["gap"],
          f"{label}: gap {fields['gap']!r}, error bound {fields['error_bound']!r}")
    return fields


def counted_solve(total: dict, problem, method: str, **opts):
    """`solve_synced` that also adds the solve's launches into ``total``
    (the kernels line counts phase 10's solves too)."""
    sol, value, wall, launches = solve_synced(problem, method, **opts)
    for name, count in launches.items():
        total[name] = total.get(name, 0) + count
    return sol, value, wall, launches


def traced_main_path(total: dict, n: int, device, runs: dict, scalings_a, value_dense: float,
                     max_iter: int = 200) -> None:
    """Phase 10 (1) and (2): run (a) traced and certified, then run (b)
    certified and warm-started from its own potentials."""
    import torch

    import repro_torch as rt
    from repro_torch.core.api import solvers
    from repro_torch.data.pointclouds import make_measures

    eps, s = 0.1, 4 * rt.s0(n)
    a, b, x = make_measures("C1", n, 5, seed=0)
    ot = rt.OTProblem(rt.PointCloudGeometry(x, device=device), a, b, eps)
    opts = dict(seed=0, s=s, tol=1e-6, max_iter=max_iter)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sol, value, wall, launches = counted_solve(total, ot, "spar_sink_mf", trace=True, certify=True, **opts)
    peak = torch.cuda.max_memory_allocated() - base
    n_iter, d = int(sol.n_iter), sol.diagnostics
    check(launches == {"gathered_kernel": 1}, f"phase 10 (a): the traced solve launched {launches}")
    check((value, n_iter) == runs["a"] and torch.equal(sol.result.u, scalings_a[0])
          and torch.equal(sol.result.v, scalings_a[1]), "phase 10 (a): the traced solve is not phase 3's run (a)")
    check(d.n_matvec == 2 * n_iter, f"phase 10 (a): {d.n_matvec} matvecs for {n_iter} iterations")
    errs = d.iteration_errors()
    check(len(errs) == min(n_iter, d.trace.trace_len) and errs[-1] == float(sol.err),
          "phase 10 (a): the last traced error is not the solve's")
    summary = d.summary()
    check(set(summary) == SUMMARY_KEYS and set(summary["sketch"]) == SKETCH_SUMMARY_KEYS
          and set(summary["certificate"]) == CERT_SUMMARY_KEYS, f"phase 10 (a): summary keys {summary}")
    cert = check_certificate("phase 10 (a)", sol.certificate, sampled=True)
    observed = abs(value - value_dense)
    log("phase 10 (a) " + json.dumps(dict(
        n=n, s=s, value=value, n_iter=n_iter, status=sol.status_label, wall_s=wall, peak_bytes=peak,
        launches=launches, n_matvec=d.n_matvec, first_errors=errs[:3].tolist(), last_errors=errs[-3:].tolist(),
        sketch=summary["sketch"], certificate=cert, value_dense=value_dense, observed_error=observed,
        bound_over_observed=cert["error_bound"] / observed)))
    if cert["error_bound"] < observed:
        log(f"phase 10 (a): finding: the error bound {cert['error_bound']!r} is below the observed error "
            f"{observed!r} against the fused dense objective")
    del sol, d
    # walls in turns (untraced, traced, traced and certified, then the
    # other way round, ...), each synced; then each variant's device
    # kernels and device time a solve (profiler)
    variants = {"untraced": {}, "traced": dict(trace=True), "certified": dict(trace=True, certify=True)}
    walls = {k: [] for k in variants}
    peaks = {k: [] for k in variants}
    for label in ("untraced", "traced", "certified", "certified", "traced", "untraced", "untraced", "traced",
                  "certified"):
        extra = variants[label]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = rt.solve(ot, method="spar_sink_mf", **opts, **extra)
        float(out.value)
        torch.cuda.synchronize()
        walls[label].append(time.perf_counter() - t0)
        peaks[label].append(torch.cuda.max_memory_allocated() - base)
        del out
    med = {k: statistics.median(v) for k, v in walls.items()}
    kernels = {k: device_kernels(lambda: float(rt.solve(ot, method="spar_sink_mf", **opts, **extra).value))
               for k, extra in variants.items()}
    # the certify step alone, on the same sketch and scalings (its fields
    # bitwise the certified solve's)
    sk, c_e = rt.build_mf_sketch(ot, torch.Generator(device=device).manual_seed(0), s)
    res = solvers._coo_scaling_loop(ot, sk, 1e-6, max_iter)
    v = solvers._coo_value(ot, sk, c_e, res)
    cert_walls, cert_peaks = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        alone = solvers._sparse_cert(ot, sk, res, v, c_e, log_domain=False)
        float(alone.error_bound)
        torch.cuda.synchronize()
        cert_walls.append(time.perf_counter() - t0)
        cert_peaks.append(torch.cuda.max_memory_allocated() - base)
    check({f: float(getattr(alone, f)) for f in alone._fields} == cert,
          "phase 10 (a): the certify step alone differs from the certified solve's certificate")
    cert_dev_ms = device_ms(lambda: solvers._sparse_cert(ot, sk, res, v, c_e, log_domain=False), reps=3)
    log("phase 10 (a) in turns " + json.dumps(dict(
        walls_s=walls, median_s=med, trace_overhead_s=med["traced"] - med["untraced"],
        certify_overhead_s=med["certified"] - med["traced"], peaks_bytes=peaks,
        device_kernels_and_us=kernels,
        added_kernels_an_iteration=(kernels["traced"][0] - kernels["untraced"][0]) / n_iter,
        certify_step_walls_s=cert_walls, certify_step_median_s=statistics.median(cert_walls),
        certify_step_peak_bytes=max(cert_peaks), certify_step_device_ms=cert_dev_ms, cap=sk.cap)))
    del sk, c_e, res, alone
    torch.cuda.empty_cache()
    # (2) run (b) certified, then warm-started from its own potentials
    (sol_b, value_b, wall_b, launches), launched = loop_launched(lambda: counted_solve(
        total, ot, "spar_sink_mf", stabilize=True, certify=True, **opts))
    want = {"gathered_cost": 1, "segment_lse": 2 * launched}
    check(launches == want, f"phase 10 (b): the certified solve launched {launches}, not {want}")
    check((value_b, int(sol_b.n_iter)) == runs["b"], "phase 10 (b): the certified solve is not phase 3's run (b)")
    cert_b = check_certificate("phase 10 (b)", sol_b.certificate, sampled=True)
    (warm, value_w, wall_w, launches), launched = loop_launched(lambda: counted_solve(
        total, ot, "spar_sink_mf", stabilize=True, certify=True, init=sol_b.potentials, **dict(opts, tol=1e-7)))
    want = {"gathered_cost": 1, "segment_lse": 2 * launched}
    check(launches == want, f"phase 10 (b) warm: the solve launched {launches}, not {want}")
    check(math.isfinite(value_w), "phase 10 (b) warm: value not finite")
    cert_w = check_certificate("phase 10 (b) warm", warm.certificate, sampled=True)
    log("phase 10 (b) " + json.dumps(dict(
        cold=dict(value=value_b, n_iter=int(sol_b.n_iter), status=sol_b.status_label, wall_s=wall_b,
                  certificate=cert_b, observed_error=abs(value_b - value_dense)),
        warm=dict(tol=1e-7, value=value_w, n_iter=int(warm.n_iter), status=warm.status_label, wall_s=wall_w,
                  certificate=cert_w, observed_error=abs(value_w - value_dense)))))
    del sol_b, warm, ot
    torch.cuda.empty_cache()


def traced_block_ell(total: dict, n: int, device, ot_result, max_iter: int = 1000) -> None:
    """Phase 10 (3): phase 6's OT solve traced and certified."""
    import repro_torch as rt
    from repro_torch.core.sinkhorn import CHECK_EVERY

    ot, _ = block_ell_problems(n, device)
    sol, value, wall, launches = counted_solve(total, ot, "spar_sink_block_ell", seed=0, s=16 * rt.s0(n),
                                               tol=1e-6, max_iter=max_iter, trace=True, certify=True)
    n_iter = int(sol.n_iter)
    executed = min(max_iter, CHECK_EVERY * math.ceil(n_iter / CHECK_EVERY))
    check((value, n_iter) == tuple(ot_result), f"phase 10 block-ELL: ({value!r}, {n_iter}) is not phase 6's "
          f"{ot_result}")
    check(launches == {"block_ell_matvec": executed, "block_ell_rmatvec": executed},
          f"phase 10 block-ELL: launches {launches}, not one of each product for each of {executed} iterations")
    check(sol.diagnostics.n_matvec == 2 * n_iter, "phase 10 block-ELL: matvec count")
    cert = check_certificate("phase 10 block-ELL", sol.certificate, sampled=False)
    log("phase 10 block-ELL " + json.dumps(dict(n=n, value=value, n_iter=n_iter, executed=executed, wall_s=wall,
                                                launches=launches, certificate=cert)))


def every_method_certified(total: dict, n: int, device, v_log: float) -> None:
    """Phase 10 (4): every method on phase 4's OT problem, certified."""
    import torch

    import repro_torch as rt
    from repro_torch.core.api.registry import method_accepts
    from repro_torch.data.pointclouds import make_measures

    a, b, x = make_measures("C1", n, 5, seed=1)
    problem = rt.OTProblem(rt.PointCloudGeometry(x, device=device), a, b, 0.1)
    s = 16 * rt.s0(n)
    for method, extra in EVERY_METHOD:
        opts = dict(extra, certify=True)
        for option, value in (("s", s), ("trace", True), ("tol", 1e-6), ("max_iter", 1000), ("n_updates", 2 * n)):
            if method_accepts(method, option):
                opts[option] = value
        sol, value, wall, launches = counted_solve(total, problem, method, **opts)
        label = f"phase 10 every method {method}{' (stabilize)' if extra.get('stabilize') else ''}"
        cert = check_certificate(label, sol.certificate, sampled=method not in UNSAMPLED)
        observed = abs(value - v_log)
        d = sol.diagnostics
        log(label + " " + json.dumps(dict(
            value=value, rel_err=observed / abs(v_log), observed_error=observed, error_bound=cert["error_bound"],
            bound_covers=cert["error_bound"] >= observed, gap=cert["gap"], coverage=cert["coverage_deficit"],
            ci_width=cert["ci_high"] - cert["ci_low"], ess=cert["ess"], n_iter=int(sol.n_iter),
            status=sol.status_label, n_matvec=d.n_matvec, wall_s=wall, launches=launches)))
        del sol, d
    del problem
    torch.cuda.empty_cache()


def _tensors(out) -> list:
    """The tensors of a (nested) tuple result, in order."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out for t in _tensors(x)] if isinstance(out, tuple) else []


def twice(label: str, fn):
    """``fn()`` twice, synced: the first result and both walls; the two
    results must be bitwise equal."""
    import torch

    outs, walls = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    first, second = _tensors(outs[0]), _tensors(outs[1])
    check(len(first) == len(second) > 0 and all(torch.equal(p, q) for p, q in zip(first, second)),
          f"{label}: two runs differ")
    return outs[0], walls


def composites(device) -> None:
    """Phase 10 (5): the divergence, barycenters and proximal OT, each run
    twice (bitwise equal)."""
    import torch

    import repro_torch as rt
    from repro_torch.core import proximal
    from repro_torch.core.geometry import normalize_cost, squared_euclidean_cost
    from repro_torch.data.pointclouds import make_measures

    n = 4096
    a, _, x = (torch.as_tensor(t, device=device) for t in make_measures("C1", n, 5, seed=2))
    _, b, y = (torch.as_tensor(t, device=device) for t in make_measures("C1", n, 5, seed=3))
    div = {}
    for method, extra in (("dense", {}), ("spar_sink_coo", dict(seed=0, s=16 * rt.s0(n)))):
        (value, status), walls = twice(f"phase 10 divergence {method}", lambda: rt.sinkhorn_divergence(
            x, y, a, b, 0.1, method=method, with_status=True, **extra))
        div[method] = float(value)
        check(math.isfinite(div[method]), f"phase 10 divergence {method}: not finite")
        log("phase 10 divergence " + json.dumps(dict(method=method, n=n, eps=0.1, value=div[method],
                                                     status=int(status), walls_s=walls)))
    log(f"phase 10 divergence: spar_sink_coo against dense, relative difference "
        f"{abs(div['spar_sink_coo'] - div['dense']) / abs(div['dense'])!r}")
    del a, b, x, y
    # three blobs on a 64 x 64 grid, eps = 0.01 on the squared distances
    pts = rt.grid_support_2d(64, 64, dtype=torch.float64, device=device)
    geom = rt.Geometry(squared_euclidean_cost(pts, pts))
    centers = torch.tensor([[0.25, 0.3], [0.7, 0.35], [0.5, 0.75]], dtype=torch.float64, device=device)
    bs = torch.exp(-((pts[None, :, :] - centers[:, None, :]) ** 2).sum(-1) / (2 * 0.08 ** 2)) + 1e-6
    bs = bs / bs.sum(dim=1, keepdim=True)
    w = torch.full((3,), 1.0 / 3, dtype=torch.float64, device=device)
    qs = {}
    for method, extra in (("ibp", {}), ("spar_ibp", dict(seed=0, s=16 * rt.s0(4096)))):
        res, walls = twice(f"phase 10 barycenter {method}", lambda: rt.solve_barycenter(
            geom, bs, w, 0.01, method=method, tol=1e-6, max_iter=3000, **extra))
        qs[method] = res.q
        check(bool(torch.isfinite(res.q).all()) and res.q.shape == (pts.shape[0],), f"phase 10 barycenter {method}")
        log("phase 10 barycenter " + json.dumps(dict(method=method, grid="64x64", measures=3, eps=0.01,
                                                     n_iter=int(res.n_iter), status=int(res.status),
                                                     err=float(res.err), mass=float(res.q.sum()), walls_s=walls)))
    log(f"phase 10 barycenter: L1 distance between the ibp and spar_ibp barycentres "
        f"{float(torch.abs(qs['ibp'] - qs['spar_ibp']).sum())!r}")
    del geom, bs, qs
    m = 2048
    a, b, x = (torch.as_tensor(t, device=device) for t in make_measures("C1", m, 5, seed=4))
    C, _ = normalize_cost(squared_euclidean_cost(x, x))
    (res, _), walls = twice("phase 10 prox_sinkhorn", lambda: proximal.prox_sinkhorn(C, a, b, 0.05, n_outer=10))
    log("phase 10 prox_sinkhorn " + json.dumps(dict(n=m, cost=float(res.cost), marginal_err=float(res.marginal_err),
                                                    walls_s=walls)))
    check(math.isfinite(float(res.cost)), "phase 10 prox_sinkhorn: cost not finite")
    dense_cost = float(res.cost)
    res, walls = twice("phase 10 prox_spar_sink", lambda: proximal.prox_spar_sink(
        C, a, b, 0.05, 16 * rt.s0(m), seed=0, n_outer=10))
    log("phase 10 prox_spar_sink " + json.dumps(dict(n=m, cost=float(res.cost), marginal_err=float(res.marginal_err),
                                                     relative_to_dense=(float(res.cost) - dense_cost) / dense_cost,
                                                     walls_s=walls)))
    check(math.isfinite(float(res.cost)), "phase 10 prox_spar_sink: cost not finite")
    torch.cuda.empty_cache()


def run_observability_phase(device, runs: dict, scalings_a, value_dense: float, v_log: float, ot_be) -> dict:
    """Phase 10 (see the module docstring); returns its solves' launches."""
    t0 = time.perf_counter()
    total: dict[str, int] = {}
    traced_main_path(total, 2 ** 17, device, runs, scalings_a, value_dense)
    t1 = time.perf_counter()
    traced_block_ell(total, 8192, device, ot_be)
    every_method_certified(total, 8192, device, v_log)
    t2 = time.perf_counter()
    composites(device)
    log(f"phase 10: main path {t1 - t0!r} s, block-ELL and every method {t2 - t1!r} s, composites "
        f"{time.perf_counter() - t2!r} s; launches of its solves {json.dumps(total)}")
    return total


# --------------------------------------------------------------------------
# Phase 11: OT serving (the batched engine, the ladder and breaker, OTServer)
# --------------------------------------------------------------------------

#: (i)'s executor parity batch: 16 mixed OT/UOT point-cloud problems in two
#: buckets (1024 and 2048)
PARITY_SIZES = (1000, 1024, 1800, 2048)
#: (i)'s UOT elements' lams, one each: each scaling update raises to an
#: exponent lam / (lam + eps) of its own, 0.1 = eps the special x ** 0.5
PARITY_LAMS = (0.5, 0.1, 0.3, 0.7, 2.0, 1.0, 0.2, 5.0)
#: (ii)'s served traffic: the reference CLI's request kind at card scale
SERVE_REQUESTS, SERVE_SIZES, SERVE_MAX_BATCH, SERVE_DEADLINE_S = 64, (2048, 4096, 8192, 16384), 16, 0.02
#: dense and log batched against their per-problem solves: relative to the
#: largest |entry| (the batched (B, n, m) products and logsumexps reduce
#: over the padded bucket, the per-problem ones over the true support)
DENSE_BATCH_RTOL = 1e-12


def _parity_problems(device, count: int = 16, sizes=PARITY_SIZES, seed: int = 11, uot_only: bool = False,
                     lams=(0.5,)):
    """Mixed OT/UOT point-cloud problems of the serving CLI's kind (d = 3,
    eps 0.1, UOT masses 5/3; all UOT with ``uot_only``), sizes cycling
    through ``sizes``, the UOT ones' lam through ``lams``."""
    import numpy as np

    import repro_torch as rt

    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = sizes[i % len(sizes)]
        x, a, b = rng.uniform(size=(n, 3)), rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))
        geom = rt.PointCloudGeometry(x, device=device)
        uot = uot_only or i % 2
        lam = lams[len(out) % len(lams) if uot_only else (i // 2) % len(lams)]
        out.append(rt.UOTProblem(geom, a * 5.0, b * 3.0, 0.1, lam=lam) if uot else rt.OTProblem(geom, a, b, 0.1))
    return out


def _launches_into(total: dict, counts: dict) -> None:
    for name, count in counts.items():
        total[name] = total.get(name, 0) + count


def batched_dispatch(total: dict, executor, problems, **opts):
    """One counted ``solve_batch`` (counts set to 0 just before, read just
    after, added into ``total``): ``(solutions, wall s, launches)``."""
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sols = executor.solve_batch(problems, **opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: count for name, count in ops.LAUNCHES.items() if count}
    _launches_into(total, counts)
    return sols, wall, counts


def segment_locality(sketch, log_space: bool) -> None:
    """CUDA's `segment_reduce` on the flat batched layout against each
    element's own reduction: disjoint segments must give bitwise the
    per-element ``K~ v``, ``K~^T u`` (or their logsumexps)."""
    import torch

    from repro_torch.core import sparsify
    from repro_torch.kernels import ops

    B, cap = sketch.rows.shape
    n = int(sketch.rows.max()) + 1
    m = int(sketch.cols.max()) + 1
    gen = torch.Generator(device=sketch.rows.device).manual_seed(5)
    v = torch.rand((B, m), dtype=torch.float64, device=sketch.rows.device, generator=gen)
    u = torch.rand((B, n), dtype=torch.float64, device=sketch.rows.device, generator=gen)
    csort = sketch.csort
    if log_space:
        row = ops.batched_coo_logsumexp(sketch.rows, sketch.vals + v.gather(1, sketch.cols), n=n,
                                        indices_are_sorted=True)
        z = (sketch.vals + u.gather(1, sketch.rows)).gather(1, csort)
        col = ops.batched_coo_logsumexp(sketch.cols.gather(1, csort), z, n=m, indices_are_sorted=True)
    else:
        row = ops.batched_coo_matvec(sketch.rows, sketch.vals, v.gather(1, sketch.cols), n=n, indices_are_sorted=True)
        col = ops.batched_coo_rmatvec(sketch.cols.gather(1, csort), sketch.vals.gather(1, csort),
                                      u.gather(1, sketch.rows).gather(1, csort), m=m, indices_are_sorted=True)
    for j in range(B):
        c = sketch.element_cap(j)
        cls = sparsify.LogSparseKernelCOO if log_space else sparsify.SparseKernelCOO
        sk = cls(sketch.rows[j, :c], sketch.cols[j, :c], sketch.vals[j, :c], sketch.nnz[j], n, m,
                 csort=sketch.csort[j, :c])
        if log_space:
            r_j, c_j = sparsify.coo_lse_row(sk, v[j]), sparsify.coo_lse_col(sk, u[j])
        else:
            r_j, c_j = sparsify.coo_matvec(sk, v[j]), sparsify.coo_rmatvec(sk, u[j])
        check(torch.equal(row[j], r_j) and torch.equal(col[j], c_j),
              f"phase 11: the flat segment reduction of element {j} differs from its own "
              f"(max abs {float((row[j] - r_j).abs().nan_to_num().max())!r}, "
              f"{float((col[j] - c_j).abs().nan_to_num().max())!r})")
    log(f"phase 11: flat segment {'logsumexp' if log_space else 'sums'} over B={B} x cap={cap} bitwise each "
        f"element's own, both directions")


def kernel_locality(sketch) -> None:
    """The gathered segment logsumexp (`ops.bind_coo_gather_logsumexp`) on a
    stacked log sketch of B elements against a B = 1 launch on each
    element's own slots (its own alignment): bitwise, both directions as
    `sparse_log_potentials` calls them."""
    import torch

    from repro_torch.kernels import ops

    B, cap = sketch.rows.shape
    dev = sketch.rows.device
    n = int(sketch.rows.max()) + 1
    m = int(sketch.cols.max()) + 1
    gen = torch.Generator(device=dev).manual_seed(6)
    f = torch.rand((B, n), dtype=torch.float64, device=dev, generator=gen) - 0.5
    g = torch.rand((B, m), dtype=torch.float64, device=dev, generator=gen) - 0.5
    eps = torch.linspace(0.05, 0.2, B, dtype=torch.float64, device=dev)

    def halves(rows, cols, vals, csort, f, g, eps):
        row_off = ops.batched_offsets(rows, n, indices_are_sorted=True)[1]
        col_off = ops.batched_offsets(cols.gather(1, csort), m, indices_are_sorted=True)[1]
        return (ops.bind_coo_gather_logsumexp(row_off, vals, cols, eps)(g),
                ops.bind_coo_gather_logsumexp(col_off, vals.gather(1, csort), rows.gather(1, csort), eps)(f))

    row, col = halves(sketch.rows, sketch.cols, sketch.vals, sketch.csort, f, g, eps)
    for j in range(B):
        c = sketch.element_cap(j)
        own = (sketch.rows[j:j + 1, :c], sketch.cols[j:j + 1, :c], sketch.vals[j:j + 1, :c], sketch.csort[j:j + 1, :c])
        r_j, c_j = halves(*own, f[j:j + 1], g[j:j + 1], eps[j:j + 1])
        check(torch.equal(row[j], r_j[0]) and torch.equal(col[j], c_j[0]),
              f"phase 11: the gathered segment logsumexp of element {j} in the batch differs from its B = 1 launch "
              f"(max abs {float((row[j] - r_j[0]).abs().nan_to_num().max())!r}, "
              f"{float((col[j] - c_j[0]).abs().nan_to_num().max())!r})")
    log(f"phase 11: the gathered segment logsumexp over B={B} x cap={cap} bitwise each element's B = 1 launch, both "
        f"directions")


def executor_parity(total: dict, device) -> None:
    """Phase 11 (i)."""
    import torch

    import repro_torch as rt
    from repro_torch.batch import BucketedExecutor, build_batched_mf_log_sketch, build_batched_mf_sketch
    from repro_torch.obs.metrics import MetricsRegistry

    problems = _parity_problems(device, lams=PARITY_LAMS)
    ex = BucketedExecutor(metrics=MetricsRegistry())
    for method, tol in (("dense", 1e-9), ("log", 1e-9)):
        sols, wall, _ = batched_dispatch(total, ex, problems, method=method, tol=tol, max_iter=2000)
        worst = 0.0
        for p, sol in zip(problems, sols):
            ref = rt.solve(p, method=method, tol=tol, max_iter=2000)
            check((int(sol.n_iter), sol.status_label) == (int(ref.n_iter), ref.status_label),
                  f"phase 11 {method} {p.shape}: batched {int(sol.n_iter)} {sol.status_label}, per-problem "
                  f"{int(ref.n_iter)} {ref.status_label}")
            for x, y in ((sol.result.u, ref.result.u), (sol.result.v, ref.result.v), (sol.value, ref.value)):
                fin = torch.isfinite(y)
                check(torch.equal(fin, torch.isfinite(x)), f"phase 11 {method}: the finite entries differ")
                scale = float(y[fin].abs().max()) if bool(fin.any()) else 1.0
                worst = max(worst, float((x[fin] - y[fin]).abs().max()) / scale if bool(fin.any()) else 0.0)
        check(worst <= DENSE_BATCH_RTOL, f"phase 11 {method}: batched against per-problem {worst!r}")
        log(f"phase 11 (i) {method}: 16 problems in 2 buckets, UOT lams {PARITY_LAMS}, {wall!r} s batched; "
            f"iterations and status equal, "
            f"u, v and value within {worst!r} of the largest entry (tolerance {DENSE_BATCH_RTOL})")
    s = 8 * rt.s0(2048)
    seeds = list(range(16))
    for stabilize in (False, True):
        opts = dict(method="spar_sink_mf", seeds=seeds, s=s, tol=1e-6, max_iter=2000, stabilize=stabilize)
        before = ex.compile_count
        (sols, wall, counts), launched = loop_launched(lambda: batched_dispatch(total, ex, problems, **opts))
        fills = ex.compile_count - before
        want = {"gathered_cost" if stabilize else "gathered_kernel": 16}
        if stabilize:  # two an iteration of each bucket's batched loop
            want["segment_lse"] = 2 * launched
        check(counts == want, f"phase 11 spar_sink_mf stabilize={stabilize}: the dispatch launched {counts}, not "
              f"{want}")
        for i, (p, sol) in enumerate(zip(problems, sols)):
            ref = rt.solve(p, method="spar_sink_mf", seed=i, s=s, tol=1e-6, max_iter=2000, stabilize=stabilize)
            same = (torch.equal(sol.result.u, ref.result.u) and torch.equal(sol.result.v, ref.result.v)
                    and int(sol.n_iter) == int(ref.n_iter) and int(sol.nnz) == int(ref.nnz)
                    and sol.status_label == ref.status_label and float(sol.value) == float(ref.value))
            plan, rplan = sol.plan(), ref.plan()
            same = same and all(torch.equal(getattr(plan, f), getattr(rplan, f)) for f in ("rows", "cols", "vals"))
            check(same, f"phase 11 spar_sink_mf stabilize={stabilize} problem {i} {p.shape}: batched is not "
                  f"bitwise the per-problem solve (u max abs {float((sol.result.u - ref.result.u).abs().max())!r}, "
                  f"iterations {int(sol.n_iter)}/{int(ref.n_iter)})")
        _, wall2, _ = batched_dispatch(total, ex, problems, **opts)
        check(ex.compile_count == before + fills, "phase 11: a repeat dispatch filled the cache again")
        log(f"phase 11 (i) spar_sink_mf stabilize={stabilize} s={s!r}: 16 problems in 2 buckets (UOT lams "
            f"{PARITY_LAMS}), {fills} cache "
            f"fills, then none on the repeat; u, v, n_iter, nnz, status, value and plan entries bitwise the "
            f"per-problem solve(seed=i); {counts}; dispatch {wall!r} s, repeat {wall2!r} s")
        build = build_batched_mf_log_sketch if stabilize else build_batched_mf_sketch
        group = [p for p in problems if p.shape[0] > 1024]
        gens = [torch.Generator(device=device).manual_seed(i) for i in range(len(group))]
        segment_locality(build(group, gens, s), stabilize)
        if stabilize:
            kernel_locality(build(problems, [torch.Generator(device=device).manual_seed(i) for i in seeds], s))
    log(f"phase 11 (i) executor metrics: hits {ex.metrics.get_counter('executor.cache_hit')!r}, misses "
        f"{ex.metrics.get_counter('executor.cache_miss')!r}, entries {ex.metrics.get_gauge('executor.cache_entries')!r}, "
        f"occupancy {json.dumps(ex.metrics.get_histogram('executor.bucket_occupancy'))}, dispatch s "
        f"{json.dumps(ex.metrics.get_histogram('executor.dispatch_seconds'))}")


def per_iteration_launches(device, stabilize: bool) -> tuple[int, int]:
    """Kernel launches of one batched iteration (16 full 16384 buckets'
    solve at max_iter 32 less the same at 16, by the profiler), and of a
    per-problem iteration the same way."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import repro_torch as rt
    from repro_torch.batch import BatchedProblem, build_batched_mf_log_sketch, build_batched_mf_sketch
    from repro_torch.batch import get_batched_solver

    problems = _parity_problems(device, count=16, sizes=(16384,), seed=3)
    s = 8 * rt.s0(16384)
    build = build_batched_mf_log_sketch if stabilize else build_batched_mf_sketch
    sk = build(problems, [torch.Generator(device=device).manual_seed(i) for i in range(16)], s)
    bp = BatchedProblem.from_problems(problems, materialize_cost=False)
    solver = get_batched_solver("spar_sink_mf")

    def kernels(fn) -> int:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)

    def batched(k):
        return lambda: solver(bp, sk, stabilize=stabilize, tol=0.0, max_iter=k)

    def single(k):
        return lambda: rt.solve(problems[0], method="spar_sink_mf", seed=0, s=s, tol=0.0, max_iter=k,
                                stabilize=stabilize)

    kernels(batched(16))
    return ((kernels(batched(32)) - kernels(batched(16))) // 16, (kernels(single(32)) - kernels(single(16))) // 16)


def busy_share(fn) -> tuple[float, float, object]:
    """``fn()`` under `torch.profiler`: the card's busy share (kernel device
    time over the wall) and the wall; returns ``(share, wall s, fn())``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return busy_us / 1e6 / wall, wall, out


def served_sketch_kernels(problems, sols) -> None:
    """B1 and its cost-only mode at (ii)'s own d, n and k: the pairs of one
    served 16384-point sketch (its whole slice, as the sketch build gave
    them to the kernel) through `_gathered_case`, against their plain
    versions at K_TOL / C_TOL and `cost64_excess`'s tolerance. These
    launches are not counted: the counts are set to 0 before the next
    counted run."""
    j = next(i for i, p in enumerate(problems) if p.shape[0] == max(SERVE_SIZES))
    plan, geom = sols[j].plan(), problems[j].geom
    err = _gathered_case(geom.x, geom.y, plan.rows, plan.cols, eps=float(problems[j].eps), cost=geom.cost_name,
                         eta=geom.eta)
    log(f"phase 11 (ii): B1 and its cost-only mode on request {j}'s served sketch (n = {problems[j].shape[0]}, "
        f"d = {geom.x.shape[1]}, k = {plan.rows.shape[0]} pairs, nnz {int(plan.nnz)}) against their plain "
        f"versions: max abs err {err!r}")


def serve_streams(total: dict, device) -> dict:
    """Phase 11 (ii): the server at serving size, scaling and log domain."""
    import torch

    import repro_torch as rt
    from repro_torch.batch import BucketedExecutor
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_ot import OTServer, _make_request_problems
    from repro_torch.obs.metrics import MetricsRegistry

    problems = _make_request_problems(SERVE_REQUESTS, SERVE_SIZES, 0, point_cloud=True, device=device)
    s = 8 * rt.s0(max(SERVE_SIZES))
    sizes = sorted({p.shape[0] for p in problems})
    log(f"phase 11 (ii): {SERVE_REQUESTS} requests, sizes {[sum(p.shape[0] == z for p in problems) for z in sizes]} "
        f"of {sizes}, s = 8 s0(16384) = {s!r} (cap {rt.default_cap(s)}), max_batch {SERVE_MAX_BATCH}, deadline "
        f"{SERVE_DEADLINE_S} s")
    rows = {}
    for stabilize in (False, True):
        opts = dict(method="spar_sink_mf", s=s, max_iter=2000, stabilize=stabilize)
        server = OTServer(BucketedExecutor(metrics=MetricsRegistry()), max_batch=SERVE_MAX_BATCH,
                          deadline_s=SERVE_DEADLINE_S)

        def stream():
            futures = [server.submit(p, seed=i, **opts) for i, p in enumerate(problems)]
            return [f.result() for f in futures]

        with server:
            ops.reset_launch_counts()
            t_prof = time.perf_counter()
            share, warm_s, _ = busy_share(stream)
            prof_s = time.perf_counter() - t_prof
            _launches_into(total, ops.LAUNCHES)
            server.reset_stats()
            server.metrics.reset("executor.")  # the timed stream's dispatches alone
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            sols = stream()
            values = [float(sol.value) for sol in sols]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(ops.LAUNCHES)
            _launches_into(total, counts)
            peak = torch.cuda.max_memory_allocated() - base
        st = server.stats()
        if not stabilize:
            served_sketch_kernels(problems, sols)
        iters = [int(sol.n_iter) for sol in sols]
        statuses = sorted({sol.status_label for sol in sols})
        del sols
        name = "gathered_cost" if stabilize else "gathered_kernel"
        lse = counts["segment_lse"]  # two an iteration of each batched loop in the log domain
        check(counts[name] == SERVE_REQUESTS and sum(counts.values()) == SERVE_REQUESTS + lse
              and (lse > 0 and lse % 2 == 0 if stabilize else lse == 0),
              f"phase 11 (ii) stabilize={stabilize}: the timed stream launched {counts}")
        check(all(math.isfinite(v) for v in values), f"phase 11 (ii) stabilize={stabilize}: a value is not finite")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serial = []
        for i, p in enumerate(problems):
            sol, value, _, launches = counted_solve(total, p, "spar_sink_mf", seed=i, **{
                k: v for k, v in opts.items() if k != "method"})
            serial.append(value)
        serial_s = time.perf_counter() - t0
        differ = [i for i, (x, y) in enumerate(zip(values, serial)) if x != y]
        check(not differ, f"phase 11 (ii) stabilize={stabilize}: served values differ from the per-problem "
              f"solves at requests {differ[:8]}")
        row = dict(stabilize=stabilize, requests=st["requests"], wall_s=wall, req_per_s=st["requests"] / wall,
                   p50_s=st["p50_latency_s"], p95_s=st["p95_latency_s"], p99_s=st["p99_latency_s"],
                   batches=st["batches"], mean_batch=st["mean_batch"], compiles=st["compiles"],
                   busy_share=share, busy_stream_wall_s=warm_s, busy_profile_s=prof_s, peak_bytes=peak,
                   bucket_dispatches=int(server.metrics.get_histogram("executor.dispatch_seconds")["count"]),
                   occupancy=server.metrics.get_histogram("executor.bucket_occupancy")["mean"],
                   padding_waste=server.metrics.get_histogram("executor.padding_waste")["mean"], serial_s=serial_s,
                   serial_req_per_s=SERVE_REQUESTS / serial_s, speedup=serial_s / wall,
                   n_iter_min=min(iters), n_iter_max=max(iters), statuses=statuses, launches=counts[name],
                   segment_lse_launches=lse)
        log("phase 11 (ii) served " + json.dumps(row))
        log(f"phase 11 (ii) stabilize={stabilize}: every served value equals the per-problem solve(seed=i)'s")
        rows[stabilize] = row
    for stabilize in (False, True):
        t0 = time.perf_counter()
        batched, single = per_iteration_launches(device, stabilize)
        log(f"phase 11 (ii) stabilize={stabilize}: {batched} kernel launches a batched iteration (B = 16, n = 16384), "
            f"{single} a per-problem iteration (profiler; {time.perf_counter() - t0!r} s)")
    return rows


def failure_paths(total: dict, device) -> None:
    """Phase 11 (iii): the ladder on a batch, the robust server, the breaker.
    UOT problems, whose sketch solves converge here (the OT ones end in
    ``stall``, which the ladder would escalate too), by ``spar_sink_coo``,
    whose sketch reads the dense kernel that `ChaosGeometry` poisons."""
    import torch

    import repro_torch as rt
    import repro_torch.robust as rb
    from repro_torch.batch import BucketedExecutor
    from repro_torch.launch.serve_ot import CircuitOpen, OTRequest, OTServer, UnrecoverableSolve
    from repro_torch.obs.metrics import MetricsRegistry

    problems = _parity_problems(device, count=8, sizes=(2048,), seed=21, uot_only=True)
    s = 8 * rt.s0(2048)
    method = "spar_sink_coo"
    short, poisoned = 2, 5
    problems[poisoned] = rb.corrupt_scaling_kernel(problems[poisoned], 7, mode="nan")
    caps = [rt.default_cap(s)] * 8
    caps[short] = rb.undersized_cap(s)
    opts = dict(method=method, seeds=list(range(8)), s=s, cap=caps, tol=1e-6, max_iter=2000)
    ex = BucketedExecutor(metrics=MetricsRegistry())
    plain, _, _ = batched_dispatch(total, ex, problems, **opts)
    robust, wall, _ = batched_dispatch(total, ex, problems, robust=True, **opts)
    escalated = [i for i, sol in enumerate(robust) if sol.escalated]
    history = {i: [(a.action, a.method, a.status, a.overflowed) for a in robust[i].attempts] for i in escalated}
    check(escalated == [short, poisoned], f"phase 11 (iii): escalated {escalated}, not [{short}, {poisoned}]: "
          f"{json.dumps(history)}")
    for i, (p, r) in enumerate(zip(plain, robust)):
        if i in escalated:
            continue
        check(torch.equal(p.result.u, r.result.u) and torch.equal(p.result.v, r.result.v)
              and float(p.value) == float(r.value), f"phase 11 (iii): element {i} differs from the plain batch")
    check(all(r.recovered and r.status_label == "converged" for r in robust),
          f"phase 11 (iii): an element was not recovered: {[(r.recovered, r.status_label) for r in robust]}")
    log(f"phase 11 (iii) solve_batch({method}, robust=True), {wall!r} s: only {escalated} escalated, the rest "
        f"bitwise the plain batch; attempts {json.dumps(history)}; escalations "
        f"{ex.metrics.get_counter('ot_escalations_total')!r}")

    policy = rb.EscalationPolicy(max_attempts=2)
    ser_opts = dict(method=method, s=s, tol=1e-6, max_iter=2000)
    with OTServer(BucketedExecutor(metrics=MetricsRegistry()), robust=True, policy=policy, max_batch=4,
                  deadline_s=0.05) as server:
        saved = server.submit(problems[poisoned], seed=poisoned, **ser_opts)
        lost = server.submit(problems[short], seed=short, cap=caps[short], **ser_opts)
        sol = saved.result(timeout=600)
        failed = lost.exception(timeout=600)
    check(sol.recovered and [a.action for a in sol.attempts] == ["initial", "log_domain"],
          f"phase 11 (iii): the poisoned request gave {[(a.action, a.status) for a in sol.attempts]}")
    check(isinstance(failed, UnrecoverableSolve), f"phase 11 (iii): the undersized request gave {failed!r}")
    log(f"phase 11 (iii) OTServer(robust=True, max_attempts=2): the NaN-kernel request recovered by "
        f"{[(a.action, a.method, a.status) for a in sol.attempts]}; the undersized-cap request failed with "
        f"UnrecoverableSolve: {failed}")

    clock = rb.SkewedClock()
    flaky = rb.FlakyExecutor(BucketedExecutor(metrics=MetricsRegistry()), fail_calls={0, 1})
    srv = OTServer(flaky, clock=clock, breaker=rb.BreakerPolicy(failure_threshold=2, reset_timeout_s=5.0))

    def request():
        return OTRequest(problems[0], method, torch.Generator(device=device).manual_seed(0),
                         dict(s=s, tol=1e-6, max_iter=2000))

    for _ in range(2):
        r = request()
        srv._dispatch(method, [r])
        check(isinstance(r.future.exception(timeout=60), rb.InjectedFault), "phase 11 (iii): no injected fault")
    (brk,) = srv._breakers.values()
    states = [brk.state_label]
    shed = request()
    srv._dispatch(method, [shed])
    check(isinstance(shed.future.exception(timeout=60), CircuitOpen) and flaky.calls == 2,
          "phase 11 (iii): the open breaker did not shed")
    clock.advance(5.1)
    probe = request()
    srv._dispatch(method, [probe])
    probe_status = probe.future.result(timeout=600).status_label
    check(probe_status == "converged" and brk.state_label == "closed",
          f"phase 11 (iii): the half-open probe ({probe_status}) left the breaker {brk.state_label}")
    states += ["shed: CircuitOpen", brk.state_label]
    log(f"phase 11 (iii) breaker over FlakyExecutor(fail_calls={{0, 1}}): {states}; dispatches {flaky.calls}, "
        f"faults {flaky.faults}, shed {srv.metrics.get_counter('ot_shed_total')!r}")


def run_ot_serving_phase(device) -> dict[str, int]:
    """Phase 11 (see the module docstring); returns its kernel launches."""
    total: dict[str, int] = {}
    t0 = time.perf_counter()
    executor_parity(total, device)
    log(f"phase 11 (i) {time.perf_counter() - t0!r} s")
    t1 = time.perf_counter()
    serve_streams(total, device)
    log(f"phase 11 (ii) {time.perf_counter() - t1!r} s")
    t1 = time.perf_counter()
    failure_paths(total, device)
    log(f"phase 11 (iii) {time.perf_counter() - t1!r} s; phase 11 {time.perf_counter() - t0!r} s, launches {total}")
    return total


# --------------------------------------------------------------------------
# Phase 7: the RecurrentGemma-2B serving slice at full width
# --------------------------------------------------------------------------


def check_lru_scan_kernel(device) -> dict:
    """B5 against its plain version at every ``LRU_SHAPES`` entry (a in
    U(0.7, 0.999), b = 0.1 N(0, 1)), with the library's chunk length for
    each; two launches bitwise equal; at (2, 512, 256) views that start 4
    bytes into their storage give the aligned launch's bits; times of the
    wrapper, the bare launch and the plain version at the prefill shape, and
    the bare launch at the training shape."""
    import torch

    from repro_torch.kernels.lru_scan import _launch_lru_scan_fwd
    from repro_torch.kernels.ops import lru_scan
    from repro_torch.kernels.ref import lru_scan_ref

    log_ptxas("lru_")
    errs = []
    for shape in LRU_SHAPES:
        gen = torch.Generator(device=device).manual_seed(sum(shape))
        a = 0.7 + 0.299 * torch.rand(shape, device=device, generator=gen)
        b = 0.1 * torch.randn(shape, device=device, generator=gen)
        out = lru_scan(a, b)
        again = lru_scan(a, b)
        ref = lru_scan_ref(a, b)
        torch.cuda.synchronize()
        check(bool(torch.equal(out, again)), f"lru_scan {shape}: two launches differ")
        check(bool(torch.isfinite(out).all()), f"lru_scan {shape}: non-finite output")
        torch.testing.assert_close(out, ref, **LRU_TOL)
        errs.append(_max_abs_err(out, ref))
        log(f"lru_scan {shape}: {lru_occupancy(False, shape)}: max_abs_err={errs[-1]!r} "
            f"(max |h| {float(ref.abs().max())!r}), two launches bitwise equal")
        if shape == LRU_SHAPES[0]:
            timed = a, b
        elif shape == (1, TRAIN_SEQ, 2560):
            train_bare_ms = time_ms(lambda: _launch_lru_scan_fwd(a, b, out))
            log(f"lru_scan bare launch at {shape}: {train_bare_ms!r} ms, bound {3 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3!r} "
                f"ms (bytes)")
        elif shape == (2, 512, 256):
            # contiguous views that start one float into their storage: W is
            # a multiple of 4 but the rows are not on 16 bytes, so the kernel
            # takes its 4-byte copies, with the same bits as the 16-byte ones
            views = []
            for x in (a, b):
                buf = torch.empty(x.numel() + 1, device=device)
                views.append(buf[1:].view(shape))
                views[-1].copy_(x)
            out_off = lru_scan(*views)
            torch.cuda.synchronize()
            check(bool(torch.equal(out_off, out)), f"lru_scan {shape} on views at a 4-byte offset differs")
            log(f"lru_scan {shape} on views at a 4-byte offset (4-byte copies): bitwise equal to the aligned launch")
    a, b = timed
    h = torch.empty_like(a)
    ms = time_ms(lambda: lru_scan(a, b))
    bare_ms = time_ms(lambda: _launch_lru_scan_fwd(a, b, h))
    plain_ms = time_ms(lambda: lru_scan_ref(a, b), warmup=1, reps=5)
    # least work: a and b read once, h written once; one FMA an element
    nbytes = 3 * a.numel() * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * a.numel() / FP32_OPS_PER_S * 1e3
    log(f"lru_scan times at {tuple(a.shape)}: wrapper {ms!r} ms, bare launch {bare_ms!r} ms, "
        f"plain {plain_ms!r} ms, bound {max(t_bytes, t_ops)!r} ms ({nbytes} bytes; float32 ops {t_ops!r} ms)")
    del a, b, h, timed
    return {
        "name": "lru_scan_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lru_scan.cu",
        "replaces": "src/repro/kernels/lru_scan.py:42",
        "launches": None,  # filled in from the prefill's run
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # no one PyTorch call computes this recurrence: a cumprod/cumsum
        # rewrite divides by a product that underflows over 32768 steps
        "library_ms": None,
    }


def run_serving_slice(device, profile_run: bool = False) -> int:
    """Phase 7 after the kernel check: full-width parameters, the backends
    per layer, prefill (timed; its B5 launches counted), decode against
    forward in float32, serve. Returns the B5 launches of one prefill."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prefill_step, serve
    from repro_torch.models import decode_step, forward, init_decode_state, init_params, param_count
    from repro_torch.models.rglru import rglru_forward

    cfg = configs.get("recurrentgemma_2b").replace(rglru_backend="pallas")
    n_rglru = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "rglru" for i in range(cfg.num_layers))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    count = param_count(params)
    log(f"serving slice: {cfg.name} full width, {count} parameters ({count * 4} bytes of float32 masters) "
        f"drawn on the card in {time.perf_counter() - t0!r} s; {n_rglru} RG-LRU layers, backend "
        f"{cfg.rglru_backend!r}")
    check(count == 3_549_795_840, f"parameter count {count}")

    # one RG-LRU layer, float32, at the prefill shape: pallas against chunked
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((1, PREFILL_LEN, cfg.d_model), device=device, generator=gen)
    mix = params["blocks"][0]["mix"]
    out_p = rglru_forward(mix, x, cfg.replace(dtype="float32"))
    out_c = rglru_forward(mix, x, cfg.replace(dtype="float32", rglru_backend="chunked"))
    torch.cuda.synchronize()
    torch.testing.assert_close(out_p, out_c, rtol=1e-4, atol=1e-4)
    log(f"serving slice: one RG-LRU layer at {tuple(x.shape)} float32, pallas against chunked: "
        f"max_abs_err={_max_abs_err(out_p, out_c)!r} (max |y| {float(out_c.abs().max())!r})")
    del x, out_p, out_c

    # prefill: a warm call, then the timed one; counts around each call
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), device=device, generator=gen)
    launches = []
    for run in ("warm", "timed"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = prefill_step(params, tokens, cfg)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        launches.append(counts["lru_scan_fwd"])
        row = dict(run=run, batch=1, seq=PREFILL_LEN, wall_s=wall_s, tokens_per_s=PREFILL_LEN / wall_s,
                   peak_device_bytes=torch.cuda.max_memory_allocated(device), launches=counts)
        log("prefill " + json.dumps(row))
        check(counts["lru_scan_fwd"] == n_rglru,
              f"prefill launched lru_scan_fwd {counts['lru_scan_fwd']} times, not {n_rglru}")
        check(sum(counts.values()) == counts["lru_scan_fwd"], f"prefill launched other kernels: {counts}")
        check(tuple(logits.shape) == (1, cfg.vocab_size) and logits.dtype == torch.float32,
              f"prefill logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
    log(f"prefill: next token {int(torch.argmax(logits))}, logits in "
        f"[{float(logits.min())!r}, {float(logits.max())!r}]")
    if profile_run:
        profile_call("prefill 1 x 32768", lambda: prefill_step(params, tokens, cfg))
    del tokens, logits

    # decode against forward, float32, over a 128-token prompt
    cfg32 = cfg.replace(dtype="float32")
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), device=device, generator=gen)
    with torch.no_grad():
        ref, _ = forward(params, prompt, cfg32)
        state = init_decode_state(cfg32, 1, prompt.shape[1], dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        outs = []
        for i in range(prompt.shape[1]):
            lg, state = decode_step(params, state, prompt[:, i:i + 1], i, cfg32)
            outs.append(lg)
        dec = torch.cat(outs, dim=1)
        torch.cuda.synchronize()
    torch.testing.assert_close(dec, ref, **DECODE_TOL)
    log(f"decode against forward, float32, 128 tokens: max_abs_err={_max_abs_err(dec, ref)!r} "
        f"(max |logit| {float(ref.abs().max())!r}), {(time.perf_counter() - t0) / prompt.shape[1] * 1e3!r} ms a step")
    del ref, state, outs, dec, lg

    # serve 8 requests in bf16: decode only, so no B5 launch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    seqs = serve(cfg, batch=8, prompt_len=32, gen=32, seed=0, device=device, params=params)
    wall_s = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    log("serve " + json.dumps(dict(batch=8, prompt_len=32, gen=32, wall_s=wall_s,
                                   tokens_per_s=seqs.size / wall_s, ms_per_step=wall_s / 63 * 1e3,
                                   peak_device_bytes=torch.cuda.max_memory_allocated(device),
                                   launches=counts)))
    check(seqs.shape == (8, 64) and bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()), "served tokens")
    check(counts["lru_scan_fwd"] == 0, f"decode launched lru_scan_fwd {counts['lru_scan_fwd']} times")
    if profile_run:
        # one warm serving decode step (batch 8, bf16, cache of 64 slots)
        state = init_decode_state(cfg, 8, 64, device=device)
        step_tokens = torch.as_tensor(seqs[:, :1], device=device)
        with torch.no_grad():
            decode_step(params, state, step_tokens, 0, cfg)
            profile_call("decode step, batch 8", lambda: decode_step(params, state, step_tokens, 1, cfg))
        del state
    del params
    torch.cuda.empty_cache()
    return launches[-1]


# --------------------------------------------------------------------------
# Phase 8: the RecurrentGemma-2B training slice at full width
# --------------------------------------------------------------------------


def host_us(fn, reps: int = 200) -> float:
    """Median host microseconds of one ``fn()`` issued back to back (no
    sync inside a run of ``reps``, so the card's work overlaps; 5 runs)."""
    import torch

    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        runs.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def lru_occupancy(backward: bool, shape) -> str:
    """The chunk, the chunks, the blocks (warps) of a launch at ``shape`` and
    how many of them an SM holds at once (the runtime's occupancy
    calculator), with the dynamic shared memory of a block."""
    from repro_torch.kernels.library import load

    bsz, seq, width = shape
    chunk = (load().lru_scan_bwd_chunk if backward else load().lru_scan_chunk)(*shape)
    chunks = -(-seq // chunk)
    return (f"chunks of {chunk} ({chunks} of them, {bsz * -(-width // 32) * chunks} one-warp blocks), "
            f"{2 * chunk * 32 * 4} bytes of dynamic shared memory a block, "
            f"{load().lru_scan_blocks_per_sm(int(backward), chunk)} blocks an SM")


def check_lru_scan_bwd_kernel(device) -> dict:
    """B6 against its plain version at the training shape, the prefill
    shape and the reference test shapes (a, b as phase 7 draws them, the
    cotangent g from N(0, 1), h from B5): the gradients through the
    autograd path (B5 forward, B6 backward) against `lru_scan_bwd_ref` on
    the same h; two launches bitwise equal; at every shape the times of the
    wrapper (``torch.autograd.grad`` through `ops.lru_scan`, as the train
    step reaches it: allocation and launch), the bare launch (CUDA events
    and the profiler's device time) and the plain version, and the bytes
    bound (a, h and g read once, da and db written once); the kernel's
    registers (ptxas), shared memory and blocks an SM. At the training shape,
    where the wrapper's host time goes: ``torch.autograd.grad`` alone, the
    allocation of da and db, ``g.contiguous()``, the chunk rule and scratch,
    and the bare launch, each issued back to back on the host clock.
    Returns the entry at the training shape."""
    import torch

    from repro_torch.kernels.lru_scan import _chunk_scratch, _launch_lru_scan_bwd, _launch_lru_scan_fwd
    from repro_torch.kernels.ops import lru_scan
    from repro_torch.kernels.ref import lru_scan_bwd_ref

    log_ptxas("lru_chunk_bwd")
    errs = []
    rows = {}
    for shape in LRU_BWD_SHAPES:
        gen = torch.Generator(device=device).manual_seed(sum(shape) + 1)
        a = (0.7 + 0.299 * torch.rand(shape, device=device, generator=gen)).requires_grad_()
        b = (0.1 * torch.randn(shape, device=device, generator=gen)).requires_grad_()
        g = torch.randn(shape, device=device, generator=gen)
        h = lru_scan(a, b)
        da, db = torch.autograd.grad(h, (a, b), g, retain_graph=True)
        da2, db2 = torch.autograd.grad(h, (a, b), g, retain_graph=True)
        da_r, db_r = lru_scan_bwd_ref(a.detach(), h.detach(), g)
        torch.cuda.synchronize()
        check(bool(torch.equal(da, da2)) and bool(torch.equal(db, db2)), f"lru_scan_bwd {shape}: two launches differ")
        check(bool(torch.isfinite(da).all()) and bool(torch.isfinite(db).all()), f"lru_scan_bwd {shape}: non-finite")
        torch.testing.assert_close(db, db_r, **LRU_GRAD_TOL)
        torch.testing.assert_close(da, da_r, **LRU_GRAD_TOL)
        err = max(_max_abs_err(da, da_r), _max_abs_err(db, db_r))
        errs.append(err)
        ad, hd = a.detach(), h.detach()
        bufs = torch.empty_like(ad), torch.empty_like(ad)
        small = shape[1] * shape[2] < (1 << 20)

        def bare():
            _launch_lru_scan_bwd(ad, hd, g, *bufs)

        ms = time_ms(lambda: torch.autograd.grad(h, (a, b), g, retain_graph=True))
        bare_ms = time_ms(bare)
        dev_ms = device_ms(bare)
        plain_ms = time_ms(lambda: lru_scan_bwd_ref(ad, hd, g), warmup=1, reps=20 if small else 5)
        fwd_ms = time_ms(lambda: _launch_lru_scan_fwd(ad, b.detach(), bufs[0]))  # B5 at this shape, for its row
        nbytes = 5 * ad.numel() * 4
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 3 * ad.numel() / FP32_OPS_PER_S * 1e3
        rows[shape] = dict(ms=ms, bare_ms=bare_ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"lru_scan_bwd {shape}: max_abs_err={err!r} (max |da| {float(da_r.abs().max())!r}, max |db| "
            f"{float(db_r.abs().max())!r}), two launches bitwise equal; wrapper {ms!r} ms, bare launch "
            f"{bare_ms!r} ms, device {dev_ms!r} ms (profiler), plain {plain_ms!r} ms, bound "
            f"{max(t_bytes, t_ops)!r} ms ({nbytes} bytes; float32 ops {t_ops!r} ms), device share of bound "
            f"{(max(t_bytes, t_ops) / dev_ms if dev_ms else float('nan'))!r}; {lru_occupancy(True, shape)}; "
            f"B5's bare launch at this shape {fwd_ms!r} ms")
        if shape == (1, TRAIN_SEQ, 2560):
            parts = {
                "torch.autograd.grad": host_us(lambda: torch.autograd.grad(h, (a, b), g, retain_graph=True)),
                "empty_like x2 (da, db)": host_us(lambda: (torch.empty_like(ad), torch.empty_like(ad))),
                "g.contiguous()": host_us(lambda: g.contiguous()),
                "chunk rule + scratch": host_us(lambda: _chunk_scratch(ad, backward=True)),
                "bare launch": host_us(bare),
            }
            log(f"lru_scan_bwd {shape} host us a call, issued back to back: {json.dumps(parts)}; the wrapper's "
                f"CUDA-event time {ms * 1e3!r} us against the bare launch's {bare_ms * 1e3!r} us")
        del a, b, g, h, da, db, da2, db2, da_r, db_r, ad, hd, bufs
    torch.cuda.empty_cache()
    main = rows[LRU_BWD_SHAPES[0]]
    return {
        "name": "lru_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lru_scan.cu",
        "replaces": "src/repro/kernels/lru_scan.py:80",
        "launches": None,  # filled in from the training steps
        "max_abs_err": max(errs),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        # as for B5: no one PyTorch call computes the reverse recurrence
        "library_ms": None,
    }


def check_layer_gradients(cfg, device) -> None:
    """One RG-LRU layer at (1, TRAIN_SEQ, d_model) in float32: the gradients
    of every parameter and of the input through ``pallas`` (B5 forward, B6
    backward: one launch each) against ``chunked`` (autograd through the
    doubling scans: no launch)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.rglru import init_rglru, rglru_forward
    from repro_torch.tree import leaves_with_paths, unflatten

    gen = torch.Generator(device=device).manual_seed(2)
    mix = init_rglru(gen, cfg, device)
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), device=device, generator=gen)
    cot = torch.randn(x.shape, device=device, generator=gen)
    names = ["input"] + ["/".join(map(str, path)) for path, _ in leaves_with_paths(mix)]
    grads = {}
    for backend, launches in (("pallas", 1), ("chunked", 0)):
        work = [t.detach().clone().requires_grad_() for _, t in leaves_with_paths(mix)]
        xg = x.clone().requires_grad_()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = rglru_forward(unflatten(mix, work), xg, cfg.replace(dtype="float32", rglru_backend=backend))
        torch.sum(out * cot).backward()
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        check(counts["lru_scan_fwd"] == launches and counts["lru_scan_bwd"] == launches,
              f"one RG-LRU layer, {backend}: launches {counts}")
        grads[backend] = [xg.grad] + [w.grad for w in work]
    worst = 0.0
    for name, gp, gc in zip(names, grads["pallas"], grads["chunked"]):
        rel = _max_abs_err(gp, gc) / max(float(gc.abs().max()), 1e-30)
        worst = max(worst, rel)
        check(rel <= LAYER_GRAD_RTOL, f"one RG-LRU layer's gradient of {name}: pallas against chunked "
                                      f"differs by {rel!r} of its largest entry")
    log(f"training slice: one RG-LRU layer at {tuple(x.shape)} float32, gradients of the input and "
        f"{len(names) - 1} parameters, pallas (B5 + B6) against chunked: largest difference {worst!r} of the "
        f"gradient's largest entry (held at {LAYER_GRAD_RTOL})")


def run_training_slice(device, profile_run: bool = False) -> int:
    """Phase 8 after the kernel check: one layer's gradients, then three
    full-width train steps (counts around each) and the determinism check.
    Returns the B6 launches of the three steps."""
    import torch

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.optim import global_norm
    from repro_torch.train import init_train_state, loss_and_grads, make_train_step
    from repro_torch.tree import leaves, leaves_with_paths

    cfg = configs.get("recurrentgemma_2b").replace(rglru_backend="pallas")
    n_rglru = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "rglru" for i in range(cfg.num_layers))
    check_layer_gradients(cfg, device)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=1, lr=3e-4)
    t0 = time.perf_counter()
    state = init_train_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    state_bytes = sum(t.numel() * t.element_size() for tree in (state.params, state.opt.m, state.opt.v)
                      for t in leaves(tree))
    log(f"training slice: {cfg.name} full width and depth, params + AdamW moments {state_bytes} bytes "
        f"(float32) drawn on the card in {time.perf_counter() - t0!r} s; {n_rglru} RG-LRU layers, backend "
        f"{cfg.rglru_backend!r}, compute {cfg.dtype}, batch 1 x {TRAIN_SEQ}, lr {tcfg.lr} "
        f"(warmup {tcfg.warmup_steps} steps)")
    step_fn = make_train_step(cfg, tcfg)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, 1, seed=tcfg.seed)
    watched = [("/".join(map(str, path)), leaf, leaf.reshape(-1)[:4096].clone())
               for path, leaf in leaves_with_paths(state.params)]
    total_bwd = 0
    rows = []
    for i in range(3):
        batch = {"tokens": torch.as_tensor(pipe.batch(i), dtype=torch.int64, device=device)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        total_bwd += counts["lru_scan_bwd"]
        m = {k: float(v) for k, v in metrics.items()}
        row = dict(step=i, batch=1, seq=TRAIN_SEQ, wall_s=wall_s, tokens_per_s=TRAIN_SEQ / wall_s,
                   peak_device_bytes=torch.cuda.max_memory_allocated(device), launches=counts, **m)
        rows.append(row)
        log("train step " + json.dumps(row))
        check(counts["lru_scan_fwd"] == n_rglru and counts["lru_scan_bwd"] == n_rglru,
              f"train step {i}: launches {counts}, not {n_rglru} lru_scan_fwd and {n_rglru} lru_scan_bwd")
        check(sum(counts.values()) == 2 * n_rglru, f"train step {i} launched other kernels: {counts}")
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]), f"train step {i}: non-finite {m}")
        moved = [name for name, leaf, before in watched if not torch.equal(leaf.reshape(-1)[:4096], before)]
        if i == 0:
            check(m["lr"] == 0.0 and not moved, f"step 0 (lr {m['lr']}) moved {moved[:5]}")
        elif i == 1:
            check(m["lr"] > 0.0 and len(moved) == len(watched),
                  f"step 1 (lr {m['lr']}) left {len(watched) - len(moved)} parameters unmoved")
            log(f"training slice: step 1 (lr {m['lr']!r}) moved all {len(watched)} parameters")
        for _, leaf, before in watched:
            before.copy_(leaf.reshape(-1)[:4096])
    warm = rows[-1]
    log(f"training slice: warm step {warm['wall_s']!r} s, {warm['tokens_per_s']!r} tokens/s, peak device "
        f"memory {max(r['peak_device_bytes'] for r in rows)} bytes over the three steps")
    del watched

    # determinism: one step's loss and gradients twice from the same state;
    # the first run also records the layout of the cotangent each B6 call gets
    batch = {"tokens": torch.as_tensor(pipe.batch(3), dtype=torch.int64, device=device)}
    names = ["/".join(map(str, path)) for path, _ in leaves_with_paths(state.params)]
    runs = []
    backward = ops._LruScan.backward
    cotangents = []

    def recording_backward(ctx, g):
        cotangents.append((tuple(g.shape), tuple(g.stride()), g.is_contiguous()))
        return backward(ctx, g)

    for i in range(2):
        if i == 0:
            ops._LruScan.backward = staticmethod(recording_backward)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads, metrics = loss_and_grads(state.params, batch, cfg, tcfg.z_loss)
            torch.cuda.synchronize()
            fwd_bwd_s = time.perf_counter() - t0
        finally:
            ops._LruScan.backward = backward
        sums = torch.stack([torch.stack([torch.sum(g.float()), torch.sum(torch.square(g.float()))]) for g in grads])
        runs.append((metrics["loss"], global_norm(grads), sums))
        del grads, metrics
    log(f"training slice: the {len(cotangents)} B6 calls of a backward got cotangents "
        f"{sorted(set(cotangents))}: {sum(not c[2] for c in cotangents)} not contiguous (those are copied "
        f"by g.contiguous() before the launch)")
    check(len(cotangents) == n_rglru, f"{len(cotangents)} B6 calls in one backward, not {n_rglru}")
    log(f"training slice: forward and backward alone (loss_and_grads, the step without clipping and "
        f"AdamW) {fwd_bwd_s!r} s, against the warm step's {warm['wall_s']!r} s")
    (loss1, gn1, s1), (loss2, gn2, s2) = runs
    differ = [names[j] for j in range(len(names)) if not torch.equal(s1[j], s2[j])]
    same = bool(torch.equal(loss1, loss2)) and bool(torch.equal(gn1, gn2)) and not differ
    log(f"training slice determinism: loss {float(loss1)!r} / {float(loss2)!r}, grad norm {float(gn1)!r} / "
        f"{float(gn2)!r}; " + ("bitwise equal, loss, norm and every gradient leaf's sum and sum of squares"
                               if same else f"NOT bitwise equal; gradient leaves that differ: {differ}"))
    check(math.isfinite(float(loss1)) and math.isfinite(float(gn1)), "determinism run: non-finite")
    per = step_kernel_us(lambda: step_fn(state, batch), ("lru_chunk_bwd", "lru_chunk_onepass"))
    log(f"training slice: one warm step under the profiler (CUDA activity only): B6 (lru_chunk_bwd) "
        f"{per['lru_chunk_bwd'][0]} launches, {per['lru_chunk_bwd'][1]!r} us of device time a launch; B5 "
        f"(lru_chunk_onepass) {per['lru_chunk_onepass'][0]} launches, {per['lru_chunk_onepass'][1]!r} us a launch")
    check(per["lru_chunk_bwd"][0] == n_rglru, f"the profiled step ran {per['lru_chunk_bwd'][0]} B6 kernels")
    if profile_run:
        profile_call(f"train step 1 x {TRAIN_SEQ}", lambda: step_fn(state, batch))
    del state, runs, s1, s2
    torch.cuda.empty_cache()
    return total_bwd


def step_kernel_us(fn, markers) -> dict[str, tuple[int, float]]:
    """Run ``fn()`` once under `torch.profiler` (CUDA activity only) and
    return, for each marker, the number of kernels whose name holds it and
    their mean device microseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = {m: [] for m in markers}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for m in markers:
                if m in e.name:
                    found[m].append(e.time_range.elapsed_us())
    return {m: (len(us), sum(us) / max(len(us), 1)) for m, us in found.items()}


# --------------------------------------------------------------------------
# Phase 12: the dense and MoE LM families (OLMoE-1B-7B at full width)
# --------------------------------------------------------------------------

#: jax.eval_shape of the reference's init_params: OLMoE-1B-7B, and
#: Gemma3-12B cut to its first global period (5 local layers, 1 global)
OLMOE_PARAM_COUNT = 6_919_100_416
GEMMA3_PERIOD_PARAM_COUNT = 3_358_117_632
MOE_ROUTERS = ("softmax", "sinkhorn", "spar_sink")
#: one full-width MoE layer, card against CPU, both float32 (no TF32): the
#: router's exponent is scores / router_eps = 20 x scores, products of 2048
#: terms summed in another order on each device (about 1e-6 apart), so a
#: gate can move by about 1e-4 of itself, and a token's output, sum_e w_e
#: y_e with |y_e| about 1, by about 1e-4 (also where the sum cancels)
MOE_LAYER_TOKENS = 2048
MOE_PROBS_TOL = dict(rtol=1e-3, atol=1e-6)
MOE_OUT_TOL = dict(rtol=1e-3, atol=1e-4)
GEMMA3_DECODE_LEN = 1280  # decode against forward past the local layers' 1024 window
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 32, 32


class RouterUniforms:
    """Within the block, the spar_sink router draws ``u`` (moved to the
    data's device) instead of its generator's uniforms."""

    def __init__(self, u):
        self.u = u

    def __enter__(self):
        from repro_torch.models import moe

        self.orig = moe._uniforms

        def given(shape, generator, device):
            check(tuple(shape) == tuple(self.u.shape), f"router draw of {tuple(shape)}, not {tuple(self.u.shape)}")
            return self.u.to(device)

        moe._uniforms = given
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._uniforms = self.orig


def moe_layer_on(layer, x, cfg, u) -> dict:
    """One MoE layer (``layer``'s parameters, on ``x``'s device) on ``x``
    with the spar_sink draws ``u``: its router probabilities, the sorted
    top-k choices, the (B, S, E) kept map, the spar_sink sketch's keep
    mask, the output and the wall seconds of `moe_ffn`."""
    import torch

    from repro_torch.models import moe

    s = x.shape[1]
    cap = max(1, int(cfg.capacity_factor * cfg.experts_per_token * s / cfg.num_experts))
    with torch.no_grad(), RouterUniforms(u):
        probs = moe._router_probs(layer, x, cfg, None)
        topk_idx, _, keep_idx = moe._route(probs, cfg, cap)
        kept = torch.zeros((x.shape[0], cfg.num_experts, s), device=x.device).scatter_(2, keep_idx, 1.0) > 0
        scores = (x @ layer["router"]["w"]).float()
        sketch = moe._spar_sink_log_kernel((scores - scores.amax(-1, keepdim=True)) / cfg.router_eps, cfg,
                                           u.to(x.device))
        if x.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux = moe.moe_ffn(layer, x, cfg)
        if x.device.type == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return dict(probs=probs.cpu(), topk=torch.sort(topk_idx, -1).values.cpu(), kept=kept.transpose(1, 2).cpu(),
                keep_mask=(sketch > -1e30).cpu(), out=out.cpu(), aux=float(aux), wall_s=wall_s)


def full_width_moe_layer(params, cfg, device) -> None:
    """Phase 12 (2): layer 0's ``moe_ffn`` at full width on (1, 2048, 2048)
    float32, card against CPU, each router, the same parameters and (for
    spar_sink) the same uniforms drawn on the CPU. A token whose top-k
    choice, kept slots or sketch row differ between the devices (a flip on
    a near-tie) is counted and left out; the others are held."""
    import torch

    from repro_torch.tree import tree_map

    layer = params["blocks"][0]["ffn"]
    host_layer = tree_map(lambda t: t.cpu(), layer)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, MOE_LAYER_TOKENS, cfg.d_model), generator=gen)
    u = torch.rand((1, MOE_LAYER_TOKENS, cfg.num_experts), generator=gen)
    for router in MOE_ROUTERS:
        c = cfg.replace(router=router, dtype="float32")
        card = moe_layer_on(layer, x.to(device), c, u)
        host = moe_layer_on(host_layer, x, c, u)
        touched = (card["topk"] != host["topk"]).any(-1) | (card["kept"] != host["kept"]).any(-1)
        if router == "spar_sink":
            touched |= (card["keep_mask"] != host["keep_mask"]).any(-1)
        held = ~touched
        torch.testing.assert_close(card["probs"][held], host["probs"][held], **MOE_PROBS_TOL)
        torch.testing.assert_close(card["out"][held], host["out"][held], **MOE_OUT_TOL)
        row = dict(router=router, shape=list(x.shape), touched_tokens=int(touched.sum()),
                   probs_max_abs_err=_max_abs_err(card["probs"][held], host["probs"][held]),
                   out_max_abs_err=_max_abs_err(card["out"][held], host["out"][held]),
                   max_abs_out=float(host["out"].abs().max()), aux_card=card["aux"], aux_cpu=host["aux"],
                   kept_entries=int(card["keep_mask"].sum()) if router == "spar_sink" else None,
                   card_wall_s=card["wall_s"], cpu_wall_s=host["wall_s"])
        log("phase 12 moe layer " + json.dumps(row))
        check(int(touched.sum()) <= MOE_LAYER_TOKENS // 100, f"phase 12 moe layer {router}: {int(touched.sum())} "
              f"tokens routed otherwise on the card")
    del host_layer


def check_stable_top_k(device) -> None:
    """Phase 12: `moe._top_k` on the card puts the lower index first among
    ties, as on the CPU (and as ``jax.lax.top_k``): 600 entries of 0.125
    among 4096 zeros, and gates of the prefill's shape (1, 64, 32768) with
    most entries exactly 0."""
    import torch

    from repro_torch.models import moe

    gen = torch.Generator().manual_seed(4)
    x = torch.zeros(4096)
    x[torch.randperm(4096, generator=gen)[:600]] = 0.125
    gates = torch.where(torch.rand((1, 64, PREFILL_LEN), generator=gen) < 0.1, 0.125, 0.0)
    for label, t, k in (("4096 entries", x, 1024), ("gates (1, 64, 32768)", gates, 5120)):
        card_v, card_i = moe._top_k(t.to(device), k)
        host_v, host_i = moe._top_k(t, k)
        check(torch.equal(card_i.cpu(), host_i) and torch.equal(card_v.cpu(), host_v),
              f"phase 12: the stable top-k on the card differs from the CPU's on {label}")
    log("phase 12: the stable top-k keeps the lower index first among ties on the card, as on the CPU")


def olmoe_prefill(params, cfg, device, tokens) -> dict:
    """Phase 12 (3): ``prefill_step`` on 1 x PREFILL_LEN tokens for each
    router, a warm call and a timed one, counts set to 0 just before each
    and read just after (no hand kernel may run), logits finite and the
    repeat bitwise equal; and the router alone at (1, PREFILL_LEN, E)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prefill_step
    from repro_torch.models import moe

    walls = {}
    for router in MOE_ROUTERS:
        c = cfg.replace(router=router)
        outs = []
        for run in ("warm", "timed"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits = prefill_step(params, tokens, c)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = {k: v for k, v in ops.LAUNCHES.items() if v}
            log("phase 12 prefill " + json.dumps(dict(
                arch=cfg.name, router=router, run=run, batch=1, seq=tokens.shape[1], wall_s=wall_s,
                tokens_per_s=tokens.shape[1] / wall_s, peak_device_bytes=torch.cuda.max_memory_allocated(device),
                launches=counts)))
            check(not counts, f"phase 12 prefill {router}: hand kernels launched {counts}")
            check(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
                  f"phase 12 prefill {router}: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
            outs.append(logits)
        check(torch.equal(outs[0], outs[1]), f"phase 12 prefill {router}: a repeat is not bitwise equal")
        walls[router] = wall_s
        gen = torch.Generator(device=device).manual_seed(5)
        scores = torch.randn((1, tokens.shape[1], cfg.num_experts), device=device, generator=gen)
        if router == "softmax":
            router_ms = time_ms(lambda: torch.softmax(scores, dim=-1), warmup=2, reps=10)
        else:
            router_ms = time_ms(lambda: moe.sinkhorn_router_probs(scores, c, None), warmup=2, reps=10)
        log(f"phase 12 prefill {router}: next token {int(torch.argmax(outs[1]))}, logits in "
            f"[{float(outs[1].min())!r}, {float(outs[1].max())!r}], bitwise equal on the repeat; the router alone "
            f"at {tuple(scores.shape)}: {router_ms!r} ms, {cfg.num_layers} layers "
            f"{cfg.num_layers * router_ms / 1e3 / wall_s!r} of the timed prefill")
        del outs, logits, scores
    return walls


def olmoe_serve(params, cfg, device) -> None:
    """Phase 12 (4): ``serve`` at batch 8, 32 prompt and 32 generated
    tokens (bf16), with the sinkhorn and spar_sink routers."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    for router in ("sinkhorn", "spar_sink"):
        c = cfg.replace(router=router)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        seqs = serve(c, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN, seed=0, device=device,
                     params=params)
        wall_s = time.perf_counter() - t0
        counts = {k: v for k, v in ops.LAUNCHES.items() if v}
        steps = SERVE_PROMPT + SERVE_GEN - 1
        log("phase 12 serve " + json.dumps(dict(
            arch=cfg.name, router=router, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN, wall_s=wall_s,
            tokens_per_s=seqs.size / wall_s, ms_per_step=wall_s / steps * 1e3,
            peak_device_bytes=torch.cuda.max_memory_allocated(device), launches=counts)))
        check(seqs.shape == (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN)
              and bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()), f"phase 12 serve {router}: served tokens")
        check(not counts, f"phase 12 serve {router}: hand kernels launched {counts}")


def gemma3_period(device) -> None:
    """Phase 12 (5): Gemma3-12B cut to its first global period at full
    width, float32: decode against forward over GEMMA3_DECODE_LEN tokens."""
    import torch

    from repro_torch import configs
    from repro_torch.models import decode_step, forward, init_decode_state, init_params, layer_windows, param_count

    cfg = configs.get("gemma3_12b").replace(num_layers=6, dtype="float32")
    check(layer_windows(cfg) == [cfg.sliding_window] * 5 + [0], f"gemma3 windows {layer_windows(cfg)}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    count = param_count(params)
    log(f"phase 12: {cfg.name} cut to 6 layers (windows {layer_windows(cfg)}), {count} float32 parameters "
        f"({count * 4} bytes) drawn on the card in {time.perf_counter() - t0!r} s")
    check(count == GEMMA3_PERIOD_PARAM_COUNT, f"gemma3 6-layer parameter count {count}")
    gen = torch.Generator(device=device).manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (1, GEMMA3_DECODE_LEN), device=device, generator=gen)
    with torch.no_grad():
        ref, _ = forward(params, prompt, cfg)
        state = init_decode_state(cfg, 1, GEMMA3_DECODE_LEN, dtype=torch.float32, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for i in range(GEMMA3_DECODE_LEN):
            lg, state = decode_step(params, state, prompt[:, i:i + 1], i, cfg)
            outs.append(lg)
        dec = torch.cat(outs, dim=1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / GEMMA3_DECODE_LEN * 1e3
    torch.testing.assert_close(dec, ref, **DECODE_TOL)
    w = cfg.sliding_window
    log(f"phase 12: gemma3 decode against forward, float32, {GEMMA3_DECODE_LEN} tokens: max_abs_err "
        f"{_max_abs_err(dec, ref)!r} (max |logit| {float(ref.abs().max())!r}); past the window (positions >= {w}) "
        f"{_max_abs_err(dec[:, w:], ref[:, w:])!r}; {step_ms!r} ms a step")
    del params, state, ref, dec, outs


def run_lm_families_phase(device) -> None:
    """Phase 12, after phase 8 has freed its state: OLMoE-1B-7B at full
    width and depth (random float32 masters drawn on the card), its MoE
    layer card against CPU, prefill and serve per router; then Gemma3's
    first global period."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.serve import prefill_step
    from repro_torch.models import decode_step, init_decode_state, init_params, param_count

    t_phase = time.perf_counter()
    check_stable_top_k(device)
    cfg = configs.get("olmoe_1b_7b")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    count = param_count(params)
    log(f"phase 12: {cfg.name} full width and depth ({cfg.num_layers} layers, {cfg.num_experts} experts top-"
        f"{cfg.experts_per_token}, router {cfg.router!r}), {count} float32 parameters ({count * 4} bytes) drawn on "
        f"the card in {time.perf_counter() - t0!r} s")
    check(count == OLMOE_PARAM_COUNT, f"olmoe parameter count {count}")
    full_width_moe_layer(params, cfg, device)
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), device=device,
                           generator=torch.Generator(device=device).manual_seed(7))
    olmoe_prefill(params, cfg, device, tokens)
    profile_call(f"olmoe prefill 1 x {PREFILL_LEN} (sinkhorn)", lambda: prefill_step(params, tokens, cfg))
    del tokens
    torch.cuda.empty_cache()
    olmoe_serve(params, cfg, device)
    state = init_decode_state(cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, device=device)
    step_tokens = torch.zeros((SERVE_BATCH, 1), dtype=torch.int64, device=device)
    with torch.no_grad():
        decode_step(params, state, step_tokens, 0, cfg)
        profile_call(f"olmoe decode step, batch {SERVE_BATCH}", lambda: decode_step(params, state, step_tokens, 1, cfg))
    del params, state
    torch.cuda.empty_cache()
    gemma3_period(device)
    torch.cuda.empty_cache()
    log(f"phase 12 {time.perf_counter() - t_phase!r} s")


# --------------------------------------------------------------------------
# Phase 13: the paper's applications (examples_torch/), no hand kernel
# --------------------------------------------------------------------------

#: Table 1 at EchoNet-Dynamic's frame size: bench_echo's --full recipe
#: (30 frames, period 10 + 2 (v mod 3), arrhythmia 0.2 on odd v, eps 0.01,
#: lam 0.5, eta 0.1, s = 16 s0(n), 2 sketch seeds a distance) at stride 1;
#: panel (a) n = 12544, panel (b) 2 x 2 mean-pooled, n = 3136
ECHO_SIZE, ECHO_S_MULT = 112, 16
TABLE1_VIDEOS = {"orig": 3, "pooled": 10}
#: the band of tests/test_system.py::test_spar_sink_wfr_matches_dense_wfr
ECHO_BAND, ECHO_BAND_SEEDS, ECHO_CPU_RTOL = 0.25, 8, 1e-10
#: the cardiac-cycle matrix: one subject's first frames at 112 x 112
MDS_FRAMES, MDS_STRIDE = 12, 1
#: the examples run at their reference defaults
EXAMPLE_DEFAULTS = ("quickstart", "color_transfer", "barycenter", "batch_serving", "ssae")
MOE_STEPS = 30


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module (the folder is no package)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, argv: list[str]):
    """Run one example's ``main(argv)`` on the card, its output echoed and
    kept: ``(result, printed text, synced seconds)``."""
    import contextlib
    import io

    import torch

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = load_example(name).main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"phase 13 {name}| {line}")
    return result, buf.getvalue(), seconds


def table1_panel(echo, panel: str, method: str, device) -> dict:
    """One method on one panel of Table 1: a `Prediction` a video, timed
    (synced) and with the panel's peak device memory. A solve that ends
    ``non_finite`` is printed and diagnosed (`diagnose_non_finite`); a
    distance that is not finite passes only where C-11 explains each of
    its ``non_finite`` solves, and its video's prediction counts as failed
    (``videos_failed``), its error left out of the mean."""
    import collections

    import torch

    pooled = panel == "pooled"
    preds, video_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for v in range(TABLE1_VIDEOS[panel]):
        video, t_es, t_ed = echo.table1_video(v, ECHO_SIZE, pooled)
        t0 = time.perf_counter()
        preds.append(echo.predict_ed(video, t_es, t_ed, method, (0, v), 1, ECHO_S_MULT, device=device))
        torch.cuda.synchronize()
        video_s.append(time.perf_counter() - t0)
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(device)
    solves = [(v, t, i, n_iter, st) for v, p in enumerate(preds) for t, rep in p.solves.items()
              for i, (n_iter, st) in enumerate(rep)]
    iters = [n_iter for *_, n_iter, _ in solves]
    statuses = collections.Counter(st for *_, st in solves)
    dists = [d for p in preds for d in p.dists.values()]
    dist_s = [sec for p in preds for sec in p.seconds.values()]
    errors = [p.error for p in preds if p.t_hat is not None]
    n = (ECHO_SIZE // (2 if pooled else 1)) ** 2
    row = dict(panel=panel, method=method, n=n, s=ECHO_S_MULT * echo.s0(n), videos=len(preds),
               videos_failed=[v for v, p in enumerate(preds) if p.t_hat is None],
               error_mean=statistics.fmean(errors) if errors else None,
               error_std=statistics.pstdev(errors) if errors else None, errors=errors,
               t_hat=[p.t_hat for p in preds], s_per_video=statistics.fmean(video_s),
               s_per_distance=statistics.fmean(dist_s), distances=len(dists),
               non_finite_distances=sum(not math.isfinite(d) for d in dists),
               n_iter_mean=statistics.fmean(iters), n_iter_min=min(iters), n_iter_max=max(iters),
               statuses=dict(statuses), peak_device_bytes=peak)
    log("phase 13 table1 " + json.dumps(row))
    explained = set()
    for v, t, i, n_iter, st in solves:
        if st == "non_finite":
            log(f"phase 13 table1 {panel} {method}: finding: video {v}, frame {t}, seed {i} ended non_finite "
                f"at iteration {n_iter}")
            if diagnose_non_finite(echo, pooled, v, t, i, n_iter, method, device):
                explained.add((v, t))
    for v, p in enumerate(preds):
        for t, d in p.dists.items():
            check(math.isfinite(d) or (v, t) in explained,
                  f"phase 13 table1 {panel} {method}: video {v}, frame {t}: distance {d} is not finite "
                  f"and C-11 does not explain it")
    return dict(row, preds=preds)


def diagnose_non_finite(echo, pooled: bool, v: int, t: int, i: int, n_iter: int, method: str, device) -> bool:
    """Draw one Table-1 sketch again on the card (video ``v``'s ES frame
    against frame ``t``, seed ``i``), count its denormal values, and run
    its loop on the CPU on a copy, once with denormals kept (as torch keeps
    them on the CPU and the card) and once flushed (as the reference's CPU
    runs flush them). C-11 explains the solve when the card's run of the
    sketch reproduces it (``non_finite`` at iteration ``n_iter``), the
    kept run ends ``non_finite`` and the flushed one does not."""
    import torch

    from repro_torch.core import Geometry, UOTProblem, uniform_probs
    from repro_torch.core.api import solvers as api_solvers

    video, t_es, _ = echo.table1_video(v, ECHO_SIZE, pooled)
    a, pts = echo.frame_measure(video[t_es], 1, device)
    b, _ = echo.frame_measure(video[t], 1, device)
    C = echo.wfr_cost(torch.as_tensor(pts, device=device), eta=echo.ETA)
    n = pts.shape[0]
    s = ECHO_S_MULT * echo.s0(n)
    problem = UOTProblem(Geometry(C), a, b, echo.EPS, lam=echo.LAM)
    probs = uniform_probs(n, n, C.dtype, device=device) if method == "rand_sink" else None
    sk = api_solvers.build_coo_sketch(problem, echo.generator(device, 0, v, t, i), s, probs=probs)
    card = api_solvers._spar_sink_coo_on(problem, sk, 1e-7, 2000)
    tiny = torch.finfo(sk.vals.dtype).tiny
    denormal = int(((sk.vals != 0) & (sk.vals.abs() < tiny)).sum())
    cpu_problem = UOTProblem(Geometry(C.cpu()), a.cpu(), b.cpu(), echo.EPS, lam=echo.LAM)
    cpu_sk = sk._replace(**{f: getattr(sk, f).cpu() for f in sk._fields if isinstance(getattr(sk, f), torch.Tensor)})
    del problem, C, probs, sk
    torch.cuda.empty_cache()
    runs = {}
    for flush in (False, True):
        torch.set_flush_denormal(flush)
        try:
            sol = api_solvers._spar_sink_coo_on(cpu_problem, cpu_sk, 1e-7, 2000)
        finally:
            torch.set_flush_denormal(False)
        runs["flushed" if flush else "kept"] = (sol.status_label, int(sol.n_iter), float(sol.value))
    reproduced = card.status_label == "non_finite" and int(card.n_iter) == n_iter
    explained = reproduced and runs["kept"][0] == "non_finite" and runs["flushed"][0] != "non_finite"
    log("phase 13 non_finite diagnosis " + json.dumps(dict(
        video=v, pooled=pooled, frame=t, seed=i, method=method, nnz=int(cpu_sk.nnz), denormal_values=denormal,
        card=(card.status_label, int(card.n_iter), float(card.value)), reproduced=reproduced, cpu=runs,
        c11_explains=explained)))
    return explained


def table1_checks(echo, device, first_video: dict) -> None:
    """Phase 13 (1)'s checks beside the table: the first video's sinkhorn
    distances repeat bitwise; one panel-(b) sinkhorn distance on the CPU
    in float64 against the card's; that pair's spar_sink mean over
    `ECHO_BAND_SEEDS` seeds within `ECHO_BAND` of it."""
    import torch

    video, t_es, t_ed = echo.table1_video(0, ECHO_SIZE)
    again = echo.predict_ed(video, t_es, t_ed, "sinkhorn", (0, 0), 1, ECHO_S_MULT, device=device)
    check(again.dists == first_video["orig"].dists,
          "phase 13: the sinkhorn distances of video 0 (n = 12544) do not repeat bitwise")
    log(f"phase 13: video 0's {len(again.dists)} sinkhorn distances at n = 12544 repeat bitwise")
    pred = first_video["pooled"]
    video, t_es, _ = echo.table1_video(0, ECHO_SIZE, pooled=True)
    t = pred.t_hat
    got = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        a, pts = echo.frame_measure(video[t_es], 1, dev)
        b, _ = echo.frame_measure(video[t], 1, dev)
        C = echo.wfr_cost(torch.as_tensor(pts, device=dev), eta=echo.ETA)
        s = ECHO_S_MULT * echo.s0(pts.shape[0])
        t0 = time.perf_counter()
        got[where], solves = echo.echo_distance(a, b, C, "sinkhorn", (0, 0, t), s)
        log(f"phase 13: pooled video 0, frames {t_es} -> {t}, sinkhorn on the {where}: {got[where]!r} "
            f"({solves}, {time.perf_counter() - t0!r} s)")
        if where == "card":
            check(got["card"] == pred.dists[t], "phase 13: the pooled pair's sinkhorn distance did not repeat")
            sparse, solves = echo.echo_distance(a, b, C, "spar_sink", (0, 0, t), s, n_seeds=ECHO_BAND_SEEDS)
            rel_sparse = abs(sparse - got["card"]) / abs(got["card"])
            log(f"phase 13: that pair's spar_sink mean over {ECHO_BAND_SEEDS} seeds {sparse!r}, relative to "
                f"sinkhorn {rel_sparse!r} (statuses {sorted(set(st for _, st in solves))})")
            check(rel_sparse < ECHO_BAND, f"phase 13: spar_sink {rel_sparse} outside the band {ECHO_BAND}")
        del a, b, C
    rel = abs(got["card"] - got["cpu"]) / abs(got["cpu"])
    log(f"phase 13: card against CPU float64, relative {rel!r}")
    check(rel <= ECHO_CPU_RTOL, f"phase 13: the card's sinkhorn distance is {rel} from the CPU's")


def profile_table1(echo, device) -> None:
    """One Table-1 distance of each method at n = 12544 under the profiler
    (video 0's ES frame against its ED frame)."""
    import torch

    video, t_es, t_ed = echo.table1_video(0, ECHO_SIZE)
    a, pts = echo.frame_measure(video[t_es], 1, device)
    b, _ = echo.frame_measure(video[t_ed], 1, device)
    C = echo.wfr_cost(torch.as_tensor(pts, device=device), eta=echo.ETA)
    s = ECHO_S_MULT * echo.s0(pts.shape[0])
    for method in echo.TABLE1_METHODS:
        run = lambda: echo.echo_distance(a, b, C, method, (0, 0, t_ed), s)
        run()
        profile_call(f"table1 distance n={pts.shape[0]} ({method})", run)


def cardiac_cycle_matrix(echo, device) -> None:
    """Phase 13 (2): `wfr_matrix` and `classical_mds` for the healthy
    subject's first `MDS_FRAMES` frames at 112 x 112."""
    import numpy as np
    import torch

    video, t_ed, t_es = echo.synth_echo_video(n_frames=MDS_FRAMES, size=ECHO_SIZE, period=10,
                                              seed=echo.SUBJECT_SEEDS["healthy"], **echo.SUBJECTS["healthy"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    D = echo.wfr_matrix(video, (0, 0), MDS_STRIDE, device)
    wall = time.perf_counter() - t0
    xy = echo.classical_mds(D)
    radius = np.linalg.norm(xy - xy.mean(0), axis=1)
    pairs = MDS_FRAMES * (MDS_FRAMES - 1) // 2
    log("phase 13 cardiac cycle " + json.dumps(dict(
        subject="healthy", frames=MDS_FRAMES, stride=MDS_STRIDE, n=(ECHO_SIZE // MDS_STRIDE) ** 2, ED=t_ed, ES=t_es,
        mean_wfr=float(D[D > 0].mean()), mds_radius_mean=float(radius.mean()), mds_radius_std=float(radius.std()),
        s_per_pair=wall / pairs, seconds=wall, peak_device_bytes=torch.cuda.max_memory_allocated(device))))
    check(bool(np.all(np.isfinite(D))) and np.array_equal(D, D.T), "phase 13: the WFR matrix")


def moe_trainer(device) -> None:
    """Phase 13 (4): the example trainer's full-size config for
    `MOE_STEPS` steps with each router, each in a fresh directory."""
    import tempfile

    import torch

    for router in MOE_ROUTERS:
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.reset_peak_memory_stats(device)
            out, text, seconds = run_example("train_moe_sinkhorn", [
                "--hundred-m", "--steps", str(MOE_STEPS), "--router", router, "--out-dir", tmp])
        history = dict(out["history"])
        tok_s = [float(m) for m in re.findall(r"tok/s ([\d,.]+)", text.replace(",", ""))]
        first, last = history[0]["loss"], history[MOE_STEPS - 1]["loss"]
        log("phase 13 train_moe_sinkhorn " + json.dumps(dict(
            router=router, steps=MOE_STEPS, seq_len=512, batch=8, loss_first=first, loss_last=last,
            loop_tokens_per_s=tok_s[-1], s_per_step_loop=512 * 8 / tok_s[-1], seconds=seconds,
            peak_device_bytes=torch.cuda.max_memory_allocated(device))))
        check(math.isfinite(first) and math.isfinite(last) and last < first,
              f"phase 13 train_moe_sinkhorn {router}: loss {first} -> {last}")
        del out
        torch.cuda.empty_cache()


def run_applications_phase(device) -> None:
    """Phase 13: Table 1 at 112 x 112, the cardiac-cycle matrix, the
    examples at their defaults and the MoE trainer at full size, all on
    torch ops: the launch counts, set to 0 just before, stay 0."""
    import torch

    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    echo = load_example("echocardiogram")
    rows, first_video = [], {}
    for panel in ("orig", "pooled"):
        for method in echo.TABLE1_METHODS:
            row = table1_panel(echo, panel, method, device)
            if method == "sinkhorn":
                first_video[panel] = row["preds"][0]
            rows.append(row)
        by = {r["method"]: r for r in rows if r["panel"] == panel}
        log(f"phase 13 table1 {panel}: spar_sink's speedup over sinkhorn a distance "
            f"{by['sinkhorn']['s_per_distance'] / by['spar_sink']['s_per_distance']!r}, rand_sink's "
            f"{by['sinkhorn']['s_per_distance'] / by['rand_sink']['s_per_distance']!r}")
    table1_checks(echo, device, first_video)
    profile_table1(echo, device)
    torch.cuda.empty_cache()
    log(f"phase 13 Table 1 {time.perf_counter() - t_phase!r} s")
    cardiac_cycle_matrix(echo, device)
    for name in EXAMPLE_DEFAULTS:
        out, text, seconds = run_example(name, [])
        log(f"phase 13 {name}: {seconds!r} s")
        if name == "batch_serving":
            check("bitwise identical: True" in text and out["bitwise"], "phase 13 batch_serving: not bitwise")
        if name == "ssae":
            check(math.isfinite(out["loss"]), f"phase 13 ssae: final loss {out['loss']}")
        torch.cuda.empty_cache()
    moe_trainer(device)
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(not counts, f"phase 13: hand kernels launched {counts}")
    log(f"phase 13 {time.perf_counter() - t_phase!r} s")


# --------------------------------------------------------------------------
# Phase 14: the ssm, vlm and audio families at full width, no hand kernel
# --------------------------------------------------------------------------

#: jax.eval_shape of the reference's init_params on each published config
MAMBA_PARAM_COUNT = 128_940_480
WHISPER_PARAM_COUNT = 2_020_421_120
LLAMA_VISION_PARAM_COUNT = 9_775_157_248
#: long_500k's sequence length at batch 1, then the shorter ones tried if it does not fit
LONG_LENS = (524_288, 262_144, 131_072)
SSM_DECODE_LEN = 256  # four of Mamba2's 64-token chunks
CROSS_DECODE_LEN = 64


def phase14_counts(label: str) -> None:
    from repro_torch.kernels import ops

    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(not counts, f"phase 14 {label}: hand kernels launched {counts}")


def stub_memory(cfg, batch: int, device, seed: int, dtype):
    """The forward pass's stub input: image embeddings (vlm) or frame
    embeddings (audio), N(0, 1), drawn on the card."""
    import torch

    if cfg.family not in ("vlm", "audio"):
        return None
    key, m = ("images", cfg.num_image_tokens) if cfg.family == "vlm" else ("frames", cfg.num_frames)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {key: torch.randn((batch, m, cfg.d_model), device=device, generator=gen).to(dtype)}


def phase14_prefill(params, cfg, tokens, extras, device, profile: bool = True) -> dict:
    """``prefill_step`` on ``tokens``: a warm call (under the profiler when
    ``profile``), then a timed one, the counts set to 0 just before each and
    read just after (none); finite logits and the repeat bitwise equal."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prefill_step

    outs, row = [], None
    for run in ("warm", "timed"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if run == "warm" and profile:
            profile_call(f"phase 14 {cfg.name} prefill 1 x {tokens.shape[1]}",
                         lambda: outs.append(prefill_step(params, tokens, cfg, extras)))
        else:
            outs.append(prefill_step(params, tokens, cfg, extras))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        phase14_counts(f"{cfg.name} prefill")
        row = dict(arch=cfg.name, run=run, batch=tokens.shape[0], seq=tokens.shape[1], wall_s=wall_s,
                   tokens_per_s=tokens.numel() / wall_s, peak_device_bytes=torch.cuda.max_memory_allocated(device))
        log("phase 14 prefill " + json.dumps(row))
        logits = outs[-1]
        check(tuple(logits.shape) == (tokens.shape[0], cfg.vocab_size) and bool(torch.isfinite(logits).all()),
              f"phase 14 {cfg.name} prefill: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    check(torch.equal(outs[0], outs[1]), f"phase 14 {cfg.name} prefill: a repeat is not bitwise equal")
    log(f"phase 14 {cfg.name} prefill: next token {int(torch.argmax(outs[1][0]))}, logits in "
        f"[{float(outs[1].min())!r}, {float(outs[1].max())!r}], bitwise equal on the repeat")
    return row


def phase14_serve(params, cfg, device) -> None:
    """``serve`` at batch 8, 32 prompt and 32 generated tokens (bf16); for
    the vlm and audio families it draws the stub memory and fills the cross
    cache; then one warm decode step under the profiler."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_decode_state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    seqs = serve(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN, seed=0, device=device, params=params)
    wall_s = time.perf_counter() - t0
    phase14_counts(f"{cfg.name} serve")
    steps = SERVE_PROMPT + SERVE_GEN - 1
    log("phase 14 serve " + json.dumps(dict(
        arch=cfg.name, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN, wall_s=wall_s,
        tokens_per_s=seqs.size / wall_s, ms_per_step=wall_s / steps * 1e3,
        peak_device_bytes=torch.cuda.max_memory_allocated(device))))
    check(seqs.shape == (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN) and bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()),
          f"phase 14 {cfg.name} serve: served tokens")
    if cfg.family in ("vlm", "audio"):
        from repro_torch.launch.serve import _stub_memory
        from repro_torch.models.lm import fill_cross_cache

        extras = _stub_memory(cfg, SERVE_BATCH, 0, device)
        state = fill_cross_cache(params, cfg, init_decode_state(cfg, SERVE_BATCH, 64, device=device), extras)
    else:
        extras, state = None, init_decode_state(cfg, SERVE_BATCH, 64, device=device)
    step_tokens = torch.as_tensor(seqs[:, :1], device=device)
    with torch.no_grad():
        decode_step(params, state, step_tokens, 0, cfg, extras)
        profile_call(f"phase 14 {cfg.name} decode step, batch {SERVE_BATCH}",
                     lambda: decode_step(params, state, step_tokens, 1, cfg, extras))
    del state, extras


def decode_all(params, cfg, tokens, extras, device):
    """Teacher-forced ``decode_step`` over ``tokens`` in float32 (the cross
    cache, if the config keeps one, filled from ``extras`` in float32)."""
    import torch

    from repro_torch.models import decode_step, init_decode_state
    from repro_torch.models.lm import fill_cross_cache

    state = init_decode_state(cfg, tokens.shape[0], tokens.shape[1], dtype=torch.float32, device=device)
    if extras is not None:
        state = fill_cross_cache(params, cfg, state, extras, torch.float32)
    outs = []
    for i in range(tokens.shape[1]):
        lg, state = decode_step(params, state, tokens[:, i:i + 1], i, cfg, extras)
        outs.append(lg)
    return torch.cat(outs, dim=1)


def phase14_draw(arch: str, count: int, device):
    import torch

    from repro_torch import configs
    from repro_torch.models import init_params, param_count

    cfg = configs.get(arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    n = param_count(params)
    log(f"phase 14: {cfg.name} full width and depth ({cfg.family}, {cfg.num_layers} layers), {n} float32 "
        f"parameters ({n * 4} bytes) drawn on the card in {time.perf_counter() - t0!r} s")
    check(n == count, f"phase 14 {arch} parameter count {n}")
    return cfg, params


def mamba_long_prefill(params, cfg, device) -> None:
    """Prefill at long_500k's length (batch 1), or the longest of
    `LONG_LENS` that fits: a warm call and a timed one."""
    import torch

    gen = torch.Generator(device=device).manual_seed(8)
    for length in LONG_LENS:
        tokens = torch.randint(0, cfg.vocab_size, (1, length), device=device, generator=gen)
        try:
            phase14_prefill(params, cfg, tokens, None, device, profile=False)
            oom = None
        except torch.cuda.OutOfMemoryError as exc:
            oom = str(exc).splitlines()[0]
        del tokens
        torch.cuda.empty_cache()  # after the except block has let go of the failed call's frames
        if oom is not None:
            log(f"phase 14 {cfg.name} prefill 1 x {length}: out of memory ({oom})")
            continue
        log(f"phase 14 {cfg.name}: the longest prefill that fits of {list(LONG_LENS)} is 1 x {length}")
        return
    check(False, f"phase 14 {cfg.name}: no prefill of {list(LONG_LENS)} fits")


def mamba_remat_steps(cfg, device) -> None:
    """Three AdamW steps at 1 x TRAIN_SEQ from the same state with remat
    "none" and "full": the losses bitwise equal, the first step's gradients
    bitwise equal or the leaves that differ named, all finite; the step time
    and peak memory of each."""
    import torch

    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.train import init_train_state, loss_and_grads, make_train_step
    from repro_torch.tree import leaves_with_paths

    tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=1, lr=3e-4, warmup_steps=1)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, 1, seed=tcfg.seed)
    batches = [{"tokens": torch.as_tensor(pipe.batch(i), dtype=torch.int64, device=device)} for i in range(3)]
    runs = {}
    for remat in ("none", "full"):
        c = cfg.replace(remat=remat)
        state = init_train_state(c, tcfg, torch.Generator(device=device).manual_seed(0), device=device)
        names = ["/".join(map(str, path)) for path, _ in leaves_with_paths(state.params)]
        grads, _ = loss_and_grads(state.params, batches[0], c, tcfg.z_loss)
        check(all(bool(torch.isfinite(g).all()) for g in grads), f"phase 14 mamba remat={remat}: non-finite gradients")
        step_fn = make_train_step(c, tcfg)
        rows = []
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            m = {k: float(v) for k, v in metrics.items()}
            rows.append(dict(remat=remat, step=i, batch=1, seq=TRAIN_SEQ, wall_s=wall_s,
                             tokens_per_s=TRAIN_SEQ / wall_s,
                             peak_device_bytes=torch.cuda.max_memory_allocated(device), **m))
            log("phase 14 mamba train step " + json.dumps(rows[-1]))
            check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]), f"phase 14 mamba step {i}: {m}")
        runs[remat] = (rows, grads)
        del state, step_fn
    phase14_counts("mamba train steps")
    (rows_n, g_n), (rows_f, g_f) = runs["none"], runs["full"]
    check([r["loss"] for r in rows_n] == [r["loss"] for r in rows_f],
          f"phase 14 mamba: losses with remat none {[r['loss'] for r in rows_n]} and full {[r['loss'] for r in rows_f]}")
    differ = [names[j] for j in range(len(names)) if not torch.equal(g_n[j], g_f[j])]
    log(f"phase 14 mamba remat: losses bitwise equal over the three steps; gradients "
        + ("bitwise equal in every leaf" if not differ else f"NOT bitwise equal in {differ}")
        + f"; warm step {rows_n[-1]['wall_s']!r} s (none) against {rows_f[-1]['wall_s']!r} s (full), peak "
        f"{max(r['peak_device_bytes'] for r in rows_n)} against {max(r['peak_device_bytes'] for r in rows_f)} bytes")
    del runs, g_n, g_f


def ssm_scan_costs(device) -> None:
    """Phase 14 (1): the SSD's cross-chunk scan alone at Mamba2's chunk
    states, (1, nc, 24, 128, 64) float32 with nc = PREFILL_LEN / 64 and
    LONG_LENS[0] / 64: `ssm._assoc_scan` (the reference's odd/even
    recursion, which the model runs) against the doubling `linear_scan` of
    kernels/ref.py, each one's ms (CUDA events), device kernels and their
    time (profiler) and peak memory above its inputs; the two agree."""
    import torch

    from repro_torch.kernels.ref import linear_scan
    from repro_torch.models import ssm

    for seq in (PREFILL_LEN, LONG_LENS[0]):
        nc = seq // 64
        gen = torch.Generator(device=device).manual_seed(12)
        a = 0.5 + 0.5 * torch.rand((1, nc, 24, 1, 1), device=device, generator=gen)
        states = torch.randn((1, nc, 24, 128, 64), device=device, generator=gen)
        row, outs = dict(seq=seq, nc=nc, state_bytes=states.numel() * 4), {}
        for name, fn in (("assoc", lambda: ssm._assoc_scan(a, states)[1]),
                         ("doubling", lambda: linear_scan(a, states, 1)[1])):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            outs[name] = fn()
            torch.cuda.synchronize()
            row[f"{name}_peak_extra_bytes"] = torch.cuda.max_memory_allocated(device) - base
            row[f"{name}_kernels"], dev_us = device_kernels(fn)
            row[f"{name}_device_ms"] = dev_us / 1e3
            row[f"{name}_ms"] = time_ms(fn, warmup=1, reps=3)
        # not `_max_abs_err`: its boolean mask would index 1.6e9 entries at nc = 8192
        row["max_abs_diff"] = float((outs["assoc"] - outs["doubling"]).abs_().max())
        row["max_abs"] = float(outs["doubling"].abs().max())
        log("phase 14 ssd scan " + json.dumps(row))
        check(row["max_abs_diff"] <= 1e-4 * row["max_abs"], f"phase 14 ssd scan at nc = {nc}: the scans disagree")
        del a, states, outs
        torch.cuda.empty_cache()


def run_mamba(device) -> None:
    """Phase 14 (1): Mamba2-130M at full width and depth."""
    import torch

    ssm_scan_costs(device)
    cfg, params = phase14_draw("mamba2_130m", MAMBA_PARAM_COUNT, device)
    gen = torch.Generator(device=device).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), device=device, generator=gen)
    phase14_prefill(params, cfg, tokens, None, device)
    del tokens
    mamba_long_prefill(params, cfg, device)
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    prompt = torch.randint(0, cfg.vocab_size, (1, SSM_DECODE_LEN), device=device, generator=gen)
    with torch.no_grad():
        from repro_torch.models import forward

        ref, _ = forward(params, prompt, cfg32)
        t0 = time.perf_counter()
        dec = decode_all(params, cfg32, prompt, None, device)
        torch.cuda.synchronize()
    torch.testing.assert_close(dec, ref, **DECODE_TOL)
    log(f"phase 14 {cfg.name} decode against forward, float32, {SSM_DECODE_LEN} tokens: max_abs_err "
        f"{_max_abs_err(dec, ref)!r} (max |logit| {float(ref.abs().max())!r}); "
        f"{(time.perf_counter() - t0) / SSM_DECODE_LEN * 1e3!r} ms a step")
    del ref, dec
    phase14_serve(params, cfg, device)
    del params
    torch.cuda.empty_cache()
    mamba_remat_steps(cfg, device)
    torch.cuda.empty_cache()


def run_cross_family(arch: str, count: int, device) -> None:
    """Phase 14 (2, 3): Whisper-large-v3 or Llama-3.2-Vision-11B at full
    width and depth: prefill with the stub memory, serve, then decode in
    float32 with and without the cross cache against each other and
    against ``forward``. Llama's decode must match its forward; Whisper's
    differs (C-15), and the difference is printed, not checked."""
    import torch

    from repro_torch.models import forward
    from repro_torch.models.lm import _encode_audio

    cfg, params = phase14_draw(arch, count, device)
    gen = torch.Generator(device=device).manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), device=device, generator=gen)
    phase14_prefill(params, cfg, tokens, stub_memory(cfg, 1, device, 10, torch.bfloat16), device)
    del tokens
    torch.cuda.empty_cache()
    phase14_serve(params, cfg, device)
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(dtype="float32")
    prompt = torch.randint(0, cfg.vocab_size, (1, CROSS_DECODE_LEN), device=device, generator=gen)
    mem = stub_memory(cfg, 1, device, 11, torch.float32)
    with torch.no_grad():
        ref, _ = forward(params, prompt, cfg32, mem)
        dec_mem = mem if cfg.family == "vlm" else {"enc_out": _encode_audio(params, mem["frames"], cfg32)}
        t0 = time.perf_counter()
        cached = decode_all(params, cfg32, prompt, dec_mem, device)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / CROSS_DECODE_LEN * 1e3
        uncached = decode_all(params, cfg32.replace(decode_cross_cache=False), prompt, dec_mem, device)
    phase14_counts(f"{cfg.name} decode")
    torch.testing.assert_close(cached, uncached, **DECODE_TOL)
    fwd_err = _max_abs_err(cached, ref)
    log(f"phase 14 {cfg.name} decode, float32, {CROSS_DECODE_LEN} tokens: with the cross cache against without "
        f"it max_abs_err {_max_abs_err(cached, uncached)!r}; {step_ms!r} ms a cached step; against forward "
        f"{fwd_err!r} (max |logit| {float(ref.abs().max())!r})")
    if cfg.family == "vlm":
        torch.testing.assert_close(cached, ref, **DECODE_TOL)
        torch.testing.assert_close(uncached, ref, **DECODE_TOL)
    else:
        tol = DECODE_TOL["atol"] + DECODE_TOL["rtol"] * float(ref.abs().max())
        log(f"phase 14 C-15 on the card: {cfg.name}'s decode (self, cross, FFN) against its forward (self, "
            f"FFN, cross) differs by up to {fwd_err!r}, {fwd_err / tol!r} x DECODE_TOL at this scale (printed, "
            f"not checked)")
    del params, ref, cached, uncached, mem, dec_mem
    torch.cuda.empty_cache()


def run_new_families_phase(device) -> None:
    """Phase 14: the ssm, vlm and audio families at full width and depth,
    each model freed before the next is drawn; plain torch, so the launch
    counts, set to 0 just before, read 0 after."""
    import torch

    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    run_mamba(device)
    log(f"phase 14 mamba2_130m {time.perf_counter() - t_phase!r} s")
    t0 = time.perf_counter()
    run_cross_family("whisper_large_v3", WHISPER_PARAM_COUNT, device)
    log(f"phase 14 whisper_large_v3 {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    run_cross_family("llama32_vision_11b", LLAMA_VISION_PARAM_COUNT, device)
    log(f"phase 14 llama32_vision_11b {time.perf_counter() - t0!r} s")
    phase14_counts("the phase")
    log(f"phase 14 {time.perf_counter() - t_phase!r} s")


# --------------------------------------------------------------------------
# Phase 15: the mesh slice (sharded training, the sharded executor, dry-run)
# --------------------------------------------------------------------------

#: the dry-run cells of phase 15 (iii): one architecture a family, each a
#: job of its own, on both production meshes; plus RecurrentGemma-2B's step
#: at phase 8's shape on a 1x1 mesh
DRYRUN_FAMILIES = ("qwen3_14b", "olmoe_1b_7b", "mamba2_130m", "llama32_vision_11b", "whisper_large_v3",
                   "recurrentgemma_2b")
DRYRUN_SHAPE = "decode_32k"
DRYRUN_TIMEOUT_S = 200
DRYRUN_CHILD = r"""
import json, sys
from repro_torch.configs import base
from repro_torch.launch import dryrun

arch, shape, meshes = sys.argv[1], sys.argv[2], sys.argv[3]
if shape == "train_1x{seq}":
    base.SHAPES[shape] = ({seq}, 1, "train")
for mesh in meshes.split(","):
    shape_m = tuple(int(v) for v in mesh.split("x"))
    rec = dryrun.run_cell(arch, shape, mesh_shape=shape_m, multi_pod=len(shape_m) == 3, verbose=False)
    print("RECORD " + json.dumps(rec), flush=True)
"""


def start_dryruns() -> list:
    """Phase 15 (iii)'s jobs, started now and read by `finish_dryruns`."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent / "src")
    child = DRYRUN_CHILD.replace("{seq}", str(TRAIN_SEQ))
    jobs = [(arch, DRYRUN_SHAPE, "16x16,2x16x16") for arch in DRYRUN_FAMILIES]
    jobs.append(("recurrentgemma_2b", f"train_1x{TRAIN_SEQ}", "1x1"))
    return [(job, subprocess.Popen([sys.executable, "-c", child, *job], env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)) for job in jobs]


def finish_dryruns(procs, measured_peak: int) -> None:
    """Wait for (iii)'s jobs (killing any still running at the deadline),
    check and print their records."""
    deadline = time.perf_counter() + DRYRUN_TIMEOUT_S
    records = []
    try:
        for job, proc in procs:
            try:
                out, err = proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
                check(False, f"phase 15 dry-run {job} did not finish in {DRYRUN_TIMEOUT_S} s")
            got = [json.loads(line[len("RECORD "):]) for line in out.splitlines() if line.startswith("RECORD ")]
            check(proc.returncode == 0 and len(got) == len(job[2].split(",")),
                  f"phase 15 dry-run {job} failed ({proc.returncode}): {err[-3000:]}")
            records += got
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rec in records:
        coll = rec["collectives"]
        row = dict(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], collectives=coll["count"],
                   collective_bytes=coll["total_bytes"], model_flops_global=rec["model_flops_global"],
                   flops_per_device=rec["cost"]["flops"], peak_bytes_per_device=rec["memory"]["peak_bytes"],
                   argument_bytes_per_device=rec["memory"]["argument_bytes"], seconds=rec["lower_s"],
                   bottleneck=rec["bottleneck"])
        log("phase 15 dry-run " + json.dumps(row))
        check(rec["model_flops_global"] > 0 and rec["memory"]["peak_bytes"] > 0, f"phase 15 dry-run {row}")
        if rec["devices"] > 1:
            check(coll["count"] > 0, f"phase 15 dry-run {rec['arch']} on {rec['mesh']}: no collective")
        else:
            log(f"phase 15: the dry-run's per-device peak for {rec['arch']} at 1 x {TRAIN_SEQ} on a 1x1 mesh "
                f"{rec['memory']['peak_bytes']} bytes (arguments {rec['memory']['argument_bytes']}, step "
                f"{rec['memory']['temp_bytes']}), beside (i)'s measured peak {measured_peak} bytes")


def _digest(t) -> tuple:
    """A parameter's float64 sum, sum of squares and first 4096 entries."""
    import torch
    from torch.distributed.tensor import DTensor

    local = t.to_local() if isinstance(t, DTensor) else t
    x = local.detach().double()
    return torch.stack([x.sum(), (x * x).sum()]).cpu(), local.detach().reshape(-1)[:4096].cpu()


def sharded_train_steps(mesh, device) -> tuple[dict, int]:
    """Phase 15 (i): three sharded steps on the 1x1 mesh, then three
    unsharded ones from the same seed; returns the sharded run's launches
    and its peak device bytes."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import leaves

    cfg = configs.get("recurrentgemma_2b").replace(rglru_backend="pallas")
    n_rglru = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "rglru" for i in range(cfg.num_layers))
    tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=1, lr=3e-4)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, 1, seed=tcfg.seed)
    runs = {}
    total: dict[str, int] = {}
    for name, m in (("sharded", mesh), ("unsharded", None)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state = init_train_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0), device=device, mesh=m)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if m is not None:
            placed = sorted({str(p.placements) for p in leaves(state.params)})
            check(all(isinstance(p, DTensor) for p in leaves(state.params) + leaves(state.opt.m)),
                  "phase 15: the sharded state holds plain tensors")
            log(f"phase 15 (i): state placed by param_specs on {mesh}: placements {placed}")
        step = make_train_step(cfg, tcfg, m)
        losses, rows = [], []
        for i in range(3):
            batch = {"tokens": torch.as_tensor(pipe.batch(i), dtype=torch.int64, device=device)}
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in ops.LAUNCHES.items() if v}
            check(counts == {"lru_scan_fwd": n_rglru, "lru_scan_bwd": n_rglru},
                  f"phase 15 (i) {name} step {i}: launches {counts}")
            if m is not None:
                _launches_into(total, counts)
            loss = metrics["loss"].full_tensor() if isinstance(metrics["loss"], DTensor) else metrics["loss"]
            losses.append(loss.cpu())
            row = dict(run=name, step=i, wall_s=wall, peak_device_bytes=torch.cuda.max_memory_allocated(device),
                       loss=float(loss), launches=counts)
            rows.append(row)
            log("phase 15 (i) train step " + json.dumps(row))
        check(all(math.isfinite(float(v)) for v in losses), f"phase 15 (i) {name}: non-finite losses")
        runs[name] = (losses, [_digest(p) for p in leaves(state.params)],
                      torch.cuda.max_memory_allocated(device), rows, init_s)
        del state, step, metrics
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    (l1, d1, peak1, rows1, init1), (l2, d2, peak2, rows2, init2) = runs["sharded"], runs["unsharded"]
    same_loss = all(torch.equal(a, b) for a, b in zip(l1, l2))
    differ = [j for j, (a, b) in enumerate(zip(d1, d2)) if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))]
    log(f"phase 15 (i): losses sharded {[float(v) for v in l1]} unsharded {[float(v) for v in l2]}; "
        f"{len(d1) - len(differ)} of {len(d1)} parameter digests equal after step 3; init {init1!r} / {init2!r} s; "
        f"warm step {rows1[-1]['wall_s']!r} / {rows2[-1]['wall_s']!r} s; peak {peak1} / {peak2} bytes "
        f"(sharded / unsharded)")
    check(same_loss and not differ, f"phase 15 (i): the 1x1-mesh step is not bitwise the unsharded step "
          f"(losses equal {same_loss}, parameters that differ {differ[:8]})")
    return total, peak1


def sharded_executor(mesh, device) -> dict:
    """Phase 15 (ii): the executor on the 1x1 mesh against mesh=None."""
    import torch

    import repro_torch as rt
    from repro_torch.batch import BucketedExecutor
    from repro_torch.obs.metrics import MetricsRegistry

    problems = _parity_problems(device, count=8, lams=PARITY_LAMS)
    opts = dict(method="spar_sink_mf", seeds=list(range(8)), s=8 * rt.s0(2048), tol=1e-6, max_iter=2000)
    total: dict[str, int] = {}
    refs, wall_ref, _ = batched_dispatch({}, BucketedExecutor(metrics=MetricsRegistry()), problems, **opts)
    sols, wall, counts = batched_dispatch(total, BucketedExecutor(mesh=mesh, metrics=MetricsRegistry()),
                                          problems, **opts)
    check(counts == {"gathered_kernel": len(problems)}, f"phase 15 (ii): the sharded dispatch launched {counts}")
    for i, (a, b) in enumerate(zip(sols, refs)):
        pa, pb = a.plan(), b.plan()
        same = all(torch.equal(x, y) for x, y in ((a.result.u, b.result.u), (a.result.v, b.result.v),
                                                  (a.value, b.value), (a.n_iter, b.n_iter), (a.nnz, b.nnz),
                                                  (pa.rows, pb.rows), (pa.cols, pb.cols), (pa.vals, pb.vals)))
        check(same and a.status_label == b.status_label, f"phase 15 (ii) problem {i}: mesh=1x1 is not bitwise mesh=None")
    log(f"phase 15 (ii): BucketedExecutor(mesh=1x1) spar_sink_mf on {len(problems)} problems bitwise mesh=None's "
        f"solutions (u, v, value, n_iter, nnz, status, plan); launches {counts}; {wall!r} s, mesh=None {wall_ref!r} s")
    return total


def run_sharded_phase(device) -> dict[str, int]:
    """Phase 15 (see the module docstring); returns its kernel launches."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    t_phase = time.perf_counter()
    procs = start_dryruns()
    try:
        mesh = make_test_mesh(1, 1)
        try:
            total, peak = sharded_train_steps(mesh, device)
            log(f"phase 15 (i) {time.perf_counter() - t_phase!r} s")
            t0 = time.perf_counter()
            _launches_into(total, sharded_executor(mesh, device))
            log(f"phase 15 (ii) {time.perf_counter() - t0!r} s")
        finally:
            dist.destroy_process_group()
        t0 = time.perf_counter()
        finish_dryruns(procs, peak)
        log(f"phase 15 (iii) waited {time.perf_counter() - t0!r} s")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"phase 15 {time.perf_counter() - t_phase!r} s, launches {total}")
    return total


def profile_solve(label: str, problem, **opts) -> None:
    """Run one warm ``solve`` under `torch.profiler` and print where its
    device time goes (`profile_call`)."""
    import repro_torch as rt

    float(rt.solve(problem, **opts).value)  # warm: kernel caches, the Geometry's K
    profile_call(label, lambda: float(rt.solve(problem, **opts).value))


def profile_call(label: str, fn) -> None:
    """Run ``fn()`` (warm) once under `torch.profiler` and print where its
    device time goes: the busiest kernels by device time, and the device's
    busy share of the run's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel events only: an operator's row repeats its kernels' device time
    rows = sorted(
        ((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    log(f"profile {label}: wall {wall_us / 1e3!r} ms, kernels {busy / 1e3!r} ms "
        f"(device busy share {busy / wall_us!r})")
    for dev_us, count, key in rows[:12]:
        log(f"profile {label}:   {dev_us / 1e3:10.3f} ms  {count:6d}x  {key[:100]}")


def profile_main_path(n: int, device, max_iter: int = 200) -> None:
    """Run (a) once more under `torch.profiler`; then the block-ELL OT solve
    of phase 6 at n = 8192."""
    import repro_torch as rt
    from repro_torch.data.pointclouds import make_measures

    a, b, x = make_measures("C1", n, 5, seed=0)
    problem = rt.OTProblem(rt.PointCloudGeometry(x, device=device), a, b, 0.1)
    profile_solve("(a)", problem, method="spar_sink_mf", seed=0, s=4 * rt.s0(n), tol=1e-6, max_iter=max_iter)
    ot, _ = block_ell_problems(8192, device)
    profile_solve("block-ELL OT", ot, method="spar_sink_block_ell", seed=0, s=16 * rt.s0(8192),
                  tol=1e-6, max_iter=1000)


#: ``--run-b-with``'s child: phase 3's runs (b) and (a) solved from the
#: checkout whose root is argv[1] (after an untimed (b)); (b)'s potentials
#: saved to argv[2]; one JSON line out
RUN_B_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels import library
library.load()
import repro_torch as rt
from repro_torch.data.pointclouds import make_measures
n = 2 ** 17
a, b, x = make_measures("C1", n, 5, seed=0)
ot = rt.OTProblem(rt.PointCloudGeometry(x, device=torch.device("cuda", 0)), a, b, 0.1)
out = {}
for run, stabilize in (("warm", True), ("b", True), ("a", False)):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = rt.solve(ot, method="spar_sink_mf", seed=0, s=4 * rt.s0(n), tol=1e-6, max_iter=200, stabilize=stabilize)
    value = float(sol.value)
    torch.cuda.synchronize()
    out[run] = dict(value=value, n_iter=int(sol.n_iter), status=sol.status_label, wall_s=time.perf_counter() - t0)
    if run == "b":
        torch.save((sol.result.u.cpu(), sol.result.v.cpu()), sys.argv[2])
del out["warm"]
print(json.dumps(out))
"""


def compare_run_b(other: Path) -> None:
    """``--run-b-with OTHER_ROOT``: phase 3's runs (b) and (a) from another
    checkout (an earlier commit unpacked by ``git archive`` into a directory
    that ``.gitignore`` lists, its kernels built there) and from this one,
    each in a process of its own, in turns (other, this, this, other):
    value, iterations, status and wall of each, then whether (b)'s
    potentials are bitwise equal, with their largest difference."""
    import torch

    here = Path(__file__).resolve().parent
    check((other / "src" / "repro_torch").is_dir(), f"--run-b-with {other}: no src/repro_torch there")
    out_dir = here / "build" / "run_b"
    out_dir.mkdir(parents=True, exist_ok=True)
    potentials = {}
    for label, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        path = out_dir / f"{label}.pt"
        r = subprocess.run([sys.executable, "-c", RUN_B_CHILD, str(root), str(path)], capture_output=True, text=True)
        check(r.returncode == 0, f"--run-b-with: the run from {root} failed: {r.stderr[-3000:]}")
        log(f"runs (b), (a) from {label} tree {root}: {r.stdout.strip().splitlines()[-1]}")
        potentials[label] = torch.load(path)
    (f_o, g_o), (f_t, g_t) = potentials["other"], potentials["this"]
    log(f"run (b)'s potentials bitwise equal (other, this): {torch.equal(f_o, f_t)}, {torch.equal(g_o, g_t)}; "
        f"largest difference {float((f_o - f_t).abs().nan_to_num().max())!r}, "
        f"{float((g_o - g_t).abs().nan_to_num().max())!r}")


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
    from repro_torch.kernels import library

    # full float32 in every float32 matrix product and convolution: TF32 in
    # the plain versions' x @ y.T would cancel catastrophically in
    # |x|^2 + |y|^2 - 2 x.y
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    clock = max_sm_clock_hz()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}, "
        f"max SM clock {clock / 1e6!r} MHz")
    t0 = time.perf_counter()
    library.load()
    sources = sorted(p.name for p in library.CSRC.glob("*.cu"))
    log(f"built and loaded {len(sources)} CUDA sources {sources} in {time.perf_counter() - t0!r} s")

    args = sys.argv[1:]
    if "--run-b-with" in args:
        compare_run_b(Path(args[args.index("--run-b-with") + 1]).resolve())
        log(card)
        return 0
    if "--compare-with" in args:
        # each other source is compared with the current one of its kind
        for other in args[args.index("--compare-with") + 1:]:
            path = Path(other).resolve()
            text = path.read_text()
            if "online_matvec_launch" in text:
                compare_sources(path, device)
            elif "block_ell_matvec_launch" in text:
                compare_block_ell(path, device)
            elif "lru_scan_fwd_launch" in text:
                compare_lru_scan(path, device)
            elif "gathered_kernel_launch" in text:
                compare_gather(path, device)
            else:
                check(False, f"--compare-with {other}: not a fused_sinkhorn, block_ell, lru_scan or gather_kernel "
                      f"source")
        log(card)
        return 0

    n = 2 ** 17
    entries = check_gathered_kernel(n, default_cap(4 * s0(n)), 5, device)
    online_entries = check_online_kernels(n, device, clock)
    launches, main_runs, scalings_a = run_main_path(n, device)
    value_a = main_runs["a"][0]
    entries.append(check_segment_lse_kernel(n, device))
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
    v_log = check_accuracy(8192, device)
    run_estimators_phase(8192, device, v_log)
    fused_launches, x, u, v = run_fused_path(n, device)
    for entry in online_entries:
        entry["launches"] = fused_launches[entry["name"]]
    entries += online_entries
    t0 = time.perf_counter()
    value_dense = blockwise_ot_value(x, u, v, 0.1)
    rel = abs(value_a - value_dense) / abs(value_dense)
    log(f"accuracy n={n}: fused dense objective {value_dense!r} ({time.perf_counter() - t0!r} s), "
        f"run (a) spar_sink_mf {value_a!r}, relative error {rel!r}")
    check(math.isfinite(value_dense) and math.isfinite(rel), "non-finite n = 2^17 accuracy")
    del x, u, v
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    block_ell_entries = check_block_ell_kernel(8192, device)
    block_ell_launches, s_be, ot_be = run_block_ell_path(8192, device)
    for entry in block_ell_entries:
        entry["launches"] = block_ell_launches[entry["name"]]
    entries += block_ell_entries
    check_block_ell_accuracy(8192, device, v_log, s_be, ot_be)
    log(f"block-ELL phase {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    phase10 = run_observability_phase(device, main_runs, scalings_a, value_dense, v_log, ot_be)
    for entry in entries:
        entry["launches"] += phase10.get(entry["name"], 0)
    del scalings_a
    torch.cuda.empty_cache()
    log(f"phase 10 {time.perf_counter() - t0!r} s")
    phase11 = run_ot_serving_phase(device)
    for entry in entries:
        entry["launches"] += phase11.get(entry["name"], 0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    entries.append(check_lru_scan_kernel(device))
    entries[-1]["launches"] = run_serving_slice(device, profile_run)
    log(f"serving slice phase {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    entries.append(check_lru_scan_bwd_kernel(device))
    entries[-1]["launches"] = run_training_slice(device, profile_run)
    log(f"training slice phase {time.perf_counter() - t0!r} s")
    run_lm_families_phase(device)
    run_applications_phase(device)
    run_new_families_phase(device)
    phase15 = run_sharded_phase(device)
    for entry in entries:
        entry["launches"] += phase15.get(entry["name"], 0)
    check(all(phase15.get(k, 0) > 0 for k in ("lru_scan_fwd", "lru_scan_bwd", "gathered_kernel")),
          f"phase 15 launched {phase15}")
    for entry in entries:
        check(entry["launches"] > 0, f"{entry['name']} was not launched on its path")
    if profile_run:
        profile_main_path(n, device)

    log(f"total {time.perf_counter() - t_start!r} s")
    log(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
