"""A cell cut to a size the CPU runs in a second, for the tests."""
import gc
import time

import torch

from perfbench.harness.cells import run_cell
from perfbench.harness.judge import judge
from perfbench.harness.manifest import Cell, load

SEED = 2**33 + 101

#: cells whose files the benchmark keeps for a later PR (PERF.md, Open
#: questions): the harness still drives them here
LATER = [
    {"name": "mf_n131072.ot", "config": "sparsink_mf_c1_n131072", "traffic": "ot", "chips": 1, "why": "later"},
    {"name": "serve_mf.poisson", "config": "otserve_mf_2k_16k", "traffic": "poisson", "chips": 1, "why": "later"},
]


def manifest() -> dict:
    m = load()
    held = {w["name"] for w in m["workloads"]}
    return m | {"workloads": m["workloads"] + [w for w in LATER if w["name"] not in held]}


def tiny(workload: str) -> Cell:
    cell = Cell(manifest(), workload)
    if cell.config["kind"] == "estimate":  # the keys each kind reads (perfbench/kinds/)
        cell.config.update(n=512, s_mult=512)
        cell.traffic.update(pool=2, tol=1e-10, max_iter=2000)
    elif cell.config["kind"] == "lm_decode":  # the program's :smoke configuration
        cell.config.update(arch=cell.config["arch"] + ":smoke", d_model=64, n_layer=2, vocab_size=256, d_state=16,
                           headdim=16)
        cell.traffic.update(batch=8, prompt_len=8, gen_len=88, kept_every=8, kept_last=4, trace_from=4, trace_steps=4,
                            prompt_high=256)
    else:
        cell.config.update(sizes=[96, 128], s_of=1024, tol=1e-10)
        cell.traffic.update(pool=8, sample=4, sample_from=12, rate_per_s=20.0, clients=8)
    return cell


def drive(workload: str, fault: str | None = None, seed: int = SEED):
    """One run of the cut cell on the CPU, with ``fault`` (one of its kind's
    ``FAULTS``) planted; returns ``(correct, checks)``."""
    cell = tiny(workload)
    if fault is None:
        run = run_cell(cell, seed, 1.0, False, torch.device("cpu"), time.perf_counter())
    else:
        with cell.kind.FAULTS.planted(fault):
            run = run_cell(cell, seed, 1.0, False, torch.device("cpu"), time.perf_counter())
    gc.unfreeze()  # the run's set-up froze the heap; the test process goes on
    run.release()
    return judge(cell, run)
