"""What every kind of cell shares: the `Run` a cell's run returns, the
inputs made from the seed, and the step from a solution to the outputs
the judge reads.

A cell's configuration names its kind (``perfbench/kinds/<kind>.py``,
which sets up and drives the window and names the reference, the control
and the faults of its answers) and its pattern
(``perfbench/patterns/<pattern>.py``, which makes the problems); its
traffic names its discipline (``perfbench/disciplines/<discipline>.py``,
the loop that offers the work). `perfbench.harness.manifest.Cell` finds
all three by name. Nothing here judges: `perfbench.harness.judge` does,
once the window has closed, the memory peak has been read and the
program's state is freed.
"""
from __future__ import annotations

import gc
import math
from dataclasses import dataclass, field

import torch

from perfbench.harness.inputs import derive, generator
from perfbench.harness.trace import DeviceTrace, Spans
from perfbench.reference.spar_sink import Estimate, Inputs

__all__ = ["LATE_S", "Run", "control_items", "domain", "estimate_of", "inputs_of", "make_pool", "open_window", "peak",
           "problem_of", "run_cell", "sync", "warm_profiler"]

#: how long past the window's close an answer is waited for
LATE_S = 60.0


@dataclass
class Run:
    attempted: int = 0
    failed: int = 0
    setup_s: float = 0.0
    e2e: dict = field(default_factory=dict)
    records: dict = field(default_factory=dict)
    #: ``(Inputs, Estimate)`` pairs to judge, or ``(Inputs, None)`` for an
    #: answer that never came
    items: list = field(default_factory=list)
    spans: Spans = field(default_factory=Spans)
    trace: DeviceTrace | None = None
    memory_peak_bytes: int = 0
    #: called once the memory peak is read: frees the program's state
    release: object = None


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def domain(cell) -> str:
    """The Sinkhorn loop's domain that the cell's traffic asks for."""
    return "log" if cell.traffic["stabilize"] else "scaling"


def make_pool(cell, seed: int, device) -> list[dict]:
    """The cell's problems, made by its pattern from the seed: each a dict
    of ``x``, ``a``, ``b`` (float64 on ``device``) and ``lam``."""
    return cell.pattern.make(cell.config, cell.traffic["pool"], device, generator(device, seed, "pool"))


def problem_of(p: dict, cfg: dict, device):
    """The program's problem for one pool entry: OT, or UOT where ``lam``
    is finite."""
    import repro_torch as rt

    geom = rt.PointCloudGeometry(p["x"], cost=cfg["cost"], device=device)
    if math.isinf(p["lam"]):
        return rt.OTProblem(geom, p["a"], p["b"], cfg["eps"])
    return rt.UOTProblem(geom, p["a"], p["b"], cfg["eps"], lam=p["lam"])


def inputs_of(p: dict, cfg: dict, s: float) -> Inputs:
    """What the reference is handed for one pool entry: the same tensors."""
    return Inputs(p["x"], p["a"], p["b"], cfg["eps"], p["lam"], s)


def estimate_of(sol, inputs: Inputs, dom: str, tol: float, max_iter: int) -> tuple[Inputs, Estimate]:
    """The public outputs of a solution, cut to its kept pairs."""
    plan = sol.plan()
    nnz = int(plan.nnz)
    f, g = sol.potentials
    return inputs, Estimate(plan.rows[:nnz].clone(), plan.cols[:nnz].clone(), plan.vals[:nnz].clone(),
                            f.clone(), g.clone(), float(sol.value), dom, tol, max_iter)


def control_items(cell, seed: int, device) -> list:
    """A Spar-Sink cell's judged estimates made by the control
    (`perfbench.reference.control`) on the inputs the cell would give the
    program for ``seed``."""
    from perfbench.reference.control import control_estimate

    pool = make_pool(cell, seed, device)
    s = cell.kind.budget(cell.config)
    tol, max_iter = cell.kind.stops(cell)
    items = []
    for k in cell.kind.sample(cell, seed, pool):
        inp = inputs_of(pool[k % len(pool)], cell.config, s)
        gen = torch.Generator(device=device).manual_seed(derive(seed, "control", k))
        items.append((inp, control_estimate(inp, gen, domain(cell), tol, max_iter)))
    return items


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so that a traced window does not
    pay its first start."""
    trace = DeviceTrace()
    trace.begin()
    torch.zeros(1, device=device).add_(1)
    trace.finish()


def open_window(device) -> None:
    """The last step of set-up: everything queued has run, and what set-up
    left on the heap is frozen, so that no collection of it lands in the
    window."""
    sync(device)
    gc.collect()
    gc.freeze()


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Run:
    """One run of ``cell``: its kind's set-up, window and records."""
    return cell.kind.run(cell, seed, seconds, traced, device, t_start)
