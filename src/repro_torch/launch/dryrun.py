"""Multi-pod dry-run: run every (architecture x input shape) cell, sharded,
on the production meshes — 16x16 (one pod, 256 devices) and 2x16x16 (two
pods, 512) — with nothing allocated, and read the roofline inputs off the
run.

The counterpart of the reference's ``repro.launch.dryrun``, with its flags
and record keys:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe_1b_7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_results.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

How: the reference compiles each cell for 512 host devices and reads
XLA's analyses. Here each cell runs in one process as rank 0 of a *fake*
process group of the mesh's size (``torch.testing``'s ``FakeStore``,
backend ``"fake"``: collectives return at once, moving nothing), on a
``cpu`` `DeviceMesh`, with every parameter, optimizer moment, batch and
cache a DTensor on the ``meta`` device (`repro_torch.launch.specs`). The
step runs eagerly under `use_mesh`, so DTensor's sharding propagation
plays GSPMD's part and every layer runs: an unrolled count, not one scan
body. While it runs, one dispatch mode below DTensor sees rank 0's local
ops and collectives (`_Counter`, a `CommDebugMode`):

* ``collectives``: each collective's count and the bytes of its result on
  this rank (the reference sums the result shapes of the partitioned HLO);
* ``cost.flops``: this rank's FLOPs, `FlopCounterMode`'s formulas on its
  local shapes (XLA's per-device ``flops``);
* ``memory``: ``argument_bytes`` and ``output_bytes`` are this rank's
  local shards of the inputs and outputs; ``peak_bytes`` is
  ``argument_bytes`` plus `MemTracker`'s peak of what the step allocates
  (the activations, gradients and temporaries on ``meta``);
  ``temp_bytes`` is that peak alone.

Strategy costs: to choose an op's sharding, DTensor costs each candidate's
redistributions, and one that involves a ``_StridedShard`` (what a
reshape that merges a sharded dim leaves) is planned by a graph search
whose state space on a 3-D mesh makes one cell take minutes
(``olmoe_1b_7b:smoke`` at ``decode_32k`` on (2, 2, 2): 312 s on one CPU
core). On a mesh of three dims the dry-run costs those as the same
redistributions with plain ``Shard`` placements, which move the same bytes
(`_strided_costs_as_shards`, around each cell only); the redistributions
that run are planned as ever. On two dims the search is quick and kept.

Keys that torch cannot give are ``None``, with the reason:
``cost["bytes accessed"]`` and ``cost["transcendentals"]`` (no compiled
program is analysed; ``t_memory`` is then ``argument_bytes`` over the HBM
rate, the least traffic of a step that reads its inputs once) and
``compile_s`` (nothing is compiled; ``lower_s`` is the eager run's
seconds).

Hardware constants: one NVIDIA H100 SXM5 (NVIDIA's H100 data sheet, dense
rates, 700 W): 989 TFLOP/s bf16, 3.35 TB/s HBM3, and NVLink 4 at 900 GB/s
a GPU both ways, 450 GB/s each way, which the collective term divides by.
NVLink joins the 8 GPUs of one node; a mesh axis of 16 spans two nodes and
its collectives cross InfiniBand (NDR, 400 Gb/s = 50 GB/s a GPU), 9x
slower, so on the production meshes ``t_collective`` is a lower bound.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import _collective_utils
from torch.distributed.tensor._dtensor_spec import DTensorSpec
from torch.distributed.tensor.placement_types import Shard, _StridedShard
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.debug import _comm_mode
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import base as cfg_base
from repro_torch.configs.base import TrainConfig
from repro_torch.distributed.sharding import use_mesh
from repro_torch.launch import specs as specs_lib
from repro_torch.models import lm as lm_lib
from repro_torch.tree import leaves, leaves_with_paths

__all__ = ["HBM_BW", "NVLINK_BW", "PEAK_FLOPS", "collective_stats", "cost_corrected_cell", "main", "model_flops",
           "run_cell"]

# one NVIDIA H100 SXM5 (NVIDIA's H100 data sheet; dense, no sparsity)
PEAK_FLOPS = 989e12  # bf16 FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
NVLINK_BW = 450e9  # NVLink 4, bytes/s a GPU each way (900 GB/s both ways)

_KINDS = {
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "all_gather": "all-gather", "allgather": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "all_to_all": "all-to-all", "alltoall": "all-to-all",
    "broadcast": "collective-permute", "send": "collective-permute", "recv": "collective-permute",
}
_COLLECTIVES = frozenset(_comm_mode.c10d_collective_ops) | frozenset(_comm_mode.NATIVE_TO_PY_MAPPING)
_KEYS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def _kind(name: str) -> str:
    base = name.split(".")[-1].lstrip("_")
    for prefix, kind in _KINDS.items():
        if base.startswith(prefix):
            return kind
    return "collective-permute"


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


class _Counter(CommDebugMode):
    """`CommDebugMode` that also sums each collective's result bytes and
    counts FLOPs on the local ops it sees. DTensor ops are let through (the
    mode returns ``NotImplemented`` for them), so what reaches here is
    rank 0's local work."""

    def __init__(self):
        super().__init__()
        self.coll_bytes = {k: 0 for k in _KEYS}
        self.coll_counts = {k: 0 for k in _KEYS}
        self.flops = 0
        self._registry = FlopCounterMode().flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        if packet in _COLLECTIVES:
            kind = _kind(str(packet))
            self.coll_counts[kind] += 1
            # the c10d ops work in place: their bytes are their input's
            self.coll_bytes[kind] += _nbytes(args[0] if str(packet).endswith("_") else out)
        elif packet in self._registry and not any(isinstance(a, FakeTensor) for a in args):
            # DTensor's sharding propagation runs an op on fake tensors the
            # first time it meets it, to learn its output: not work
            self.flops += int(self._registry[packet](*args, **(kwargs or {}), out_val=out))
        return out


def collective_stats(counter: _Counter) -> dict:
    """Per-device bytes moved by collectives, by kind, from the results of
    every collective a `_Counter` saw (the reference's keys)."""
    out = dict(counter.coll_bytes)
    out["count"] = sum(counter.coll_counts.values())
    out["total_bytes"] = sum(counter.coll_bytes[k] for k in _KEYS)
    return out


def model_flops(cfg, seq: int, batch: int, kind: str):
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for train;
    2*N*D for prefill; 2*N_active per token for decode. Returns
    ``(flops, n_total, n_active)``."""
    params = lm_lib.init_params(cfg, device="meta")
    n_total = sum(int(t.numel()) for t in leaves(params))
    if cfg.is_moe:
        # active params: replace expert dim E by experts_per_token
        n_active = 0
        for path, leaf in leaves_with_paths(params):
            name = "/".join(str(k) for k in path)
            sz = int(leaf.numel())
            if "ffn" in name and leaf.ndim >= 3 and leaf.shape[-3] == cfg.num_experts:
                sz = sz // cfg.num_experts * cfg.experts_per_token
            n_active += sz
    else:
        n_active = n_total
    tokens = batch * (1 if kind == "decode" else seq)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens, n_total, n_active


def _local_bytes(tree) -> int:
    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if isinstance(t, DTensor) else t
            total += local.numel() * local.element_size()
    return total


def _as_shard(spec):
    """``spec`` with each ``_StridedShard`` written as the ``Shard`` of its dim."""
    placements = tuple(Shard(p.dim) if isinstance(p, _StridedShard) else p for p in spec.placements)
    return DTensorSpec(spec.mesh, placements, tensor_meta=spec.tensor_meta)


@contextlib.contextmanager
def _strided_costs_as_shards():
    """While DTensor weighs the strategies of an op, a redistribution that
    involves a ``_StridedShard`` is costed as the same one with plain
    ``Shard`` placements (the same bytes move), whose plan needs no graph
    search; the redistributions DTensor then runs are planned as ever."""
    original = _collective_utils.redistribute_cost

    def cost(current, target):
        if any(isinstance(p, _StridedShard) for p in (*current.placements, *target.placements)):
            return original(_as_shard(current), _as_shard(target))
        return original(current, target)

    holders = [m for name, m in sys.modules.items()
               if name.startswith("torch.distributed.tensor") and getattr(m, "redistribute_cost", None) is original]
    for m in holders:
        m.redistribute_cost = cost
    try:
        yield
    finally:
        for m in holders:
            m.redistribute_cost = original


def _fake_mesh(shape: tuple[int, ...]):
    """A ``cpu`` mesh of ``shape`` on a fresh fake process group (rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    world = 1
    for s in shape:
        world *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _mesh_shape(multi_pod: bool) -> tuple[int, ...]:
    return (2, 16, 16) if multi_pod else (16, 16)


def _measure(cfg, shape_name: str, mesh, tcfg: TrainConfig | None = None) -> dict:
    """Run one cell's step on ``mesh`` under the counter: the raw terms."""
    seq, gb, kind = cfg_base.shape_of(shape_name)
    step, step_name = specs_lib.step_for(cfg, shape_name, tcfg)
    if kind == "train":
        args, _ = specs_lib.abstract_train_args(cfg, shape_name, mesh, tcfg)
    elif kind == "prefill":
        args, _ = specs_lib.abstract_prefill_args(cfg, shape_name, mesh)
    else:
        args, _ = specs_lib.abstract_serve_args(cfg, shape_name, mesh)
    counter, tracker = _Counter(), MemTracker()
    t0 = time.time()
    costs = _strided_costs_as_shards() if mesh.ndim >= 3 else contextlib.nullcontext()
    with costs, use_mesh(mesh), counter, tracker:
        out = step(*args)
    seconds = time.time() - t0
    peak = tracker.get_tracker_snapshot("peak")
    temp = max((v["Total"] for v in peak.values()), default=0)
    arg_bytes = _local_bytes(args)
    return {
        "step": step_name, "seconds": seconds, "flops": float(counter.flops),
        "collectives": collective_stats(counter), "argument_bytes": arg_bytes,
        "output_bytes": _local_bytes(out), "temp_bytes": int(temp),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, tcfg: TrainConfig | None = None,
             verbose: bool = True, mesh_shape: tuple[int, ...] | None = None) -> dict:
    """One cell on the production mesh (``mesh_shape`` overrides it, e.g.
    a reduced ``(2, 2, 2)``): a record with the reference's keys."""
    cfg = cfg_base.get(arch)
    seq, gb, kind = cfg_base.shape_of(shape_name)
    mesh = _fake_mesh(tuple(mesh_shape) if mesh_shape else _mesh_shape(multi_pod))
    try:
        n_dev = mesh.size()
        m = _measure(cfg, shape_name, mesh, tcfg)
    finally:
        dist.destroy_process_group()
    coll = m["collectives"]
    mf, n_total, n_active = model_flops(cfg, seq, gb, kind)
    flops = m["flops"]
    record = {
        "arch": arch,
        "shape": shape_name,
        "step": m["step"],
        "mesh": list(mesh.shape),
        "multi_pod": multi_pod,
        "devices": n_dev,
        "seq": seq,
        "global_batch": gb,
        "lower_s": round(m["seconds"], 2),
        "compile_s": None,
        "memory": {
            "argument_bytes": m["argument_bytes"],
            "output_bytes": m["output_bytes"],
            "temp_bytes": m["temp_bytes"],
            "peak_bytes": m["argument_bytes"] + m["temp_bytes"],
        },
        "cost": {"flops": flops, "bytes accessed": None, "transcendentals": None},
        "collectives": coll,
        "params_total": n_total,
        "params_active": n_active,
        "model_flops_global": mf,
        # roofline terms (seconds, per device)
        "t_compute": flops / PEAK_FLOPS,
        "t_memory": m["argument_bytes"] / HBM_BW,
        "t_collective": coll["total_bytes"] / NVLINK_BW,
        "useful_flops_ratio": (mf / n_dev) / flops if flops else None,
    }
    terms = {"compute": record["t_compute"], "memory": record["t_memory"], "collective": record["t_collective"]}
    record["bottleneck"] = max(terms, key=terms.get)
    if verbose:
        print(json.dumps(record, indent=None, default=str))
        sys.stdout.flush()
    return record


def _layer_reduced(cfg, units: int):
    """Config with ``units`` layer-units (the reference's cost-measurement
    variant). The reference also unrolls its scan and takes the attention
    in one chunk, for XLA's analysis; the port runs its layers and chunks
    eagerly already, and keeps the chunking, whose sharding choices the
    direct count made too."""
    kw = {}
    if cfg.family == "vlm":
        kw["num_layers"] = units * cfg.cross_attn_period
    elif cfg.family == "audio":
        kw["num_layers"] = units
        kw["encoder_layers"] = units
    else:
        kw["num_layers"] = units
    return cfg.replace(**kw)


def _layer_units(cfg) -> int:
    if cfg.family == "vlm":
        return cfg.num_layers // cfg.cross_attn_period
    return cfg.num_layers


def cost_corrected_cell(arch: str, shape_name: str, *, multi_pod: bool = False, verbose: bool = True,
                        mesh_shape: tuple[int, ...] | None = None) -> dict:
    """Cost terms extrapolated from 1- and 2-unit variants at full width:

        cost(L) = cost(1) + (L - 1) * (cost(2) - cost(1))

    The reference needs this because XLA counts a scan body once. The port
    runs every layer, so its direct count is already whole; the
    extrapolation is kept as the reference's mode, and it is exact for the
    per-layer-homogeneous families (the tests hold it to the direct count).
    The hybrid family's direct record is used as it is, as in the
    reference."""
    cfg = cfg_base.get(arch)
    if cfg.family == "hybrid":
        rec = run_cell(arch, shape_name, multi_pod=multi_pod, verbose=False, mesh_shape=mesh_shape)
        rec["cost_mode"] = "direct(unrolled)"
        if verbose:
            print(json.dumps(rec, default=str))
        return rec

    units = _layer_units(cfg)
    seq, gb, kind = cfg_base.shape_of(shape_name)
    shape = tuple(mesh_shape) if mesh_shape else _mesh_shape(multi_pod)
    terms = []
    for u in (1, 2):
        mesh = _fake_mesh(shape)
        try:
            m = _measure(_layer_reduced(cfg, u), shape_name, mesh)
        finally:
            dist.destroy_process_group()
        terms.append({"flops": m["flops"], "bytes": float(m["argument_bytes"]),
                      "coll": float(m["collectives"]["total_bytes"])})

    def extrap(key):
        return terms[0][key] + (units - 1) * (terms[1][key] - terms[0][key])

    flops, bts, coll = extrap("flops"), extrap("bytes"), extrap("coll")
    mf, n_total, n_active = model_flops(cfg, seq, gb, kind)
    n_dev = 1
    for s in shape:
        n_dev *= s
    record = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "devices": n_dev, "cost_mode": "unroll-extrapolated",
        "layer_units": units,
        "hlo_flops": flops, "hlo_bytes": bts, "collective_bytes": coll,
        "params_total": n_total, "params_active": n_active,
        "model_flops_global": mf,
        "t_compute": flops / PEAK_FLOPS,
        "t_memory": bts / HBM_BW,
        "t_collective": coll / NVLINK_BW,
        "useful_flops_ratio": (mf / n_dev) / flops if flops else None,
    }
    t = {"compute": record["t_compute"], "memory": record["t_memory"], "collective": record["t_collective"]}
    record["bottleneck"] = max(t, key=t.get)
    record["roofline_frac"] = record["t_compute"] / max(max(t.values()), 1e-30)
    if verbose:
        print(json.dumps(record, default=str))
        sys.stdout.flush()
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=cfg_base.ARCH_IDS)
    ap.add_argument("--shape", choices=list(cfg_base.SHAPES))
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--cost-mode", action="store_true",
                    help="layer-unit cost extrapolation (see cost_corrected_cell)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    cells = cfg_base.cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    runner = cost_corrected_cell if args.cost_mode else run_cell
    records, failures = [], []
    for arch, shape in cells:
        for mp in meshes:
            try:
                records.append(runner(arch, shape, multi_pod=mp))
            except Exception as e:  # noqa: BLE001 — report all failures at end
                failures.append((arch, shape, mp, repr(e)))
                print(f"FAIL {arch} {shape} multi_pod={mp}: {e!r}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1, default=str)
        print(f"wrote {len(records)} records to {args.out}")
    if failures:
        print(f"{len(failures)} FAILURES", file=sys.stderr)
        for arch, shape, mp, err in failures:
            print(f"  {arch} {shape} multi_pod={mp}: {err}", file=sys.stderr)
        sys.exit(1)
    print(f"dry-run OK: {len(records)} cells ran")


if __name__ == "__main__":
    main()
