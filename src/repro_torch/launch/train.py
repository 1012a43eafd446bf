"""Training entry point: mesh-sharded, checkpointed and preemption-safe.

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma_2b:smoke \\
        --steps 50 --seq 128 --batch 8 --device cpu [--mesh 2x4]

The counterpart of the reference's ``repro.launch.train``, with its CLI
and its loop: batches from the stateless `TokenPipeline` (step-addressed,
so a resumed run sees the same token stream), a checkpoint every
``--ckpt-every`` steps and at the end, SIGTERM or ``--max-seconds`` ends
the run with a checkpoint, and a rerun of the same command resumes from
the latest one. ``train_loop``'s ``extras_fn`` adds a family's stub inputs
(``{"images"}`` or ``{"frames"}``) to each step's batch, as the
reference's does. Runs on the card unless ``--device cpu``; with no card
the default raises.

``--mesh DxM`` trains on a D x M `DeviceMesh` (``make_test_mesh``): the
state placed by `param_specs`, the batch by `batch_specs`. A mesh of more
than one device needs as many ranks: under ``torchrun`` (``WORLD_SIZE``
set) or a process group already started, each process is one rank and
runs the loop; otherwise the command starts D x M local ranks itself
(`launch.mesh.run_ranks`: gloo processes with ``--device cpu``, one a
card with NCCL), forwards SIGTERM to them, and exits with the first
failing rank's code. The ranks agree on
stopping (an all-reduce of each rank's stop flag a step), so a preemption
checkpoints one step on every rank. Without ``--mesh`` the loop runs
on one device with plain tensors.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch._device import as_tensor, resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import make_test_mesh, mesh_device, run_ranks
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import init_train_state, make_train_step

__all__ = ["main", "train_loop"]


def _host(v) -> float:
    return float(v.full_tensor() if isinstance(v, DTensor) else v)


def _agree(stop: bool, mesh, dev) -> bool:
    """Whether any rank stops (every rank must stop at the same step)."""
    if mesh is None or mesh.size() == 1:
        return stop
    flag = torch.tensor([int(stop)], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag)


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, *, device=None, mesh=None, log_every: int = 10,
               extras_fn=None, max_seconds: float = 0.0):
    """Train from step 0, or from the latest checkpoint in
    ``tcfg.checkpoint_dir``, to ``tcfg.total_steps``. ``extras_fn(step)``,
    if given, returns a dict of arrays or tensors added to that step's
    batch (moved to the device). With a ``mesh`` the state is sharded by
    `param_specs` (a checkpoint restores onto it elastically, whatever mesh
    saved it), every rank runs the loop, and rank 0 prints. Returns
    ``(state, history)``, ``history`` the ``(step, metrics)`` pairs it
    logged."""
    dev = resolve_device(device) if mesh is None else mesh_device(mesh)
    rank0 = mesh is None or dist.get_rank() == 0
    ckpt.install_preemption_handler()
    step_fn = make_train_step(cfg, tcfg, mesh)
    start = ckpt.latest_step(tcfg.checkpoint_dir)
    if start is not None:
        target = init_train_state(cfg, tcfg, device="meta", mesh=mesh)
        state = ckpt.restore_checkpoint(tcfg.checkpoint_dir, start, target, device=dev)
        if rank0:
            print(f"resumed from step {start}", flush=True)
        first = start
    else:
        state = init_train_state(cfg, tcfg, tcfg.seed, device=dev, mesh=mesh)
        first = 0

    pipe = TokenPipeline(cfg.vocab_size, tcfg.seq_len, tcfg.global_batch, seed=tcfg.seed)
    t0 = time.time()
    history = []
    for step in range(first, tcfg.total_steps):
        batch = {"tokens": torch.as_tensor(pipe.batch(step), dtype=torch.int64, device=dev)}
        if extras_fn is not None:
            batch.update({k: as_tensor(v, dev) for k, v in extras_fn(step).items()})
        state, metrics = step_fn(state, batch)
        if step % log_every == 0 or step == tcfg.total_steps - 1:
            m = {k: _host(v) for k, v in metrics.items()}
            history.append((step, m))
            tok_s = tcfg.global_batch * tcfg.seq_len * (step - first + 1) / (time.time() - t0)
            if rank0:
                print(f"step {step:5d}  loss {m['loss']:.4f}  ce {m['ce']:.4f}  "
                      f"gnorm {m['grad_norm']:.2f}  tok/s {tok_s:,.0f}", flush=True)
        stop = _agree(bool(ckpt.preempted() or (max_seconds and time.time() - t0 > max_seconds)), mesh, dev)
        if stop or (tcfg.checkpoint_every and (step + 1) % tcfg.checkpoint_every == 0):
            ckpt.save_checkpoint(tcfg.checkpoint_dir, step + 1, state, keep=tcfg.keep_checkpoints)
            if stop:
                if rank0:
                    print(f"checkpointed at step {step + 1} and exiting "
                          f"({'preempted' if ckpt.preempted() else 'time budget'})", flush=True)
                return state, history
    ckpt.save_checkpoint(tcfg.checkpoint_dir, tcfg.total_steps, state, keep=tcfg.keep_checkpoints)
    return state, history


def _parse_mesh(text: str | None) -> tuple[int, int] | None:
    if text is None:
        return None
    try:
        data, model = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DATAxMODEL, e.g. 2x4") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {text!r}: both sizes must be at least 1")
    return data, model


def _run(args, device_type: str | None) -> None:
    """One rank's run (or the only one): the mesh, if any, then the loop."""
    cfg = configs.get(args.arch)
    tcfg = TrainConfig(
        seq_len=args.seq, global_batch=args.batch, lr=args.lr,
        total_steps=args.steps, checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every, grad_compression=args.compress_grads,
        warmup_steps=max(args.steps // 20, 5),
    )
    shape = _parse_mesh(args.mesh)
    if shape is None:
        train_loop(cfg, tcfg, device=args.device, max_seconds=args.max_seconds)
        return
    mesh = make_test_mesh(*shape, device_type=device_type)
    train_loop(cfg, tcfg, mesh=mesh, max_seconds=args.max_seconds)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None, help="DATAxMODEL, e.g. 2x4 (default: one device, no mesh)")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--max-seconds", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    shape = _parse_mesh(args.mesh)
    device_type = resolve_device(args.device).type
    world = 1 if shape is None else shape[0] * shape[1]
    code = run_ranks(_run, world, device_type, args, device_type)
    if code:
        sys.exit(code)


if __name__ == "__main__":
    main()
