"""Training entry point: checkpointed and preemption-safe, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma_2b:smoke \\
        --steps 50 --seq 128 --batch 8 --device cpu

The counterpart of the reference's ``repro.launch.train``, with its CLI
and its loop: batches from the stateless `TokenPipeline` (step-addressed,
so a resumed run sees the same token stream), a checkpoint every
``--ckpt-every`` steps and at the end, SIGTERM or ``--max-seconds`` ends
the run with a checkpoint, and a rerun of the same command resumes from
the latest one. ``train_loop``'s ``extras_fn`` adds a family's stub inputs
(``{"images"}`` or ``{"frames"}``) to each step's batch, as the
reference's does. Runs on the card unless ``--device cpu``; with no card
the default raises. The reference's mesh sharding is not ported:
``--mesh`` takes ``1x1`` only.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch._device import as_tensor, resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import TokenPipeline
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import init_train_state, make_train_step

__all__ = ["main", "train_loop"]


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, *, device=None, log_every: int = 10,
               extras_fn=None, max_seconds: float = 0.0):
    """Train from step 0, or from the latest checkpoint in
    ``tcfg.checkpoint_dir``, to ``tcfg.total_steps``. ``extras_fn(step)``,
    if given, returns a dict of arrays or tensors added to that step's
    batch (moved to the device). Returns ``(state, history)``, ``history``
    the ``(step, metrics)`` pairs it logged."""
    dev = resolve_device(device)
    ckpt.install_preemption_handler()
    step_fn = make_train_step(cfg, tcfg)
    start = ckpt.latest_step(tcfg.checkpoint_dir)
    if start is not None:
        target = init_train_state(cfg, tcfg, device="meta")
        state = ckpt.restore_checkpoint(tcfg.checkpoint_dir, start, target, device=dev)
        print(f"resumed from step {start}")
        first = start
    else:
        state = init_train_state(cfg, tcfg, tcfg.seed, device=dev)
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
            m = {k: float(v) for k, v in metrics.items()}
            history.append((step, m))
            tok_s = tcfg.global_batch * tcfg.seq_len * (step - first + 1) / (time.time() - t0)
            print(f"step {step:5d}  loss {m['loss']:.4f}  ce {m['ce']:.4f}  "
                  f"gnorm {m['grad_norm']:.2f}  tok/s {tok_s:,.0f}")
        stop = ckpt.preempted() or (max_seconds and time.time() - t0 > max_seconds)
        if stop or (tcfg.checkpoint_every and (step + 1) % tcfg.checkpoint_every == 0):
            ckpt.save_checkpoint(tcfg.checkpoint_dir, step + 1, state, keep=tcfg.keep_checkpoints)
            if stop:
                print(f"checkpointed at step {step + 1} and exiting "
                      f"({'preempted' if ckpt.preempted() else 'time budget'})")
                return state, history
    ckpt.save_checkpoint(tcfg.checkpoint_dir, tcfg.total_steps, state, keep=tcfg.keep_checkpoints)
    return state, history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL; one card takes 1x1 only")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--max-seconds", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise ValueError(f"--mesh {args.mesh}: the port trains on one device (1x1); mesh sharding "
                         "(launch/mesh.py, distributed/sharding.py) is not ported yet (ROADMAP A-11.7/8)")
    cfg = configs.get(args.arch)
    tcfg = TrainConfig(
        seq_len=args.seq, global_batch=args.batch, lr=args.lr,
        total_steps=args.steps, checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every, grad_compression=args.compress_grads,
        warmup_steps=max(args.steps // 20, 5),
    )
    train_loop(cfg, tcfg, device=args.device, max_seconds=args.max_seconds)


if __name__ == "__main__":
    main()
