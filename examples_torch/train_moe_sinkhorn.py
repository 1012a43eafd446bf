"""End-to-end driver on the PyTorch port: train a ~100M-parameter MoE LM
whose router solves a token-expert OT problem with (Spar-)Sinkhorn, the
paper's technique as a first-class framework feature.

The default is a small run of ``olmoe_1b_7b:smoke``; ``--hundred-m``
selects the reference's ~100M config (`HUNDRED_M`, 142,680,576
parameters with its untied 32768 x 512 embedding and unembedding) at
sequence 512, batch 8:

    PYTHONPATH=src python examples_torch/train_moe_sinkhorn.py --device cpu  # smoke
    PYTHONPATH=src python examples_torch/train_moe_sinkhorn.py --hundred-m   # full, on the card

The counterpart of ``examples/train_moe_sinkhorn.py``, through the port's
`repro_torch.launch.train.train_loop`. Checkpoints go to ``--ckpt-dir``
(alias ``--out-dir``); a rerun with the same directory resumes from its
latest checkpoint instead of starting over. ``--mesh DxM`` other than
``1x1`` (one device, no mesh) trains on a `DeviceMesh` of that shape
(`repro_torch.launch.mesh.make_test_mesh`), which needs a process group of
D x M ranks: run the example under ``torchrun --nproc-per-node D*M``.
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import _parse_mesh, train_loop

HUNDRED_M = ModelConfig(
    name="moe_100m_sinkhorn",
    family="moe",
    num_layers=8,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=32768,
    num_experts=16,
    experts_per_token=2,
    router="spar_sink",  # the paper's sparsified Sinkhorn router
    router_sample_frac=0.5,
    remat="none",
)  # 142,680,576 parameters (the reference's comment says ~105M)


def main(argv=None):
    ap = argparse.ArgumentParser(description="train a MoE LM with a (Spar-)Sinkhorn router")
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--router", default="spar_sink", choices=["softmax", "sinkhorn", "spar_sink"])
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL; other than 1x1 needs D*M ranks (torchrun)")
    ap.add_argument("--ckpt-dir", "--out-dir", dest="ckpt_dir", default="/tmp/repro_moe_ckpt")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    shape = _parse_mesh(args.mesh)
    device = resolve_device(args.device)
    mesh = None if shape == (1, 1) else make_test_mesh(*shape, device_type=device.type)
    if args.hundred_m:
        cfg = HUNDRED_M.replace(router=args.router)
        tcfg = TrainConfig(seq_len=512, global_batch=8, lr=6e-4,
                           total_steps=args.steps or 300, warmup_steps=20,
                           checkpoint_every=100, checkpoint_dir=args.ckpt_dir)
    else:
        cfg = configs.get("olmoe_1b_7b:smoke").replace(router=args.router)
        tcfg = TrainConfig(seq_len=128, global_batch=8, lr=1e-3,
                           total_steps=args.steps or 60, warmup_steps=5,
                           checkpoint_every=50, checkpoint_dir=args.ckpt_dir)

    _, history = train_loop(cfg, tcfg, device=device if mesh is None else None, mesh=mesh)
    if not history:
        print(f"nothing to train: {args.ckpt_dir} already holds step {tcfg.total_steps}")
        return {"history": history}
    first, last = history[0][1]["loss"], history[-1][1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} with router={args.router}")
    return {"history": history}


if __name__ == "__main__":
    main()
