"""Serving entry points: the prefill step, and batched greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma_2b:smoke \\
        --batch 4 --prompt-len 16 --gen 32 --device cpu

The counterpart of the reference's ``repro.launch.serve`` (the decode
loop) and of the prefill step of ``repro.launch.specs`` (next-token logits
of the last position of a whole prompt, the ``prefill_32k`` cell's step).
As in the reference, `serve` feeds the prompt token by token through
``decode_step`` and then decodes greedily. Both serve every family
(``--arch mamba2_130m:smoke`` or ``whisper_large_v3:smoke``, say); the
MoE routers' draws come from generators seeded 0, as the reference's come
from ``PRNGKey(0)``. The vlm and audio families take stub memories, as in
the reference: `serve` draws the image embeddings or the encoder output
and fills the cross cache from them. Runs on the card unless ``device``
names the CPU; with no card, ``device=None`` raises. ``--mesh DxM``
serves on a mesh, as the reference's ``--mesh`` does (its ranks started
as ``launch.train`` starts them).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_test_mesh, mesh_device, run_ranks
from repro_torch.launch.train import _parse_mesh
from repro_torch.models import forward, init_decode_state, init_params
from repro_torch.models.lm import fill_cross_cache
from repro_torch.train.step import make_serve_step, place_batch

__all__ = ["prefill_step", "serve"]


def prefill_step(params, tokens: torch.Tensor, cfg: ModelConfig, extras=None) -> torch.Tensor:
    """Serving semantics of a prompt: next-token logits for the last
    position only, (B, S) -> (B, V) float32. ``extras`` as `forward`
    takes them (``{"images"}`` or ``{"frames"}``)."""
    logits, _ = forward(params, tokens, cfg, extras, last_only=True)
    return logits[:, -1, :]


def _stub_memory(cfg: ModelConfig, batch: int, seed: int, device):
    """The reference's stub memory for the vlm and audio families (None
    for the others): N(0, 1) in bf16, drawn on the CPU from ``seed``."""
    if cfg.family == "vlm":
        key, length = "images", cfg.num_image_tokens
    elif cfg.family == "audio":
        key, length = "enc_out", cfg.num_frames
    else:
        return None
    gen = torch.Generator().manual_seed(seed)
    draw = torch.randn((batch, length, cfg.d_model), generator=gen)
    return {key: draw.to(torch.bfloat16).to(device)}


@torch.no_grad()
def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int, seed: int = 0, device=None,
          params=None, mesh=None) -> np.ndarray:
    """Greedy decode of ``batch`` random prompts of ``prompt_len`` tokens,
    ``gen`` tokens each; returns the (batch, prompt_len + gen) tokens.

    Parameters are drawn from ``seed`` on ``device`` unless given. The
    prompt tokens come from a CPU `torch.Generator` seeded with ``seed``,
    and so does the stub memory (vlm: images (batch, num_image_tokens, d);
    audio: the encoder output (batch, num_frames, d); bf16, from a second
    such generator), so a seed gives the same prompts and memory on every
    device. Prints the decoded count and tok/s, then ``sample:`` and the
    first sequence's first 32 tokens, as the reference does.

    With a ``mesh`` (the reference's ``serve(cfg, mesh, ...)``) the
    parameters are placed by `param_specs`, the decode state by
    `decode_state_specs` and each step's tokens by `batch_specs`, and the
    steps run under `use_mesh`; every rank decodes, rank 0 prints.
    """
    dev = resolve_device(device) if mesh is None else mesh_device(mesh)
    if params is None:
        params = init_params(cfg, seed, device=dev)
    total = prompt_len + gen
    state = init_decode_state(cfg, batch, total, device=dev)
    extras = _stub_memory(cfg, batch, seed, dev)
    if extras is not None:
        state = fill_cross_cache(params, cfg, state, extras)
    if mesh is not None:
        params = shd.distribute(params, mesh, shd.param_specs(params, cfg, mesh))
        state = shd.distribute(state, mesh, shd.decode_state_specs(cfg, mesh, state, batch))
    prompt_gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1), generator=prompt_gen).to(dev)
    out = [tokens.cpu().numpy()]
    step = make_serve_step(cfg, mesh)
    t0 = time.time()
    for i in range(total - 1):
        logits, state = step(params, state, place_batch({"tokens": tokens}, cfg, mesh)["tokens"], i, extras)
        if i >= prompt_len - 1:
            tokens = torch.argmax(logits[:, -1:], dim=-1)
            if isinstance(tokens, DTensor):
                tokens = tokens.full_tensor()
        else:
            tokens = torch.randint(0, cfg.vocab_size, (batch, 1), generator=prompt_gen).to(dev)
        out.append(tokens.cpu().numpy())  # waits for the step
    dt = time.time() - t0
    seqs = np.concatenate(out, axis=1)
    if mesh is None or dist.get_rank() == 0:
        print(f"decoded {batch}x{total} tokens in {dt:.2f}s ({batch * total / dt:,.0f} tok/s)")
        print("sample:", seqs[0, : min(32, total)].tolist())
    return seqs


def _run(args, device_type: str) -> None:
    cfg = configs.get(args.arch)
    mesh = None
    if args.mesh is not None:
        data, model = _parse_mesh(args.mesh)
        mesh = make_test_mesh(data, model, device_type=device_type)
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen, device=args.device, mesh=mesh)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mesh", default=None, help="DATAxMODEL, e.g. 2x4 (default: one device, no mesh)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device_type = resolve_device(args.device).type
    shape = _parse_mesh(args.mesh)
    world = 1 if shape is None else shape[0] * shape[1]
    code = run_ranks(_run, world, device_type, args, device_type)
    if code:
        sys.exit(code)


if __name__ == "__main__":
    main()
