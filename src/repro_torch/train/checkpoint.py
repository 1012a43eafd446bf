"""Checkpointing and preemption, in the reference's on-disk layout.

The counterpart of the reference's ``repro.train.checkpoint``::

    <dir>/step_<N>/
        shard_0.npz        flat {path -> array}, the reference's flat keys
        manifest.json      step, keys, shapes, dtypes, "complete": true

A save writes ``step_<N>.tmp``, fsyncs the manifest and renames it into
place, so a crash mid-save leaves the previous checkpoint as the latest
valid one; `latest_step` ignores torn or unreadable manifests; the newest
``keep`` checkpoints are kept. The flat keys are the reference's (a
NamedTuple field is ``.name``, so a `TrainState` saves as ``.params/...``,
``.opt/.step``, ``.opt/.m/...``), so a checkpoint of either package
restores in the other. Elastic resharding does not apply on one card:
there is one shard (the reference's host 0), and `restore_checkpoint`
places each leaf on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.tree import leaves_with_paths, unflatten

__all__ = [
    "install_preemption_handler",
    "latest_step",
    "preempted",
    "restore_checkpoint",
    "save_checkpoint",
]

_FLAT_SEP = "/"
_SHARD = "shard_0.npz"  # the reference's shard of host 0, the only one
_PREEMPTED = threading.Event()


def _flatten(tree) -> dict[str, torch.Tensor]:
    return {_FLAT_SEP.join(map(str, path)): leaf for path, leaf in leaves_with_paths(tree)}


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3) -> str:
    """Commit ``tree`` (a `TrainState` or any tree of tensors) for ``step``
    atomically; returns the checkpoint's directory."""
    arrays = {k: v.detach().cpu().numpy() for k, v in _flatten(tree).items()}
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, _SHARD), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "complete": True,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    for old in sorted(_committed_steps(directory))[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{old:08d}"), ignore_errors=True)
    return final


def _committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        try:
            with open(os.path.join(directory, name, "manifest.json")) as f:
                if json.load(f).get("complete"):
                    out.append(int(name[len("step_"):]))
        except (OSError, ValueError):  # a torn checkpoint (crash mid-save): ignored
            continue
    return out


def latest_step(directory: str) -> int | None:
    steps = _committed_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, target_tree, *, device=None):
    """A tree of ``target_tree``'s structure, leaves and dtypes read from the
    checkpoint of ``step``. Each leaf goes to ``device`` if given, else to
    its target leaf's device; a target on the ``meta`` device (shapes only,
    nothing allocated) with ``device=None`` means the card. A missing key
    raises `KeyError`, a shape that differs `ValueError`."""
    path = os.path.join(directory, f"step_{step:08d}", _SHARD)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    restored = []
    for key, like in _flatten(target_tree).items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        src = arrays[key]
        if tuple(src.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: {src.shape} vs {tuple(like.shape)}")
        dev = resolve_device(device) if device is not None or like.device.type == "meta" else like.device
        restored.append(torch.as_tensor(src).to(device=dev, dtype=like.dtype))
    return unflatten(target_tree, restored)


def install_preemption_handler() -> None:
    """SIGTERM sets a flag; the train loop saves and exits at the next step."""

    def _handler(signum, frame):
        _PREEMPTED.set()

    signal.signal(signal.SIGTERM, _handler)


def preempted() -> bool:
    return _PREEMPTED.is_set()
