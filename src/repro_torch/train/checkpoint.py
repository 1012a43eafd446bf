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
restores in the other.

Sharded trees (DTensor leaves) save their global arrays: every rank
gathers each leaf (a collective), rank 0 writes the one shard file (the
reference's host 0), and the ranks meet at a barrier. Restores are
elastic: a target leaf that carries placements (a DTensor, on ``meta`` or
not, or a ``placements`` tree with a ``mesh``) gets its rank's slice of
the saved global array, cut on the host (the reference's per-shard
re-slicing), whatever mesh saved it.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch._device import resolve_device
from repro_torch.tree import leaves_with_paths, tree_map, unflatten

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


def _global(t: torch.Tensor) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3) -> str:
    """Commit ``tree`` (a `TrainState` or any tree of tensors) for ``step``
    atomically; returns the checkpoint's directory. With DTensor leaves
    every rank must call it: the leaves are gathered, rank 0 writes."""
    arrays = {k: _global(v) for k, v in _flatten(tree).items()}
    final = os.path.join(directory, f"step_{step:08d}")
    if _rank() == 0:
        _commit(directory, step, arrays, final, keep)
    _barrier()
    return final


def _commit(directory: str, step: int, arrays: dict, final: str, keep: int) -> None:
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


def _shard_of(src: np.ndarray, mesh, placements, dtype, dev) -> DTensor:
    """This rank's slice of the global array ``src`` under ``placements``,
    cut on the host, as a DTensor of ``src``'s global shape."""
    local_shape, offset = compute_local_shape_and_global_offset(src.shape, mesh, placements)
    local = src[tuple(slice(o, o + n) for o, n in zip(offset, local_shape))]
    local = torch.as_tensor(np.ascontiguousarray(local)).to(device=dev, dtype=dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(src.shape),
                              stride=torch.empty(src.shape, device="meta").stride())


def restore_checkpoint(directory: str, step: int, target_tree, *, device=None, mesh=None, placements=None):
    """A tree of ``target_tree``'s structure, leaves and dtypes read from the
    checkpoint of ``step``. Each leaf goes to ``device`` if given, else to
    its target leaf's device; a target on the ``meta`` device (shapes only,
    nothing allocated) with ``device=None`` means the card. A missing key
    raises `KeyError`, a shape that differs `ValueError`.

    Elastic restore: a DTensor target leaf (on ``meta`` or not), or a leaf
    given placements by ``placements`` (a tree of ``target_tree``'s
    structure, e.g. from `repro_torch.distributed.param_specs`) on
    ``mesh``, comes back as a DTensor of its global shape holding this
    rank's slice of the saved array, on the mesh's device type (the card's
    current device for ``cuda``)."""
    path = os.path.join(directory, f"step_{step:08d}", _SHARD)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    flat = _flatten(target_tree)
    pls = [None] * len(flat) if placements is None else [pl for _, pl in _placement_leaves(target_tree, placements)]
    restored = []
    for (key, like), pl in zip(flat.items(), pls):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        src = arrays[key]
        if tuple(src.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: {src.shape} vs {tuple(like.shape)}")
        on_mesh, leaf_pl = (like.device_mesh, like.placements) if isinstance(like, DTensor) else (mesh, pl)
        if leaf_pl is not None:
            if on_mesh is None:
                raise ValueError("placements= needs mesh=")
            dev = torch.device(on_mesh.device_type, torch.cuda.current_device()) \
                if on_mesh.device_type == "cuda" else torch.device(on_mesh.device_type)
            restored.append(_shard_of(src, on_mesh, tuple(leaf_pl), like.dtype, dev))
            continue
        dev = resolve_device(device) if device is not None or like.device.type == "meta" else like.device
        restored.append(torch.as_tensor(src).to(device=dev, dtype=like.dtype))
    return unflatten(target_tree, restored)


def _placement_leaves(tree, placements):
    """``(leaf, its placements)`` in `leaves` order, the placements taken
    from the same place of ``placements`` (whose leaves are tuples)."""
    out = []
    tree_map(lambda leaf, pl: out.append((leaf, pl)), tree, placements)
    return out


def install_preemption_handler() -> None:
    """SIGTERM sets a flag; the train loop saves and exits at the next step."""

    def _handler(signum, frame):
        _PREEMPTED.set()

    signal.signal(signal.SIGTERM, _handler)


def preempted() -> bool:
    return _PREEMPTED.is_set()
