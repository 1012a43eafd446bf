"""Production and test meshes on `torch.distributed`'s `DeviceMesh`.

The counterpart of the reference's ``repro.launch.mesh``. A mesh axis is a
`DeviceMesh` dimension named ``"pod"``, ``"data"`` or ``"model"``; the
functions build meshes when called, never at import, so that importing
touches no process-group state (the reference's reason for functions).

Each takes ``device_type``: ``"cuda"`` unless the caller asks for
``"cpu"``. With no process group yet, a world-1 group starts on a
`HashStore` (NCCL on ``cuda``, gloo on ``cpu``), so a one-device mesh needs
no network and no environment variables; ``"cuda"`` with no card raises.
A larger mesh needs a process group of its size: the gloo processes of the
CPU tests, the ranks of a multi-card launch, or the dry-run's fake group
(`repro_torch.launch.dryrun` sets that up itself).

`launch_ranks` starts the ranks of a local multi-process mesh (gloo on the
CPU, NCCL with one process a card); `run_ranks` does so only when no
launcher did (a process of ``torchrun`` is one rank already).
"""
from __future__ import annotations

import os
import signal
import tempfile
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["launch_ranks", "make_production_mesh", "make_test_mesh", "mesh_device", "run_ranks"]


def _ensure_group(device_type: str, size: int) -> None:
    """Start a world-1 group on a HashStore if none exists; check that the
    group has ``size`` ranks."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device_type="cpu" for a CPU mesh')
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not {device_type!r}")
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        # a rank of torchrun (or of any launcher that sets the env:// variables)
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"a mesh of {size} devices needs a process group of {size} ranks; "
                "start one (torch.distributed.init_process_group) before building the mesh"
            )
        backend = "nccl" if device_type == "cuda" else "gloo"
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != size:
        raise RuntimeError(f"the process group has {dist.get_world_size()} ranks; the mesh needs {size}")


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str) -> DeviceMesh:
    size = 1
    for s in shape:
        size *= s
    _ensure_group(device_type, size)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 devices on ("data", "model"); two pods, 2x16x16 = 512 on
    ("pod", "data", "model"), when ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0, device_type: str = "cuda") -> DeviceMesh:
    """A small mesh for the sharding tests: (data, model), or (pod, data,
    model) when ``pod``."""
    if pod:
        return _make_mesh((pod, data, model), ("pod", "data", "model"), device_type)
    return _make_mesh((data, model), ("data", "model"), device_type)


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rank_entry(rank: int, world: int, store_path: str, device_type: str, fn, args) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        fn(*args)
    except BaseException:
        traceback.print_exc()
        raise SystemExit(1)
    finally:
        dist.destroy_process_group()


def launch_ranks(fn, world: int, device_type: str, *args) -> int:
    """Run ``fn(*args)`` in ``world`` new local processes, each a rank of one
    process group (gloo on ``"cpu"``; NCCL on ``"cuda"``, rank r on card
    r) that meets over a `FileStore` in a fresh temporary directory, so no
    network is used. SIGTERM to this process is passed on to every rank.
    Returns 0 when every rank exits 0, else the first rank's nonzero code.
    ``fn`` and ``args`` must pickle (a module-level function)."""
    import multiprocessing

    if device_type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"a mesh of {world} cards needs {world}; {torch.cuda.device_count()} are visible")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_entry, args=(r, world, store, device_type, fn, args)) for r in range(world)]
        for p in procs:
            p.start()

        def forward(signum, frame):
            for p in procs:
                if p.is_alive():
                    p.terminate()

        old = signal.signal(signal.SIGTERM, forward)
        try:
            for p in procs:
                p.join()
        finally:
            signal.signal(signal.SIGTERM, old)
    return next((p.exitcode for p in procs if p.exitcode), 0)


def run_ranks(fn, world: int, device_type: str, *args) -> int:
    """Run ``fn(*args)`` as ``world`` ranks. In this process when ``world``
    is 1 or this process is a rank already: a process group is started, or
    a launcher such as ``torchrun`` set ``WORLD_SIZE`` (`_ensure_group`
    joins its group); else in ``world`` new local processes
    (`launch_ranks`). Returns 0, or the first failing rank's exit code."""
    if world == 1 or dist.is_initialized() or "WORLD_SIZE" in os.environ:
        fn(*args)
        return 0
    return launch_ranks(fn, world, device_type, *args)
