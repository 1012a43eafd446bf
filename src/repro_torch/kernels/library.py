"""The port's CUDA library: every ``csrc/*.cu`` built into one shared object.

Each source is compiled with ``nvcc`` for ``sm_90a`` (Hopper), all of them at
once in parallel processes, and the objects are linked into one shared
library with a plain C interface, loaded with `ctypes`. The build happens at
first use, never at import, into ``build/repro_torch_kernels/`` at the root
of the checkout (listed in ``.gitignore``), under a file name that carries a
hash of every source and the flags, so an edited source is rebuilt and an
unchanged tree is loaded as it is.

Every ``<name>_launch`` function of the library launches one kernel on the
stream it is given (its last argument; the online ones over P > 1 column
slices and ``block_ell_rmatvec`` a second that combines the partials;
``gathered_kernel`` and ``gathered_cost`` a pack of the points first;
``lru_scan_fwd`` and ``lru_scan_bwd`` a memset of their flags first), allocates nothing, and returns its
``cudaError_t``; `launch` passes PyTorch's current stream, raises on a code
other than 0 and counts the launch in `LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "CSRC", "LAUNCHES", "launch", "load", "ptxas_log", "reset_launch_counts"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
#: ptxas reports each kernel's registers, shared memory and spills (kept in `ptxas_log`)
PTXAS_FLAGS = ("-Xptxas=-v",)

#: the cost switch of every launch function
COSTS = {"sqeuclidean": 0, "wfr": 1}

_P, _I64, _INT, _F32, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_double
#: C signature (argument types) of each ``<name>_launch``, which returns int;
#: pointers and the stream are ``c_void_p`` so that no address is cut to 32 bits
SIGNATURES = {
    # x, y, points_f64, rows, cols, n, m, k, d, eps, wfr, eta, packed, k_out, c_out, bad_index, stream
    "gathered_kernel": (_P, _P, _INT, _P, _P, _I64, _I64, _I64, _INT, _F32, _INT, _F32, _P, _P, _P, _P, _P),
    # x, y, points_f64, rows, cols, n, m, k, d, wfr, eta, packed, c_out, bad_index, stream
    "gathered_cost": (_P, _P, _INT, _P, _P, _I64, _I64, _I64, _INT, _INT, _F64, _P, _P, _P, _P),
    # x, y, v, n, m, d, eps, wfr, eta, slices, part, out, stream
    "online_matvec": (_P, _P, _P, _I64, _I64, _INT, _F32, _INT, _F32, _INT, _P, _P, _P),
    # x, y, g, n, m, d, eps, wfr, eta, slices, part, out, stream
    "online_lse": (_P, _P, _P, _I64, _I64, _INT, _F32, _INT, _F32, _INT, _P, _P, _P),
    # vals, col_idx, v, row_ptr, nblocks, row_blocks, ell_rows, max_blocks, bk, col_blocks,
    # row_blocks_per_sketch, f64, out, bad_index, stream
    "block_ell_matvec": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _INT, _I64, _I64, _INT, _P, _P, _P),
    # vals, tile, urow, col_ptr, col_unit_ptr, u, units, tiles, u_blocks, bk, col_blocks,
    # f64, part, out, bad_index, stream
    "block_ell_rmatvec": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _INT, _I64, _INT, _P, _P, _P, _P),
    # a, b, h, batch, seq, width, chunk, part, stream
    "lru_scan_fwd": (_P, _P, _P, _I64, _I64, _I64, _I64, _P, _P),
    # a, h, g, da (or null), db, batch, seq, width, chunk, part, stream
    "lru_scan_bwd": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P, _P),
}

#: kernel name -> number of launches since the last `reset_launch_counts`
LAUNCHES: dict[str, int] = dict.fromkeys(SIGNATURES, 0)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
            "kernels cannot be built"
        )
    return str(path)


def _run_all(commands: list[list[str]]) -> list[str]:
    """Run the commands in parallel and return their outputs; raise with the
    output of the first that fails."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in commands
    ]
    outputs = [proc.communicate()[0] for proc in procs]  # waits for every process
    for cmd, proc, out in zip(commands, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n{out}")
    return outputs


def _build() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    target = BUILD_DIR / f"librepro_torch_kernels_{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        logs = _run_all([[nvcc, *NVCC_FLAGS, *PTXAS_FLAGS, "-c", "-o", obj, str(src)]
                         for src, obj in zip(sources, objects)])
        ptxas_log(target).write_text("".join(logs))  # before the library: a loader sees both
        lib = str(Path(tmp) / target.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects]])
        os.replace(lib, target)  # atomic: a concurrent loader sees all or nothing
    return target


def ptxas_log(target: Path | None = None) -> Path:
    """The compiler's report on every kernel of the library ``target`` (by
    default the one that `load` loads), written when it was built."""
    return (target or _build()).with_suffix(".ptxas.txt")


def load() -> ctypes.CDLL:
    """The built library with its C signatures declared (builds on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, f"{name}_launch")
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            # d -> the values in one packed point row of the gathered kernels
            lib.gathered_packed_stride.argtypes = [_INT]
            lib.gathered_packed_stride.restype = _INT
            # n, m, d, wfr, lse -> the column slices of an online launch
            lib.online_slices.argtypes = [_I64, _I64, _INT, _INT, _INT]
            lib.online_slices.restype = ctypes.c_int
            # batch, seq, width -> the chunk length of a forward and of a backward LRU scan
            for rule in (lib.lru_scan_chunk, lib.lru_scan_bwd_chunk):
                rule.argtypes = [_I64, _I64, _I64]
                rule.restype = _I64
            # backward (0/1), chunk -> the LRU scan's blocks an SM holds at once
            lib.lru_scan_blocks_per_sm.argtypes = [_INT, _I64]
            lib.lru_scan_blocks_per_sm.restype = _INT
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call ``<name>_launch(*args, stream)`` on ``device`` with PyTorch's
    current stream there; raise if it returns a CUDA error, else count one
    launch of ``name``. On the current device it enters no device context,
    whose switch and restore cost several microseconds of host time a
    launch (``chip_smoke.py --compare-with`` times both)."""
    lib = load()
    fn = getattr(lib, f"{name}_launch")
    current = torch.cuda.current_device()
    if device.index is None or device.index == current:
        code = fn(*args, torch.cuda.current_stream(current).cuda_stream)
    else:
        with torch.cuda.device(device):
            code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")
    LAUNCHES[name] += 1
