"""Build and load the CUDA gathered-kernel library (``csrc/gather_kernel.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` (Hopper) into a shared
library with a plain C interface, loaded with `ctypes`. The build happens at
first use, never at import, into ``build/repro_torch_kernels/`` at the root
of the checkout (listed in ``.gitignore``), under a file name that carries a
hash of the source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.
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

__all__ = ["BUILD_DIR", "SOURCE", "load"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "gather_kernel.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
            "gathered kernel cannot be built"
        )
    return str(path)


def _build() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    target = BUILD_DIR / f"libgather_kernel_{digest[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {SOURCE.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load() -> ctypes.CDLL:
    """The built library with its C signatures declared (builds on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.gathered_kernel_launch.argtypes = [
                ctypes.c_void_p,  # x
                ctypes.c_void_p,  # y
                ctypes.c_void_p,  # rows
                ctypes.c_void_p,  # cols
                ctypes.c_int64,  # n
                ctypes.c_int64,  # m
                ctypes.c_int64,  # k
                ctypes.c_int,  # d
                ctypes.c_float,  # eps
                ctypes.c_int,  # wfr
                ctypes.c_float,  # eta
                ctypes.c_void_p,  # k_out
                ctypes.c_void_p,  # c_out
                ctypes.c_void_p,  # bad_index
                ctypes.c_void_p,  # stream
            ]
            lib.gathered_kernel_launch.restype = ctypes.c_int
            lib.gathered_kernel_error_string.argtypes = [ctypes.c_int]
            lib.gathered_kernel_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib

