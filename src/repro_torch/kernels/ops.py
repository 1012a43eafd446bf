"""Wrappers around the port's hand-written kernels.

A wrapper checks what it is given, launches its kernel on PyTorch's current
stream for CUDA tensors, and counts the launch. For CPU tensors it runs the
kernel's plain version (`repro_torch.kernels.ref`); nothing else selects
the plain version, and a failed build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import gathered_kernel_ref

__all__ = ["LAUNCHES", "gathered_kernel", "reset_launch_counts"]

#: kernel name -> number of launches since the last `reset_launch_counts`
LAUNCHES: dict[str, int] = {"gathered_kernel": 0}

_COSTS = {"sqeuclidean": 0, "wfr": 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gathered_kernel(
    x: torch.Tensor,
    y: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    *,
    eps: float,
    cost: str = "sqeuclidean",
    eta: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(K_e, C_e) = (exp(-C(x_i,y_j)/eps), C(x_i,y_j))`` at k index pairs.

    Shapes ``(n,d),(m,d),(k,),(k,) -> ((k,),(k,))``, both outputs float32;
    points of another float dtype are cast to float32 first. WFR pairs
    beyond range come out exactly ``(0, +inf)``. CUDA tensors go through the
    CUDA kernel (``csrc/gather_kernel.cu``); CPU tensors through
    `gathered_kernel_ref`.
    """
    if cost not in _COSTS:
        raise ValueError(f"unknown cost {cost!r}; available: {', '.join(_COSTS)}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"points must be (n, d) and (m, d); got {tuple(x.shape)}, {tuple(y.shape)}")
    if rows.ndim != 1 or rows.shape != cols.shape:
        raise ValueError(f"rows/cols must be equal-length 1-d; got {tuple(rows.shape)}, {tuple(cols.shape)}")
    if not (x.is_floating_point() and y.is_floating_point()):
        raise TypeError(f"points must be floating point; got {x.dtype}, {y.dtype}")
    devices = {t.device for t in (x, y, rows, cols)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device; got {sorted(map(str, devices))}")
    dev = x.device
    if dev.type == "cpu":
        return gathered_kernel_ref(x, y, rows, cols, eps=eps, cost=cost, eta=eta)
    if dev.type != "cuda":
        raise ValueError(f"gathered_kernel runs on CUDA or CPU tensors, not {dev.type}")
    if rows.dtype != torch.int64 or cols.dtype != torch.int64:
        raise TypeError(f"rows/cols must be int64; got {rows.dtype}, {cols.dtype}")
    if not (rows.is_contiguous() and cols.is_contiguous()):
        raise ValueError("rows/cols must be contiguous")
    k = rows.shape[0]
    k_out = torch.empty(k, dtype=torch.float32, device=dev)
    c_out = torch.empty(k, dtype=torch.float32, device=dev)
    if k == 0:
        return k_out, c_out
    xf = x.to(torch.float32).contiguous()
    yf = xf if y is x else y.to(torch.float32).contiguous()
    bad_index = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch_gathered_kernel(xf, yf, rows, cols, k_out, c_out, bad_index, eps=eps, cost=cost, eta=eta)
    # the kernel range-checks every index as it reads it (no extra pass);
    # reading its flag waits for the launch to finish
    if bool(bad_index):
        raise IndexError("rows/cols out of range of the point arrays")
    return k_out, c_out


def _launch_gathered_kernel(xf, yf, rows, cols, k_out, c_out, bad_index, *, eps: float, cost: str, eta: float) -> None:
    """One counted launch of the CUDA kernel on already-checked CUDA tensors
    (contiguous float32 points, int64 indices, float32 outputs, a zeroed
    int32 flag that the kernel sets on an out-of-range index), on the
    current stream; raises if the launch is refused."""
    from repro_torch.kernels.gather_kernel import load

    lib = load()
    dev = xf.device
    with torch.cuda.device(dev):
        code = lib.gathered_kernel_launch(
            xf.data_ptr(), yf.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            xf.shape[0], yf.shape[0], rows.shape[0], xf.shape[1], float(eps), _COSTS[cost], float(eta),
            k_out.data_ptr(), c_out.data_ptr(), bad_index.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if code != 0:
        msg = lib.gathered_kernel_error_string(code).decode()
        raise RuntimeError(f"gathered_kernel launch failed: {msg} (cudaError {code})")
    LAUNCHES["gathered_kernel"] += 1
