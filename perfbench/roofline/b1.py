"""Least bytes of one launch of kernel B1, the gathered kernel
(``csrc/gather_kernel.cu``: ``pack_rows`` and the gather), in both modes.

The points are read once (the cells' source and target supports are one
set, float64 as the program holds them), both index arrays of the k slots
once (int64), and the outputs written once: the float32 kernel value and
float32 cost of a slot in the scaling domain's mode, the float64 cost in
the log domain's cost-only mode; 8 bytes a slot either way. The pack's
own traffic is not counted: it is the kernel's choice, not the work's.
At n = 2^17, d = 5, k = 10,127,143 this is 248,294,312 bytes, 0.0741 ms
at 3.35 TB/s.
"""
from perfbench.roofline.peaks import HBM_BYTES_PER_S

#: bytes written a slot, by mode
OUT_BYTES = {"kernel": 8, "cost": 8}


def bytes_per_launch(n: int, d: int, k: int, mode: str = "kernel") -> int:
    return n * d * 8 + 2 * k * 8 + k * OUT_BYTES[mode]


def bound_ms(n: int, d: int, k: int, mode: str = "kernel") -> float:
    return bytes_per_launch(n, d, k, mode) / HBM_BYTES_PER_S * 1e3
