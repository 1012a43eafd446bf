"""Least bytes of one Sinkhorn iteration over a sorted-COO sketch.

Each of the two products, ``K~ v`` and ``K~^T u``, reads every kept
entry's value (8 bytes) and the index of the side it gathers (8 bytes)
once; the segment side is given by offsets, ``n + 1`` and ``m + 1`` int64
read once; the scalings (or potentials) of both sides are read once and
written once (float64). The log domain's segment logsumexp reads the same.
"""
from perfbench.roofline.peaks import HBM_BYTES_PER_S


def bytes_per_iteration(nnz: int, n: int, m: int) -> int:
    return 2 * nnz * 16 + (n + m + 2) * 8 + 2 * (n + m) * 8


def bound_ms(nnz: int, n: int, m: int) -> float:
    return bytes_per_iteration(nnz, n, m) / HBM_BYTES_PER_S * 1e3
