"""`BatchedProblem`: B independent OT/UOT problems as one padded batch.

The port of ``repro.batch.problems``. Heterogeneous ``(n_i, m_i)``
supports are padded into a shared *bucket* shape ``(n, m)``, so one batch
runs one set of fixed-shape tensor ops:

* marginals are padded with **zero mass** (``a_i = 0`` beyond ``n_i``);
* costs are padded with ``+inf``, the `Geometry` blocked-entry convention,
  so ``K = 0`` / ``log K = -inf`` on every padded row and column.

Padding is inert through the scaling and log-domain iterations: padded
rows have ``a_i = 0`` and ``(K v)_i = 0``, so their scalings stay 0 by the
0-where-``Kv == 0`` division; padded atoms have ``log a_i = -inf``, which
the log loops pin. ``UOTProblem(lam=inf)`` and `OTProblem` both encode as
``lam = inf``, so one ``(B,)`` ``lam`` vector carries a mixed OT + UOT
batch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.core.api.problems import OTProblem, UOTProblem
from repro_torch.core.geometry import gibbs_kernel, log_gibbs_kernel

__all__ = ["BatchedProblem", "bucket_shape", "group_by_bucket"]


def bucket_shape(n: int, m: int, *, min_size: int = 64) -> tuple[int, int]:
    """Round ``(n, m)`` up to the next power-of-two bucket (floored at
    ``min_size``): a small set of shapes, so the executor's cache stays small."""

    def up(v: int) -> int:
        b = min_size
        while b < v:
            b *= 2
        return b

    return up(n), up(m)


def group_by_bucket(problems: Sequence[OTProblem], *, min_size: int = 64) -> dict[tuple[int, int], list[int]]:
    """Indices of ``problems`` grouped by their padded bucket shape."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, p in enumerate(problems):
        n, m = p.shape
        groups.setdefault(bucket_shape(n, m, min_size=min_size), []).append(i)
    return groups


def _pad_to(x: torch.Tensor, shape: tuple[int, ...], value: float) -> torch.Tensor:
    """``x`` in the leading corner of a ``shape`` tensor filled with ``value``."""
    if any(s < d for s, d in zip(shape, x.shape)):
        raise ValueError(f"bucket too small: need {tuple(x.shape)}, got {shape}")
    if tuple(x.shape) == tuple(shape):
        return x
    out = torch.full(shape, value, dtype=x.dtype, device=x.device)
    out[tuple(slice(0, d) for d in x.shape)] = x
    return out


@dataclass(eq=False)
class BatchedProblem:
    """B problems padded to one bucket shape: a plain dataclass of tensors on
    the problems' device (the bucket shape is carried by the tensor shapes)."""

    cost: torch.Tensor | None  # (B, n, m); +inf on padding/blocked. None on the
    #                            matrix-free path (materialize_cost=False)
    a: torch.Tensor  # (B, n); 0 on padding
    b: torch.Tensor  # (B, m); 0 on padding
    eps: torch.Tensor  # (B,)
    lam: torch.Tensor  # (B,); +inf encodes balanced OT
    n_sizes: torch.Tensor  # (B,) int32 true row counts
    m_sizes: torch.Tensor  # (B,) int32 true col counts

    @classmethod
    def from_problems(
        cls,
        problems: Sequence[OTProblem],
        *,
        bucket: tuple[int, int] | None = None,
        materialize_cost: bool = True,
    ) -> "BatchedProblem":
        """Pad and stack problems into one batch. All problems must fit the
        bucket and lie on one device; with ``bucket=None`` the largest
        support sizes are used.

        ``materialize_cost=False`` leaves ``cost = None``: the matrix-free
        ``spar_sink_mf`` path (and ``spar_sink_log``, whose sketches carry
        their gathered costs) never reads a (B, n, m) array, which a guarded
        `PointCloudGeometry` would refuse to build. ``kernel()`` and
        ``log_kernel()`` are then unavailable."""
        if not problems:
            raise ValueError("empty batch")
        devices = {p.device for p in problems}
        if len(devices) != 1:
            raise ValueError(f"the problems of a batch must lie on one device; got {sorted(map(str, devices))}")
        (dev,) = devices
        if bucket is None:
            bucket = (max(p.shape[0] for p in problems), max(p.shape[1] for p in problems))
        n, m = bucket
        dtype = problems[0].geom.dtype
        for p in problems[1:]:
            dtype = torch.promote_types(dtype, p.geom.dtype)
        costs = []
        if materialize_cost:
            costs = [_pad_to(p.geom.cost.to(dtype), (n, m), math.inf) for p in problems]
        return cls(
            cost=torch.stack(costs) if materialize_cost else None,
            a=torch.stack([_pad_to(p.a.to(dtype), (n,), 0.0) for p in problems]),
            b=torch.stack([_pad_to(p.b.to(dtype), (m,), 0.0) for p in problems]),
            eps=torch.tensor([float(p.eps) for p in problems], dtype=dtype, device=dev),
            lam=torch.tensor(
                [float(p.lam) if isinstance(p, UOTProblem) and not p.is_balanced else math.inf for p in problems],
                dtype=dtype, device=dev,
            ),
            n_sizes=torch.tensor([p.shape[0] for p in problems], dtype=torch.int32, device=dev),
            m_sizes=torch.tensor([p.shape[1] for p in problems], dtype=torch.int32, device=dev),
        )

    @property
    def batch(self) -> int:
        return self.a.shape[0]

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.a.shape[0], self.a.shape[1], self.b.shape[1])

    @property
    def device(self) -> torch.device:
        return self.a.device

    @property
    def is_balanced(self) -> torch.Tensor:
        """(B,) bool: which elements are balanced OT (``lam = inf``)."""
        return torch.isinf(self.lam)

    @property
    def fe(self) -> torch.Tensor:
        """(B,) scaling-update exponents ``lam/(lam+eps)`` (1 where balanced)."""
        return torch.where(torch.isinf(self.lam), 1.0, self.lam / (self.lam + self.eps))

    def kernel(self) -> torch.Tensor:
        """(B, n, m) Gibbs kernels; padded/blocked entries are exactly 0."""
        return gibbs_kernel(self.cost, self.eps[:, None, None])

    def log_kernel(self) -> torch.Tensor:
        """(B, n, m) log-kernels; padded/blocked entries are exactly -inf."""
        return log_gibbs_kernel(self.cost, self.eps[:, None, None])

    def row_mask(self) -> torch.Tensor:
        """(B, n) bool: True on real (non-padded) rows."""
        return torch.arange(self.a.shape[1], device=self.device)[None, :] < self.n_sizes[:, None]

    def col_mask(self) -> torch.Tensor:
        return torch.arange(self.b.shape[1], device=self.device)[None, :] < self.m_sizes[:, None]

    def __repr__(self) -> str:
        bsz, n, m = self.shape
        return f"BatchedProblem(B={bsz}, bucket={n}x{m})"
