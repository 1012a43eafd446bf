"""`Geometry` and `PointCloudGeometry`: the ground-cost objects of the API.

A `Geometry` wraps a cost matrix and lazily builds the Gibbs kernel
``K = exp(-C/eps)`` / ``log K = -C/eps`` per ``eps``, keeping the last
``cache_size`` of each in an LRU cache. A `PointCloudGeometry` holds support
points instead, and never builds an (n, m) array above ``dense_guard``
points: the matrix-free solver reads costs and kernel values entry by entry
(`PointCloudGeometry.entries`).

Device rule (see `repro_torch._device`): numpy or Python data goes to
``device``, where ``None`` means ``"cuda"`` and raises without a card;
tensors stay where they lie.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch._device import as_tensor
from repro_torch.core.geometry import (
    euclidean_cost,
    gathered_cost,
    gibbs_kernel,
    log_gibbs_kernel,
    normalize_cost,
    squared_euclidean_cost,
    wfr_cost,
)

__all__ = ["Geometry", "PointCloudGeometry"]

_COST_FNS = {"sqeuclidean": squared_euclidean_cost, "euclidean": euclidean_cost}


class Geometry:
    """Ground cost + per-``eps`` lazy kernel cache.

    Construct with ``Geometry(C)`` / ``Geometry.from_cost(C)``,
    ``Geometry.from_points(x, y, cost=...)`` or ``Geometry.wfr(x, y, eta=...)``.
    """

    DEFAULT_CACHE_SIZE = 8

    def __init__(self, cost, *, scale=1.0, cache_size: int | None = None, device=None):
        self.cost = as_tensor(cost, device)
        self.scale = scale  # cost units per stored unit (see normalized())
        self.cache_size = self.DEFAULT_CACHE_SIZE if cache_size is None else cache_size
        self._kernels: OrderedDict[float, torch.Tensor] = OrderedDict()
        self._log_kernels: OrderedDict[float, torch.Tensor] = OrderedDict()

    @classmethod
    def from_cost(cls, cost, *, device=None) -> "Geometry":
        return cls(cost, device=device)

    @classmethod
    def from_points(cls, x, y=None, *, cost: str = "sqeuclidean", normalize: bool = False, device=None) -> "Geometry":
        try:
            cost_fn = _COST_FNS[cost]
        except KeyError:
            raise KeyError(f"unknown cost {cost!r}; available: {', '.join(sorted(_COST_FNS))}") from None
        x = as_tensor(x, device)
        y = None if y is None else as_tensor(y, device)
        geom = cls(cost_fn(x, y))
        return geom.normalized() if normalize else geom

    @classmethod
    def wfr(cls, x, y=None, *, eta: float = 1.0, d=None, device=None) -> "Geometry":
        x = as_tensor(x, device)
        y = None if y is None else as_tensor(y, device)
        d = None if d is None else as_tensor(d, device)
        return cls(wfr_cost(x, y, eta=eta, d=d))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.cost.shape[0], self.cost.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.cost.dtype

    @property
    def device(self) -> torch.device:
        return self.cost.device

    def normalized(self) -> "Geometry":
        """New `Geometry` with the finite cost scaled to ``[0, 1]``."""
        c, scale = normalize_cost(self.cost)
        return Geometry(c, scale=scale)

    def clear_cache(self) -> None:
        self._kernels.clear()
        self._log_kernels.clear()

    def _cached(self, cache: OrderedDict, eps: float, build) -> torch.Tensor:
        key = float(eps)
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        out = cache[key] = build(self.cost, eps)
        while len(cache) > self.cache_size:
            cache.popitem(last=False)
        return out

    def kernel(self, eps: float) -> torch.Tensor:
        """``K = exp(-C/eps)``, built once per ``eps`` and LRU-cached."""
        return self._cached(self._kernels, eps, gibbs_kernel)

    def log_kernel(self, eps: float) -> torch.Tensor:
        """``log K = -C/eps`` (``-inf`` where blocked), LRU-cached per ``eps``."""
        return self._cached(self._log_kernels, eps, log_gibbs_kernel)

    def __repr__(self) -> str:
        n, m = self.shape
        cached = sorted(set(self._kernels) | set(self._log_kernels))
        return f"Geometry({n}x{m}, device={self.device}, cached_eps={cached})"


class PointCloudGeometry(Geometry):
    """Matrix-free point-cloud geometry: support points + a cost name.

    Dense access (``.cost``, ``kernel()``, ``log_kernel()``) is guarded: it
    raises above ``dense_guard`` support points, and below it equals
    ``Geometry.from_points`` / ``Geometry.wfr``. The matrix-free solver uses

    * ``entries(rows, cols, eps)``: gathered ``(K_e, C_e)`` at k pairs;
    * ``cost_entries(rows, cols)``: raw costs only.

    Costs: ``"sqeuclidean"`` (paper Sec. 5.1) and ``"wfr"`` (Sec. 2.2).
    """

    DEFAULT_DENSE_GUARD = 8192

    def __init__(
        self,
        x,
        y=None,
        *,
        cost: str = "sqeuclidean",
        eta: float = 1.0,
        dense_guard: int | None = None,
        cache_size: int | None = None,
        device=None,
    ):
        if cost not in ("sqeuclidean", "wfr"):
            raise KeyError(f"unknown matrix-free cost {cost!r}; available: sqeuclidean, wfr")
        self.x = as_tensor(x, device)
        self.y = self.x if y is None else as_tensor(y, device)
        if self.y.device != self.x.device:
            raise ValueError(f"x and y lie on different devices: {self.x.device}, {self.y.device}")
        self.cost_name = cost
        self.eta = float(eta)
        self.dense_guard = self.DEFAULT_DENSE_GUARD if dense_guard is None else int(dense_guard)
        self.scale = 1.0
        self.cache_size = self.DEFAULT_CACHE_SIZE if cache_size is None else cache_size
        self._kernels = OrderedDict()
        self._log_kernels = OrderedDict()
        self._cost_cache: torch.Tensor | None = None

    @classmethod
    def from_cost(cls, cost, *, device=None):
        raise TypeError(
            "PointCloudGeometry is built from support points, not a cost "
            "matrix; use PointCloudGeometry(x, y, cost=...) or Geometry(C)"
        )

    @classmethod
    def from_points(cls, x, y=None, *, cost: str = "sqeuclidean", normalize: bool = False, device=None) -> "Geometry":
        geom = cls(x, y, cost=cost, device=device)
        return geom.normalized() if normalize else geom

    @classmethod
    def wfr(cls, x, y=None, *, eta: float = 1.0, d=None, device=None) -> "Geometry":
        if d is not None:
            raise TypeError(
                "precomputed pairwise distances are a dense (n, m) array; "
                "use Geometry.wfr(..., d=d) for that"
            )
        return cls(x, y, cost="wfr", eta=eta, device=device)

    def _check_guard(self, what: str) -> None:
        n, m = self.shape
        if max(n, m) > self.dense_guard:
            raise ValueError(
                f"PointCloudGeometry({n}x{m}) refuses dense {what} "
                f"materialization (dense_guard={self.dense_guard}); use "
                f"entries() or solve(..., method='spar_sink_mf')"
            )

    @property
    def cost(self) -> torch.Tensor:
        """Dense cost, guarded; equal to the `Geometry.from_points` matrix."""
        self._check_guard("cost")
        if self._cost_cache is None:
            if self.cost_name == "wfr":
                self._cost_cache = wfr_cost(self.x, self.y, eta=self.eta)
            else:
                self._cost_cache = squared_euclidean_cost(self.x, self.y)
        return self._cost_cache

    @property
    def shape(self) -> tuple[int, int]:
        return (self.x.shape[0], self.y.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    def normalized(self) -> "Geometry":
        """Dense-path escape hatch (guarded): normalizing needs the max cost."""
        self._check_guard("normalized cost")
        return super().normalized()

    def cost_entries(self, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """``C[rows, cols]`` in O(k d), in the points' dtype."""
        return gathered_cost(self.x, self.y, rows, cols, cost=self.cost_name, eta=self.eta)

    def entries(
        self, rows: torch.Tensor, cols: torch.Tensor, eps: float, *, impl: str = "auto"
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Gathered ``(K_e, C_e) = (exp(-C/eps), C)`` at k index pairs.

        ``impl``: ``"torch"`` (dtype-preserving gather + elementwise ops),
        ``"cuda"`` (the hand-written CUDA kernel, float32 outputs; CUDA
        tensors only), or ``"auto"``: the CUDA kernel for CUDA tensors, the
        torch path for CPU tensors.
        """
        if impl == "auto":
            impl = "cuda" if self.x.device.type == "cuda" else "torch"
        if impl == "cuda":
            if self.x.device.type != "cuda":
                raise ValueError(
                    f"impl='cuda' needs the points on a CUDA device; they are on {self.x.device}"
                )
            from repro_torch.kernels.ops import gathered_kernel

            return gathered_kernel(
                self.x, self.y, rows, cols, eps=float(eps), cost=self.cost_name, eta=self.eta
            )
        if impl != "torch":
            raise ValueError(f"unknown impl {impl!r}; available: auto, cuda, torch")
        c_e = self.cost_entries(rows, cols)
        return gibbs_kernel(c_e, float(eps)), c_e

    def __repr__(self) -> str:
        n, m = self.shape
        return (
            f"PointCloudGeometry({n}x{m}, cost={self.cost_name!r}, "
            f"device={self.device}, dense_guard={self.dense_guard})"
        )
