"""Problem objects: marginals + regularization bound to a `Geometry`.

`OTProblem` is balanced entropic OT (paper eq. 6); `UOTProblem` is
unbalanced entropic OT with marginal-KL penalty ``lam`` (paper eq. 10).
``UOTProblem(lam=inf)`` degenerates exactly to the balanced problem
(``fe = lam/(lam+eps) -> 1``).

Device rule: a cost matrix given as numpy data becomes a `Geometry` on
``device`` (``None`` means ``"cuda"``); the marginals go to ``device`` if
given, else to the geometry's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from repro_torch._device import as_tensor
from repro_torch.core.api.geometry import Geometry, PointCloudGeometry
from repro_torch.core.sinkhorn import ot_cost_from_plan, uot_cost_from_plan

__all__ = ["InvalidProblem", "OTProblem", "UOTProblem"]


class InvalidProblem(ValueError):
    """Problem data that cannot produce a meaningful solve: NaN/negative/
    all-zero marginals, NaN or ``-inf`` costs, non-finite support points, or
    a non-positive/non-finite ``eps`` (``+inf`` costs are blocked pairs and
    pass). Raised at construction and as a backstop at ``solve()`` entry;
    ``validate=False`` skips the checks."""


@dataclass(eq=False)  # tensor fields: a generated __eq__ would not compare
class OTProblem:
    """Balanced entropic OT: ``min <T,C> - eps H(T)`` s.t. exact marginals."""

    geom: Geometry
    a: torch.Tensor
    b: torch.Tensor
    eps: float
    validate: bool = field(default=True, kw_only=True, repr=False)
    device: str | torch.device | None = field(default=None, kw_only=True, repr=False)

    def __post_init__(self):
        if not isinstance(self.geom, Geometry):
            self.geom = Geometry(self.geom, device=self.device)
        dev = self.geom.device if self.device is None else self.device
        self.a = as_tensor(self.a, dev)
        self.b = as_tensor(self.b, dev)
        self.device = self.a.device
        self._checked = False
        if self.validate:
            self.check_valid()

    def check_valid(self) -> "OTProblem":
        """Raise `InvalidProblem` on unsolvable inputs (at most once)."""
        if self._checked or not self.validate:
            return self
        self._validate()
        self._checked = True
        return self

    def _invalid(self, msg: str) -> None:
        raise InvalidProblem(
            f"{type(self).__name__}{self.shape}: {msg} (pass validate=False to skip input validation)"
        )

    def _validate(self) -> None:
        eps = float(self.eps)
        if not math.isfinite(eps) or eps <= 0:
            self._invalid(f"eps must be finite and > 0, got {eps}")
        for name, w in (("a", self.a), ("b", self.b)):
            if w.device != self.geom.device:
                self._invalid(f"marginal {name!r} is on {w.device}, the geometry on {self.geom.device}")
            if not bool(torch.all(torch.isfinite(w))):
                self._invalid(f"marginal {name!r} has non-finite entries")
            if bool(torch.any(w < 0)):
                self._invalid(f"marginal {name!r} has negative entries")
            if not bool(torch.sum(w) > 0):
                self._invalid(f"marginal {name!r} carries no mass (all zero)")
        geom = self.geom
        if isinstance(geom, PointCloudGeometry):
            # finite support points imply finite sqeuclidean/WFR costs;
            # never build the (possibly guarded) dense cost here
            for name, pts in (("x", geom.x), ("y", geom.y)):
                if not bool(torch.all(torch.isfinite(pts))):
                    self._invalid(f"point cloud {name!r} has non-finite entries")
        elif bool(torch.any(torch.isnan(geom.cost) | torch.isneginf(geom.cost))):
            self._invalid("cost matrix has NaN or -inf entries")

    @property
    def shape(self) -> tuple[int, int]:
        return (self.a.shape[0], self.b.shape[0])

    @property
    def is_balanced(self) -> bool:
        return True

    @property
    def fe(self) -> float:
        """Scaling-update exponent (``1`` for balanced OT)."""
        return 1.0

    def kernel(self) -> torch.Tensor:
        return self.geom.kernel(self.eps)

    def log_kernel(self) -> torch.Tensor:
        return self.geom.log_kernel(self.eps)

    def objective(self, plan: torch.Tensor) -> torch.Tensor:
        """Primal entropic objective of a dense plan (paper eq. 6)."""
        return ot_cost_from_plan(plan, self.geom.cost, self.eps)


@dataclass(eq=False)
class UOTProblem(OTProblem):
    """Unbalanced entropic OT with marginal penalty ``lam`` (paper eq. 10)."""

    lam: float = field(default=1.0)

    def _validate(self) -> None:
        lam = float(self.lam)
        if math.isnan(lam) or lam <= 0:  # lam = +inf is the balanced limit
            self._invalid(f"lam must be > 0 (inf = balanced), got {lam}")
        super()._validate()

    @property
    def is_balanced(self) -> bool:
        return math.isinf(self.lam)

    @property
    def fe(self) -> float:
        if math.isinf(self.lam):
            return 1.0
        return self.lam / (self.lam + self.eps)

    def objective(self, plan: torch.Tensor) -> torch.Tensor:
        if self.is_balanced:  # lam = inf: the KL terms vanish at feasibility
            return ot_cost_from_plan(plan, self.geom.cost, self.eps)
        return uot_cost_from_plan(plan, self.geom.cost, self.a, self.b, self.lam, self.eps)
