"""Fixed-support Wasserstein barycenters: IBP (paper Alg. 5) and Spar-IBP
(paper Alg. 6, Appendix A).

The port of ``repro.core.barycenter``. The kernels of the ``m`` input
measures are one shared ``(n, n)`` kernel or a stacked ``(m, n, n)`` one;
Spar-IBP iterates on ``m`` COO sketches drawn in order from one generator
with the column-factor probabilities

    p_{k,ij} = sqrt(b_{k,j}) / (n * sum_j sqrt(b_{k,j}))        (Alg. 6, step 2)

(rows uniform: the unknown barycenter is replaced by its uniform start).
Its products are sorted segment sums (rows, and columns through each
sketch's own column sort), deterministic on every device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch._device import as_tensor, make_generator
from repro_torch.core import sparsify
from repro_torch.core.sinkhorn import STATUS_CONVERGED, _run, _status_code

__all__ = [
    "IBPResult",
    "barycenter_sampling_probs",
    "ibp",
    "solve_barycenter",
    "spar_ibp",
]


class IBPResult(NamedTuple):
    q: torch.Tensor  # (n,) barycenter
    u: torch.Tensor  # (m, n) scalings
    v: torch.Tensor  # (m, n)
    n_iter: torch.Tensor
    err: torch.Tensor
    #: why the iteration stopped: a ``repro_torch.core.sinkhorn.STATUS_*`` code
    status: torch.Tensor | None = None

    @property
    def converged(self) -> torch.Tensor | None:
        return None if self.status is None else self.status == STATUS_CONVERGED


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def _ibp_loop(matvec, rmatvec, bs: torch.Tensor, w: torch.Tensor, n: int, *, tol: float, max_iter: int,
              dtype) -> IBPResult:
    """``matvec``/``rmatvec`` map the (m, n) stack of ``v``/``u`` to the
    (m, n) stack of ``K_k v_k``/``K_k^T u_k``."""
    m, dev = bs.shape[0], bs.device
    state = dict(
        q=torch.full((n,), 1.0 / n, dtype=dtype, device=dev),
        u=torch.ones((m, n), dtype=dtype, device=dev),
        v=torch.ones((m, n), dtype=dtype, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        err=torch.tensor(math.inf, dtype=dtype, device=dev),
    )

    def cond(s):
        return (s["err"] > tol) & (s["t"] < max_iter)

    def step(s):
        v_new = _safe_div(bs, rmatvec(s["u"]))
        Kv = matvec(v_new)
        # q <- prod_k (K_k v_k)^{w_k}, in log space; u is scaled by the new q
        # (Benamou et al. 2015's order: Alg. 5's fixed point, stable)
        logKv = torch.log(torch.where(Kv > 0, Kv, 1.0))
        q_new = torch.exp(torch.sum(w[:, None] * logKv, dim=0))
        q_new = torch.where(torch.all(Kv > 0, dim=0), q_new, 0.0)
        new = dict(q=q_new, u=_safe_div(q_new[None, :], Kv), v=v_new, t=s["t"] + 1,
                   err=torch.sum(torch.abs(q_new - s["q"])))
        return new, cond(new)

    s, _ = _run(state, cond(state), step, max_iter)
    q, err = s["q"], s["err"]
    bad = ~torch.isfinite(err) | ~torch.all(torch.isfinite(q))
    status = _status_code(bad, torch.all(q == 0), err, tol, False)
    return IBPResult(q, s["u"], s["v"], s["t"], err, status)


def ibp(Ks: torch.Tensor, bs: torch.Tensor, w: torch.Tensor, *, tol: float = 1e-6,
        max_iter: int = 1000) -> IBPResult:
    """Algorithm 5, IBP({K_k}, {b_k}, w, tol). A 2-D ``Ks`` is one kernel
    shared by all ``m`` measures (the fixed-support case), never replicated
    to ``(m, n, n)``."""
    n = Ks.shape[-1]
    if Ks.ndim == 2:
        matvec = lambda v: v @ Ks.T  # (m, n) @ K^T is the stack of K v_k
        rmatvec = lambda u: u @ Ks
    else:
        matvec = lambda v: torch.einsum("kij,kj->ki", Ks, v)
        rmatvec = lambda u: torch.einsum("kij,ki->kj", Ks, u)
    return _ibp_loop(matvec, rmatvec, bs, w, n, tol=tol, max_iter=max_iter, dtype=Ks.dtype)


def barycenter_sampling_probs(bs: torch.Tensor) -> torch.Tensor:
    """(m, n, n) element probabilities of Alg. 6 step 2 (constant along
    rows; an expanded view, no (m, n, n) storage)."""
    n = bs.shape[-1]
    sb = torch.sqrt(bs)
    col = sb / (n * torch.sum(sb, dim=-1, keepdim=True))
    return col[:, None, :].expand(bs.shape[0], n, n)


def spar_ibp(
    Ks: torch.Tensor,
    bs: torch.Tensor,
    w: torch.Tensor,
    s: float,
    *,
    generator: torch.Generator | None = None,
    seed: int | None = None,
    cap: int | None = None,
    tol: float = 1e-6,
    max_iter: int = 1000,
) -> tuple[IBPResult, torch.Tensor]:
    """Algorithm 6, Spar-IBP. Returns ``(result, stacked nnz)``.

    The ``m`` sketches are drawn in order from one random source
    (``generator``, or a new one seeded with ``seed``, on ``Ks``'s device);
    a 2-D ``Ks`` is one kernel shared by all measures, each still sketched
    apart.
    """
    from repro_torch.core.spar_sink import default_cap

    gen = make_generator(Ks.device, generator, seed)
    m = bs.shape[0]
    cap = default_cap(s) if cap is None else cap
    probs = barycenter_sampling_probs(bs)
    sks = [sparsify.sparsify_coo(gen, Ks if Ks.ndim == 2 else Ks[k], probs[k], s, cap) for k in range(m)]
    return _spar_ibp_on(sks, bs, w, tol=tol, max_iter=max_iter)


def _spar_ibp_on(sks, bs: torch.Tensor, w: torch.Tensor, *, tol: float,
                 max_iter: int) -> tuple[IBPResult, torch.Tensor]:
    """Everything of `spar_ibp` after the ``m`` sketches."""
    n = bs.shape[1]
    layouts = [(sparsify.row_offsets(sk), sparsify.col_layout(sk)) for sk in sks]

    def matvec(v):
        return torch.stack([sparsify.coo_matvec(sk, v[k], layouts[k][0]) for k, sk in enumerate(sks)])

    def rmatvec(u):
        return torch.stack([sparsify.coo_rmatvec(sk, u[k], layouts[k][1]) for k, sk in enumerate(sks)])

    res = _ibp_loop(matvec, rmatvec, bs, w, n, tol=tol, max_iter=max_iter, dtype=sks[0].vals.dtype)
    return res, torch.stack([sk.nnz for sk in sks])


def solve_barycenter(
    geom,
    bs: torch.Tensor,
    w: torch.Tensor,
    eps: float,
    *,
    method: str = "ibp",
    generator: torch.Generator | None = None,
    seed: int | None = None,
    s: float | None = None,
    cap: int | None = None,
    tol: float = 1e-6,
    max_iter: int = 1000,
) -> IBPResult:
    """Geometry-level barycenter front end (fixed shared support).

    The ``m`` measures share one Gibbs kernel from ``geom`` (a `Geometry`,
    or a cost matrix placed by the device rule); ``bs`` and ``w`` go to its
    device. ``method`` is ``"ibp"`` (Alg. 5, dense) or ``"spar_ibp"``
    (Alg. 6; needs ``s`` and ``generator`` or ``seed``).
    """
    from repro_torch.core.api import Geometry

    geom = geom if isinstance(geom, Geometry) else Geometry(geom)
    bs, w = as_tensor(bs, geom.device), as_tensor(w, geom.device)
    K = geom.kernel(eps)  # shared (n, n): never replicated per measure
    if method == "ibp":
        if generator is not None or seed is not None or s is not None or cap is not None:
            raise TypeError("method='ibp' takes no generator/seed/s/cap; did you mean method='spar_ibp'?")
        return ibp(K, bs, w, tol=tol, max_iter=max_iter)
    if method == "spar_ibp":
        if (generator is None and seed is None) or s is None:
            raise ValueError("method='spar_ibp' requires s= and generator= or seed=")
        res, _ = spar_ibp(K, bs, w, s, generator=generator, seed=seed, cap=cap, tol=tol, max_iter=max_iter)
        return res
    raise KeyError(f"unknown barycenter method {method!r}; available: ibp, spar_ibp")
