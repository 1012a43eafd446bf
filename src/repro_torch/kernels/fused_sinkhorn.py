"""Launches of the CUDA streaming Sinkhorn reductions (``csrc/fused_sinkhorn.cu``).

The counterpart of the reference's ``repro.kernels.fused_sinkhorn``:
``online_matvec`` (``out_i = sum_j exp(-C_ij/eps) v_j``) and ``online_lse``
(``out_i = LSE_j(-C_ij/eps + g_j/eps)``), with the Gibbs kernel recomputed
from the points and never stored. The checked wrappers are
`repro_torch.kernels.ops.online_matvec` and `~.online_lse`.

Each launch splits the columns into P slices (the library's
``online_slices`` picks P for the card, 1 to ``MAX_SLICES``) and combines
the slices' per-row partials in slice order; the scratch for them is
allocated here, since the kernels allocate nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.library import COSTS, launch, load

#: output rows a thread owns (``kRows`` in the source)
ROWS_PER_THREAD = 8
#: the most column slices a launch takes (``kMaxSlices`` in the source)
MAX_SLICES = 16


def slices_for(n: int, m: int, d: int, *, cost: str, lse: bool) -> int:
    """The column slices P that a launch over n rows, m columns of dimension
    d takes on the current device."""
    return load().online_slices(n, m, d, COSTS[cost], int(lse))


def _launch(name: str, xf, yf, wf, out, *, eps: float, cost: str, eta: float, slices) -> None:
    n, d = xf.shape
    lse = name == "online_lse"
    with torch.cuda.device(xf.device):
        p = slices or slices_for(n, yf.shape[0], d, cost=cost, lse=lse)
    part = None
    if p > 1:
        part = torch.empty((2 if lse else 1) * p * n, dtype=torch.float32, device=xf.device)
    launch(
        name, xf.device,
        xf.data_ptr(), yf.data_ptr(), wf.data_ptr(), n, yf.shape[0], d,
        float(eps), COSTS[cost], float(eta), p, None if part is None else part.data_ptr(),
        out.data_ptr(),
    )


def _launch_online_matvec(xf, yf, vf, out, *, eps: float, cost: str, eta: float,
                          slices: int | None = None) -> None:
    """One counted launch of ``online_matvec`` on already-checked CUDA
    tensors (contiguous float32 points (n, d) and (m, d), float32 v (m,) and
    out (n,)), on the current stream, over ``slices`` column slices (by
    default the library's choice); raises if the launch is refused."""
    _launch("online_matvec", xf, yf, vf, out, eps=eps, cost=cost, eta=eta, slices=slices)


def _launch_online_lse(xf, yf, gf, out, *, eps: float, cost: str, eta: float,
                       slices: int | None = None) -> None:
    """`_launch_online_matvec`'s counterpart for ``online_lse``, with g (m,)."""
    _launch("online_lse", xf, yf, gf, out, eps=eps, cost=cost, eta=eta, slices=slices)
