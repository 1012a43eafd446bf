"""Launches of the CUDA streaming Sinkhorn reductions (``csrc/fused_sinkhorn.cu``).

The counterpart of the reference's ``repro.kernels.fused_sinkhorn``:
``online_matvec`` (``out_i = sum_j exp(-C_ij/eps) v_j``) and ``online_lse``
(``out_i = LSE_j(-C_ij/eps + g_j/eps)``), with the Gibbs kernel recomputed
from the points and never stored. The checked wrappers are
`repro_torch.kernels.ops.online_matvec` and `~.online_lse`.
"""
from __future__ import annotations

from repro_torch.kernels.library import COSTS, launch


def _launch(name: str, xf, yf, wf, out, *, eps: float, cost: str, eta: float) -> None:
    launch(
        name, xf.device,
        xf.data_ptr(), yf.data_ptr(), wf.data_ptr(), xf.shape[0], yf.shape[0], xf.shape[1],
        float(eps), COSTS[cost], float(eta), out.data_ptr(),
    )


def _launch_online_matvec(xf, yf, vf, out, *, eps: float, cost: str, eta: float) -> None:
    """One counted launch of ``online_matvec`` on already-checked CUDA
    tensors (contiguous float32 points (n, d) and (m, d), float32 v (m,) and
    out (n,)), on the current stream; raises if the launch is refused."""
    _launch("online_matvec", xf, yf, vf, out, eps=eps, cost=cost, eta=eta)


def _launch_online_lse(xf, yf, gf, out, *, eps: float, cost: str, eta: float) -> None:
    """`_launch_online_matvec`'s counterpart for ``online_lse``, with g (m,)."""
    _launch("online_lse", xf, yf, gf, out, eps=eps, cost=cost, eta=eta)
