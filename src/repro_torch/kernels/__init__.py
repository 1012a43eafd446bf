"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers
(`repro_torch.kernels.ops`) and plain versions (`repro_torch.kernels.ref`).
Nothing here builds or loads a kernel at import.

The public names are those of the reference's ``repro.kernels``: the
batched COO reductions (`batched_coo_matvec`, `batched_coo_rmatvec`,
`batched_coo_logsumexp`) are plain torch here, as they are plain XLA there.
"""
from repro_torch.kernels.ops import (
    batched_block_ell_matvec,
    batched_coo_logsumexp,
    batched_coo_matvec,
    batched_coo_rmatvec,
    block_ell_matvec,
    fused_sinkhorn_solve,
    gathered_kernel,
    online_lse,
    online_matvec,
)

__all__ = [
    "batched_block_ell_matvec",
    "batched_coo_logsumexp",
    "batched_coo_matvec",
    "batched_coo_rmatvec",
    "block_ell_matvec",
    "fused_sinkhorn_solve",
    "gathered_kernel",
    "online_lse",
    "online_matvec",
]
