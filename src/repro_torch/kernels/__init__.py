"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers
(`repro_torch.kernels.ops`) and plain versions (`repro_torch.kernels.ref`).
Nothing here builds or loads a kernel at import."""
