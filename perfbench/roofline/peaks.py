"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the 700 W power limit). A roofline share is stated against these, with
the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12  # outside the tensor cores
FP32_FLOPS = 67e12  # outside the tensor cores
MEMORY_BYTES = 80e9
BF16_FLOPS = 989.4e12  # dense, on the tensor cores
