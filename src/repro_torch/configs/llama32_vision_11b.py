"""Llama-3.2-Vision-11B [hf:meta-llama/Llama-3.2-11B-Vision; unverified]:
40L text backbone, d=4096, 32H (GQA kv=8), d_ff=14336, vocab 128256, with
cross-attention image layers every 5th layer. The vision frontend is a STUB:
the caller feeds precomputed patch embeddings (B, 1600, d_model). The same
numbers as the reference's ``repro.configs.llama32_vision_11b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama32_vision_11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_period=5,
    num_image_tokens=1600,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama32_vision_smoke",
    family="vlm",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    cross_attn_period=5,
    num_image_tokens=16,
)
