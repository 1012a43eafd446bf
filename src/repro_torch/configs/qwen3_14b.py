"""Qwen3-14B [hf:Qwen/Qwen3-8B family]: 40L, d=5120, 40H (GQA kv=8,
head_dim=128), d_ff=17408, vocab 151936, qk-norm. The same
numbers as the reference's ``repro.configs.qwen3_14b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3_14b_smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    qk_norm=True,
)
