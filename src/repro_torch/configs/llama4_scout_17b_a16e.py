"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
48L, d=5120, 40H (GQA kv=8, head_dim=128), d_ff=8192 per expert, vocab 202048,
MoE 16 experts top-1 (early fusion — text backbone here per spec). The same
numbers as the reference's ``repro.configs.llama4_scout_17b_a16e``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4_scout_17b_a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    router="sinkhorn",
)

SMOKE = ModelConfig(
    name="llama4_scout_smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=48,
    vocab_size=256,
    num_experts=4,
    experts_per_token=1,
    router="sinkhorn",
)
