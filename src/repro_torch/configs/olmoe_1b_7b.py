"""OLMoE-1B-7B [arXiv:2409.02060]: 16L, d=2048, 16H (MHA, kv=16), per-expert
d_ff=1024, vocab 50304, 64 experts top-8. The flagship Spar-Sink-router arch
(64 experts => the token-expert OT problem is the largest in the pool). The same
numbers as the reference's ``repro.configs.olmoe_1b_7b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe_1b_7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    router="sinkhorn",
    qk_norm=True,
)

SMOKE = ModelConfig(
    name="olmoe_1b_7b_smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    router="sinkhorn",
    qk_norm=True,
    scan_layers=True,
)
