"""Gemma3-12B [hf:google/gemma-3 family; unverified]: 48L, d=3840, 16H
(GQA kv=8, head_dim=256), d_ff=15360, vocab 262144, 5 local : 1 global
attention pattern (sliding window 1024), 128k-class context. The same
numbers as the reference's ``repro.configs.gemma3_12b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    sliding_window=1024,
    global_period=6,  # layers 5, 11, ... are global; the rest local
    qk_norm=True,
    logit_softcap=0.0,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="gemma3_12b_smoke",
    family="dense",
    num_layers=6,  # one full local:global group
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    sliding_window=16,
    global_period=6,
    qk_norm=True,
)
