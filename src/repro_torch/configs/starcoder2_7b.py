"""StarCoder2-7B [arXiv:2402.19173]: 32L, d=4608, 36H (GQA kv=4,
head_dim=128), d_ff=18432, vocab 49152, RoPE. The same
numbers as the reference's ``repro.configs.starcoder2_7b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
)

SMOKE = ModelConfig(
    name="starcoder2_7b_smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)
