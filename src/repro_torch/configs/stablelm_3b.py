"""StableLM-3B [hf:stabilityai/stablelm family; unverified]: 32L, d=2560,
32H MHA (kv=32), d_ff=6912, vocab 50304. The same
numbers as the reference's ``repro.configs.stablelm_3b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm_3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
)

SMOKE = ModelConfig(
    name="stablelm_3b_smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    vocab_size=256,
)
