"""Mamba2-130M [arXiv:2405.21060]: 24L, d=768, attention-free SSD
(state-space duality), ssm_state=128, expand=2, head_dim=64, vocab 50280.
Sub-quadratic => runs the long_500k shape. The same
numbers as the reference's ``repro.configs.mamba2_130m``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,  # unused for ssm
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=64,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2_130m_smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=8,
    tie_embeddings=True,
)
