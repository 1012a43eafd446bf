"""Whisper-large-v3 [arXiv:2212.04356]: enc-dec, 32 encoder + 32 decoder
layers, d=1280, 20H MHA (kv=20), d_ff=5120, vocab 51866. The conv/mel
frontend is a STUB: the caller feeds precomputed frame embeddings
(B, 1500, d_model). Decoder shapes follow the assigned LM shape set. The same
numbers as the reference's ``repro.configs.whisper_large_v3``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_large_v3",
    family="audio",
    num_layers=32,  # decoder layers
    encoder_layers=32,
    num_frames=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
)

SMOKE = ModelConfig(
    name="whisper_large_v3_smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    num_frames=16,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
)
