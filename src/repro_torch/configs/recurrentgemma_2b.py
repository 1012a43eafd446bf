"""RecurrentGemma-2B [arXiv:2402.19427]: 26L, d=2560, 10H MQA (kv=1,
head_dim=256), d_ff=7680 (GeGLU), vocab 256000; block pattern
(RG-LRU, RG-LRU, local-attn) — 2 recurrent : 1 attention, window 2048.
Sub-quadratic => runs the long_500k shape. The same numbers as the
reference's ``repro.configs.recurrentgemma_2b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma_2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    sliding_window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    rnn_width=2560,
    scan_layers=False,  # heterogeneous blocks are unrolled
)

SMOKE = ModelConfig(
    name="recurrentgemma_2b_smoke",
    family="hybrid",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    sliding_window=16,
    block_pattern=("rglru", "rglru", "attn"),
    rnn_width=64,
    scan_layers=False,
)
