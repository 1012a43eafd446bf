"""Model configs: frozen dataclasses and a registry keyed by ``--arch`` id.

The port's own copy of the reference's ``repro.configs.base`` (pure
Python, so it is copied, not imported): `ModelConfig` with every field and
default, `SHAPES`, `ARCH_IDS`, `get` and `cells`. Each ported architecture has one
module in this package defining ``CONFIG`` (the published numbers) and
``SMOKE`` (a reduced config of the same family for CPU tests); all ten of
the reference's architectures are here. `TrainConfig` holds a training
run's settings, with the reference's fields and defaults.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Literal

__all__ = ["ARCH_IDS", "SHAPES", "SUBQUADRATIC", "ModelConfig", "TrainConfig", "cells", "get", "shape_of"]

ARCH_IDS = (
    "olmoe_1b_7b",
    "llama4_scout_17b_a16e",
    "qwen3_14b",
    "stablelm_3b",
    "starcoder2_7b",
    "gemma3_12b",
    "mamba2_130m",
    "llama32_vision_11b",
    "whisper_large_v3",
    "recurrentgemma_2b",
)

# input shapes assigned to the LM family (seq_len, global_batch, kind)
SHAPES: dict[str, tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

# archs with sub-quadratic sequence mixing: the only ones that run long_500k
SUBQUADRATIC = ("mamba2_130m", "recurrentgemma_2b")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "vlm", "audio", "hybrid"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    router: Literal["softmax", "sinkhorn", "spar_sink"] = "softmax"
    router_eps: float = 0.05  # entropic regularizer of the routing OT problem
    router_iters: int = 8  # fixed Sinkhorn iterations (differentiable)
    router_sample_frac: float = 0.25  # Spar-Sink sketch budget: s = frac * N * E
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    # --- attention pattern ---
    sliding_window: int = 0  # 0 = full attention
    global_period: int = 0  # gemma3: 6 => every 6th layer global, rest local
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    attn_chunk: int = 1024  # query-chunk size for O(S) memory attention

    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4

    # --- hybrid (recurrentgemma): block kinds cycled over layers ---
    block_pattern: tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    rnn_width: int = 0  # RG-LRU width (0 => d_model)
    rglru_backend: Literal["assoc", "chunked", "pallas"] = "chunked"
    rglru_chunk: int = 256  # chunk length for the chunked backend

    # --- vlm ---
    cross_attn_period: int = 0  # every k-th layer is followed by cross-attn
    num_image_tokens: int = 0

    # --- audio (enc-dec) ---
    encoder_layers: int = 0
    num_frames: int = 0

    # --- numerics / training ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: Literal["none", "full", "dots"] = "full"
    scan_layers: bool = True
    cast_params_once: bool = True
    decode_cross_cache: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 2048
    global_batch: int = 32
    microbatch: int = 0  # 0 => no gradient accumulation
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    seed: int = 0
    z_loss: float = 1e-4
    grad_compression: bool = False  # int8 + error feedback on the DP all-reduce
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3


def get(name: str) -> ModelConfig:
    """Resolve ``<arch>`` or ``<arch>:smoke`` to a ModelConfig."""
    smoke = name.endswith(":smoke")
    arch = name[: -len(":smoke")] if smoke else name
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG


def shape_of(shape_name: str) -> tuple[int, int, str]:
    return SHAPES[shape_name]


def cells(include_long: bool = True):
    """All assigned (arch, shape) dry-run cells, honouring the long_500k skip."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            if s == "long_500k" and a not in SUBQUADRATIC:
                continue
            if not include_long and s == "long_500k":
                continue
            out.append((a, s))
    return out
