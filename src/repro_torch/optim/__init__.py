"""Optimizer substrate: AdamW, the schedule, clipping and int8 compression."""
from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.optim.compression import compress_int8, decompress_int8, ef_update

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "compress_int8",
    "cosine_schedule",
    "decompress_int8",
    "ef_update",
    "global_norm",
]
