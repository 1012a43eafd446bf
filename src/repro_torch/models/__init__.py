"""Model zoo: the port's functional LM (the hybrid family so far)."""
from repro_torch.models.lm import (
    decode_step,
    forward,
    init_decode_state,
    init_params,
    loss_fn,
    param_count,
)

__all__ = [
    "decode_step",
    "forward",
    "init_decode_state",
    "init_params",
    "loss_fn",
    "param_count",
]
