"""Model zoo: the port's functional LM (the dense, moe and hybrid families)."""
from repro_torch.models.lm import (
    decode_step,
    forward,
    init_decode_state,
    init_params,
    layer_windows,
    loss_fn,
    param_count,
)

__all__ = [
    "decode_step",
    "forward",
    "init_decode_state",
    "init_params",
    "layer_windows",
    "loss_fn",
    "param_count",
]
