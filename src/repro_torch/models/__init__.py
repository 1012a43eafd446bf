"""Model zoo: the port's functional LM, all six of the reference's families
(dense, moe, ssm, hybrid, vlm, audio) and so its ten architectures."""
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
