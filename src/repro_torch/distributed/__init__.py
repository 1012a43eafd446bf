"""Distributed runtime: mesh-axis policy and sharding rules on `DeviceMesh`
and DTensor (the counterpart of the reference's ``repro.distributed``).
`repro_torch.distributed.layout` holds the layouts the model code asks of
DTensor where its op rules fall short."""
from repro_torch.distributed.sharding import (
    active_mesh,
    batch_specs,
    constrain,
    decode_state_specs,
    distribute,
    dp_axes,
    leading_axis_specs,
    named,
    param_specs,
    to_placements,
    to_spec,
    tp_axis,
    use_mesh,
)

__all__ = [
    "active_mesh",
    "batch_specs",
    "constrain",
    "decode_state_specs",
    "distribute",
    "dp_axes",
    "leading_axis_specs",
    "named",
    "param_specs",
    "to_placements",
    "to_spec",
    "tp_axis",
    "use_mesh",
]
