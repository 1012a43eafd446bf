"""The port's device rule.

Entry points run on the CUDA card unless the caller asks for the CPU:

* data given as numpy arrays or Python numbers goes to ``device``, and
  ``device=None`` means ``"cuda"``; with no card present that raises a
  `RuntimeError` instead of quietly running on the CPU;
* a torch tensor keeps the device it lies on (a CPU tensor is the caller
  asking for the CPU) unless ``device`` names another one.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_tensor", "generator_at", "make_generator", "resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" (or CPU tensors) "
            "to run on the CPU"
        )
    return dev


def as_tensor(data, device: str | torch.device | None = None) -> torch.Tensor:
    """``data`` as a tensor placed by the device rule (see module docstring)."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(resolve_device(device))
    return torch.as_tensor(np.asarray(data), device=resolve_device(device))


def make_generator(device: torch.device, generator=None, seed: int | None = None) -> torch.Generator:
    """A random source on ``device``: ``generator`` as given, or a new one
    seeded with ``seed``; exactly one of them."""
    if (generator is None) == (seed is None):
        raise TypeError("pass exactly one of generator= (a torch.Generator) or seed=")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(int(seed))
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, the data on {device}")
    return generator


def generator_at(generator: torch.Generator, state: torch.Tensor) -> torch.Generator:
    """A new generator on ``generator``'s device set to ``state`` (one of
    ``generator.get_state()``'s): it replays the draws that ``generator``
    made from that state on, and keeps its initial seed."""
    out = torch.Generator(device=generator.device)
    out.set_state(state)
    return out
