"""Random weights of a Mamba-2 language model, drawn from the seed as the
published code initialises them (``mamba_ssm``'s ``Mamba2`` mixer and
``MixerModel``), in the tree that the program takes (the port's
``models.lm`` layout: ``embed``, ``final_norm``, ``blocks[i]`` with
``ln1`` and ``ssm``; a projection ``w`` is (in, out)).

* embedding N(0, ``initializer_range``^2), tied to the output;
* ``in_proj`` and ``out_proj`` as ``nn.Linear``'s default, U(-1/sqrt(fan
  in), 1/sqrt(fan in)), ``out_proj`` then divided by sqrt(layers) (the
  pre-norm residual rescaling); the conv as ``nn.Conv1d``'s default,
  U(-1/sqrt(d_conv), 1/sqrt(d_conv)), with no bias (the program's block
  has none);
* ``A = -exp(A_log)`` with ``exp(A_log)`` ~ U(``A_init_range``); ``dt``
  log-uniform in [``dt_min``, ``dt_max``], floored at ``dt_init_floor``,
  ``dt_bias`` its inverse softplus; ``D`` and every norm scale 1.

Each kind of leaf is one draw on the device for all layers at once, in
``param_dtype``; each layer's leaves are views of it."""
from __future__ import annotations

import math

import torch

__all__ = ["KEYS", "make"]

#: the configuration keys this pattern reads (with the sizes its kind reads)
KEYS = frozenset({"initializer_range", "A_init_range", "dt_min", "dt_max", "dt_init_floor", "param_dtype"})


def _uniform(shape, lo: float, hi: float, device, gen) -> torch.Tensor:
    return torch.rand(shape, dtype=torch.float32, device=device, generator=gen).mul_(hi - lo).add_(lo)


def make(cfg: dict, vocab: int, device, gen: torch.Generator) -> dict:
    """The weights of the configuration ``cfg`` with ``vocab`` embedding
    rows."""
    d, layers, n, k = cfg["d_model"], cfg["n_layer"], cfg["d_state"], cfg["d_conv"]
    d_in = cfg["expand"] * d
    heads = d_in // cfg["headdim"]
    conv_dim = d_in + 2 * n
    dtype = getattr(torch, cfg["param_dtype"])
    embed = torch.randn((vocab, d), dtype=torch.float32, device=device, generator=gen).mul_(cfg["initializer_range"])
    in_proj = _uniform((layers, d, 2 * d_in + 2 * n + heads), -d**-0.5, d**-0.5, device, gen)
    conv_w = _uniform((layers, k, conv_dim), -k**-0.5, k**-0.5, device, gen)
    out_proj = _uniform((layers, d_in, d), -d_in**-0.5, d_in**-0.5, device, gen).div_(math.sqrt(layers))
    a_lo, a_hi = cfg["A_init_range"]
    a_log = _uniform((layers, heads), a_lo, a_hi, device, gen).log_()
    dt = _uniform((layers, heads), math.log(cfg["dt_min"]), math.log(cfg["dt_max"]), device, gen).exp_()
    dt = dt.clamp_min_(cfg["dt_init_floor"])
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    ones = torch.ones((layers + 1, d + d_in + heads), dtype=dtype, device=device)
    in_proj, conv_w, out_proj, a_log, dt_bias, embed = (t.to(dtype) for t in (in_proj, conv_w, out_proj, a_log,
                                                                              dt_bias, embed))
    blocks = [{"ln1": {"scale": ones[i, :d]},
               "ssm": {"in_proj": {"w": in_proj[i]}, "conv_w": conv_w[i], "A_log": a_log[i],
                       "D": ones[i, d + d_in :], "dt_bias": dt_bias[i], "norm": {"scale": ones[i, d : d + d_in]},
                       "out_proj": {"w": out_proj[i]}}}
              for i in range(layers)]
    return {"embed": {"w": embed}, "final_norm": {"scale": ones[layers, :d]}, "blocks": blocks}
