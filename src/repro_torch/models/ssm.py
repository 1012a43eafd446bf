"""Mamba-2 SSD (state-space duality) mixer: the chunked parallel form for
train and prefill, the O(1)-state recurrent form for decode.

The counterpart of the reference's ``repro.models.ssm``, plain XLA there
and plain torch here (no hand kernel on this path). Shapes follow the SSD
layout with n_groups = 1: ``in_proj`` -> [z (d_in), xBC (d_in + 2 state),
dt (H)], a causal depthwise conv over xBC, heads H = d_in / head_dim.

Per chunk of length Q (``cfg.ssm_chunk``; one chunk of length S when S is
not a multiple of it):

  intra:  y_q += sum_{p<=q} (C_q . B_p) exp(cum_q - cum_p) dt_p x_p
  states: S_c  = sum_p exp(cum_last - cum_p) dt_p (B_p (x) x_p)
  inter:  y_q += exp(cum_q) (C_q . h_{c-1}),  h_c = exp(sum_c) h_{c-1} + S_c

The cross-chunk recurrence is ``jax.lax.associative_scan`` in the
reference. The port runs the same odd/even recursion on tensors
(`_assoc_scan`): log2(nc) levels, each a few whole-tensor ops over half the
chunks of the level above. A loop over chunks would issue a few launches a
chunk (nc = 8192 chunks a layer at 1 x 524288); the doubling scan of
`kernels.ref.linear_scan` passes over all of S_c log2(nc) times. On an
H100 (80GB HBM3, 700 W; chip_smoke.py phase 14) at nc = 8192 this scan
took 39.7 ms and 12.9 GB above its inputs, the doubling one 193.3 ms and
25.8 GB.

The causal conv sums its K shifted products left to right in the compute
dtype, as the reference does (`_causal_conv`), rather than through
``F.conv1d``, which accumulates bf16 in float32 on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.layout import even_layout, local_apply, unshard, unshard_for_merge, unshard_for_split
from repro_torch.models import layers
from repro_torch.models.layers import _normal, _softplus, dense_init, rms_norm, rms_norm_init

__all__ = ["SSMState", "init_ssm", "init_ssm_state", "ssm_decode", "ssm_forward"]


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    return d_in, heads, cfg.ssm_state


def init_ssm(generator, cfg: ModelConfig, device, dtype=torch.float32):
    d_in, heads, state = _dims(cfg)
    return {
        "in_proj": dense_init(generator, cfg.d_model, 2 * d_in + 2 * state + heads, device, dtype),
        "conv_w": _normal(generator, (cfg.ssm_conv, d_in + 2 * state), 0.1, device, dtype),
        "A_log": torch.zeros((heads,), dtype=dtype, device=device),  # A = -exp(A_log) = -1
        "D": torch.ones((heads,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((heads,), dtype=dtype, device=device),
        "norm": rms_norm_init(d_in, device, dtype),
        "out_proj": dense_init(generator, d_in, cfg.d_model, device, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence axis (the K products summed
    left to right, as the reference's ``sum``), then SiLU. x (B,S,C), w (K,C)."""
    return F.silu(layers._causal_conv(x, w))


def _split_proj(params, x, cfg: ModelConfig, dtype):
    d_in, heads, state = _dims(cfg)
    # under a mesh: the projection's weight gathered along d_model (its
    # output width, 3352 at full size, divides no model axis, so the
    # product would only leave partial sums), and an uneven shard
    # replicated before the slices (DTensor would otherwise shard the
    # heads' width, 24 over 16, and then refuse its reshapes)
    zxbcdt = even_layout(x @ unshard(params["in_proj"]["w"], 0).to(dtype))
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : 2 * d_in + 2 * state]
    dt = zxbcdt[..., 2 * d_in + 2 * state :]
    return z, xbc, dt


# the named axes of a chunked (B, nc, Q, H) tensor: the cumsum runs along Q
_CHUNKS = ("b", "c", None, "h")


def _cumsum_steps(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=2)


def _combine(e1, e2):
    """(a1, s1) then (a2, s2) is (a1 a2, s1 a2 + s2); a is (B, n, H, 1, 1)."""
    a1, s1 = e1
    a2, s2 = e2
    return a1 * a2, s1 * a2 + s2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even`` at the even places of dim 1 and ``odd`` at the odd ones;
    ``even`` is as long as ``odd`` or one longer."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1) if even.shape[1] > n else out


def _assoc_scan(a: torch.Tensor, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of `_combine` along dim 1 by the recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan those, then
    fill in the even places from the scanned odd ones."""
    n = a.shape[1]
    if n < 2:
        return a, s
    odd = _assoc_scan(*_combine((a[:, 0 : n - 1 : 2], s[:, 0 : n - 1 : 2]), (a[:, 1::2], s[:, 1::2])))
    head = odd if n % 2 else (odd[0][:, :-1], odd[1][:, :-1])
    even = _combine(head, (a[:, 2::2], s[:, 2::2]))
    even_a = torch.cat([a[:, :1], even[0]], dim=1)
    even_s = torch.cat([s[:, :1], even[1]], dim=1)
    del even, head
    return _interleave(even_a, odd[0]), _interleave(even_s, odd[1])


def ssm_forward(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, D) -> (B, S, D): the chunked SSD, in float32 (float64 for a
    float64 ``x``) between the projections, which run in ``x``'s dtype."""
    dtype = x.dtype
    work = torch.promote_types(dtype, torch.float32)
    b, s, _ = x.shape
    d_in, heads, n = _dims(cfg)
    hd = cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s)
    if s % q != 0:
        q = s
    nc = s // q

    z, xbc, dt = _split_proj(params, x, cfg, dtype)
    # under a mesh, the splits of S into chunks and of d_in into heads
    # replicate a sharding that does not divide them, as GSPMD does
    xbc = unshard_for_split(_causal_conv(xbc, params["conv_w"].to(dtype)), 1, nc)
    dt = unshard_for_split(dt, 1, nc)
    xs_c = unshard_for_split(xbc[..., :d_in], -1, heads).reshape(b, nc, q, heads, hd).to(work)
    B_c = xbc[..., d_in : d_in + n].reshape(b, nc, q, n).to(work)  # group-shared
    C_c = xbc[..., d_in + n :].reshape(b, nc, q, n).to(work)
    del xbc

    dt = _softplus(dt.to(work) + params["dt_bias"].to(work))
    A = -torch.exp(params["A_log"].to(work))  # (H,)
    dt_c = dt.reshape(b, nc, q, heads)
    # the cumsum along a chunk's steps, on each rank's shards for DTensors:
    # not every DTensor version has a rule for its backward's flip
    cum = local_apply(_cumsum_steps, (dt * A[None, None, :]).reshape(b, nc, q, heads),
                      axes=(_CHUNKS,), out=_CHUNKS)  # (B,nc,Q,H)

    # intra-chunk (quadratic in Q). The exponent is masked before the exp,
    # where the reference masks after it: above the diagonal cum_q - cum_p
    # is positive and overflows once a chunk's decay passes ~88, and the
    # backward's 0 * inf turned the gradients NaN (ROADMAP C-16). exp(-inf)
    # is the reference's 0, so the forward is bitwise the same.
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # cum_q - cum_p
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(causal[None, None, :, :, None], rel, float("-inf")))
    del rel
    cb = torch.einsum("bcqn,bcpn->bcqp", C_c, B_c)
    w = cb[:, :, :, :, None] * L * dt_c[:, :, None, :, :]  # (B,nc,Q,Q,H)
    del L, cb
    y = torch.einsum("bcqph,bcphd->bcqhd", w, xs_c)
    del w

    # chunk states, then the cross-chunk scan
    last = cum[:, :, -1:, :]  # (B,nc,1,H)
    decay_p = torch.exp(last - cum) * dt_c  # (B,nc,Q,H)
    S_c = torch.einsum("bcpn,bcphd->bchnd", B_c, xs_c * decay_p[..., None])  # (B,nc,H,N,hd)
    chunk_decay = torch.exp(last[:, :, 0, :])[..., None, None]  # (B,nc,H,1,1)
    _, acc = _assoc_scan(chunk_decay, S_c)
    del S_c
    # the state entering chunk c is the scan shifted right by one
    h_prev = torch.cat([torch.zeros_like(acc[:, :1]), acc[:, :-1]], dim=1)
    del acc
    y = y + torch.einsum("bcqn,bchnd->bcqhd", C_c, h_prev) * torch.exp(cum)[..., None]
    del h_prev

    y = y + params["D"].to(work)[None, None, None, :, None] * xs_c
    y = y.reshape(b, s, d_in).to(dtype)
    y = rms_norm(params["norm"], y * F.silu(z))
    return y @ params["out_proj"]["w"].to(dtype)


class SSMState(NamedTuple):
    h: torch.Tensor  # (B, H, N, hd) recurrent state
    conv: torch.Tensor  # (B, K-1, d_in + 2N) conv tail


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> SSMState:
    """A zero state; ``device=None`` means the card."""
    d_in, heads, n = _dims(cfg)
    dev = resolve_device(device)
    return SSMState(
        torch.zeros((batch, heads, n, cfg.ssm_head_dim), dtype=dtype, device=dev),
        torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * n), dtype=dtype, device=dev),
    )


def _decode_update(h, decay, dtt, Bt, Ct, xt, D):
    """The state update and readout of one token: ``(y (B, H, hd), h_new
    (B, H, N, hd))``."""
    h_new = decay[:, :, None, None] * h + torch.einsum("bh,bn,bhd->bhnd", dtt, Bt, xt)
    y = torch.einsum("bn,bhnd->bhd", Ct, h_new) + D[None, :, None] * xt
    return y, h_new


def ssm_decode(params, x: torch.Tensor, state: SSMState, cfg: ModelConfig):
    """One-token step. x (B, 1, D) -> (y (B, 1, D), the new state); the
    state update in `ssm_forward`'s precision."""
    dtype = x.dtype
    work = torch.promote_types(dtype, torch.float32)
    b = x.shape[0]
    d_in, heads, n = _dims(cfg)
    hd = cfg.ssm_head_dim

    z, xbc, dt = _split_proj(params, x, cfg, dtype)
    window = torch.cat([state.conv.to(dtype), xbc], dim=1)  # (B, K, C)
    xbc1 = F.silu(torch.sum(window * params["conv_w"].to(dtype)[None], dim=1))  # (B, C)
    new_conv = window[:, 1:, :]

    xt = unshard_for_split(xbc1[:, :d_in], -1, heads).reshape(b, heads, hd).to(work)
    Bt = xbc1[:, d_in : d_in + n].to(work)
    Ct = xbc1[:, d_in + n :].to(work)
    dtt = _softplus(dt[:, 0].to(work) + params["dt_bias"].to(work))  # (B,H)
    A = -torch.exp(params["A_log"].to(work))
    decay = torch.exp(dtt * A[None, :])  # (B,H)

    # on each rank's shards for DTensors, the batch and head_dim where the
    # state shards them (the cache's layout, so the state never moves)
    by_b = ("b", None)
    y, h_new = local_apply(_decode_update, state.h.to(work), decay, dtt, Bt, Ct, xt, params["D"].to(work),
                           axes=(("b", None, None, "w"), by_b, by_b, by_b, by_b, ("b", None, "w"), (None,)),
                           out=[("b", None, "w"), ("b", None, None, "w")])
    y = unshard_for_merge(y, 1, 3).reshape(b, 1, d_in).to(dtype)
    y = rms_norm(params["norm"], y * F.silu(z))
    y = y @ params["out_proj"]["w"].to(dtype)
    return y, SSMState(h_new.to(state.h.dtype), new_conv.to(state.conv.dtype))
