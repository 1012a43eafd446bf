"""The plain reference that judges a decoded Mamba-2 language model.

Plain PyTorch, written from the published block (arXiv:2405.21060, Sec. 7
and its reference code's ``Mamba2`` mixer, ``state-spaces/mamba2-130m``)
and independent of the program under test: it imports nothing of it. It
is handed the weights the benchmark made (the tree that the program is
handed too), the tokens that were fed at each position of one sequence
and the program's outputs for that sequence (its float32 logits at the
kept positions, and the token it chose at each position it decoded
greedily), and computes every position's logits again by a teacher-forced
forward over the same tokens, with TF32 off:

* a layer is ``x + out_proj(gated_rmsnorm(ssd(conv(in_proj(rmsnorm(x))))))``:
  ``in_proj`` gives ``z``, ``xBC`` (the heads' inputs ``x``, ``B`` and
  ``C``, one group) and ``dt``; ``xBC`` goes through a causal depthwise
  conv of width ``d_conv`` (no bias) and SiLU; ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)`` a scalar a head;
* the SSD as the plain sequential recurrence, one position after
  another: ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t`` and ``y_t =
  C_t . h_t + D x_t``, ``h`` of (heads, d_state, headdim);
* ``y`` gated by ``silu(z)`` and RMS-normalised over the whole inner
  width, then ``out_proj``; the logits are the final RMS norm's output
  against the tied embedding.

It rounds where the configuration says the model computes (``Dims.dtype``,
bfloat16 for Mamba2-130M): the residual stream and every activation
between two operations are held in that dtype; a matrix product or the
conv's taps take their operands in it and sum in float32; the norms, the
SSD (``dt``, the decay, the recurrent state, the readout) and the
logits' float32 copy are float32.

The numbers, at the kept positions, each over the reference's logit RMS
there (``rms_p``):

* ``logit_gap_max``: the largest ``|program - reference| / rms_p``;
* ``logit_gap_mean``: the mean over kept positions of the mean over the
  vocabulary of the same;
* ``token_gap``: at every position the program decoded greedily, how far
  the reference's logit of the token the program chose lies below the
  reference's best there, over ``rms_p``; the largest of them.

`decode_control` puts the same forward, one step below one precision that
the configuration states (`CONTROLS`), in the program's place:
``fp8_products``, the control, its matrix products' operands rounded to
float8 (e4m3, a scale a row of the activations and one a weight; the
configuration computes in bfloat16); ``bf16_states``, its recurrent states
held in bfloat16 from one position to the next (the configuration's are
float32). The second is read for the record only: on these weights it
moves the logits about as far as the program's own rounding does (each
bfloat16 rounding that comes out otherwise spreads through the layers
and positions), so no limit tells it from the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = ["CONTROLS", "NUMBERS", "Decoded", "Dims", "Inputs", "decode_control", "forward", "judge", "ssd_scan"]

#: the numbers `judge` gives a sequence, in the order they are printed
NUMBERS = ("logit_gap_max", "logit_gap_mean", "token_gap")
#: the controls, each one step below one precision the configuration states
CONTROLS = {"fp8_products": dict(fp8_products=True), "bf16_states": dict(state_dtype=torch.bfloat16)}


@dataclass(frozen=True)
class Dims:
    """The model's sizes, as the configuration file states them."""

    d_model: int
    n_layer: int
    vocab: int  # rows of the (padded) embedding
    d_state: int
    d_conv: int
    expand: int
    headdim: int
    norm_eps: float
    dtype: str  # the dtype the model computes in

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def heads(self) -> int:
        return self.d_inner // self.headdim


@dataclass
class Inputs:
    """What the benchmark made for one judged sequence."""

    dims: Dims
    weights: dict  # the tree the program is handed (float32 masters)
    tokens: torch.Tensor  # (S,) the token fed at each position
    kept: torch.Tensor  # (K,) positions whose logits the program kept
    first_greedy: int  # the first position whose logits chose the next token


@dataclass
class Decoded:
    """The program's outputs for one sequence."""

    logits: torch.Tensor  # (K, V) float32 at the kept positions
    chosen: torch.Tensor  # (S - first_greedy,) the token chosen at each greedy position


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Over the last axis in float32; the result in ``x``'s dtype."""
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps) * scale.float()).to(x.dtype)


def _fp8(x: torch.Tensor, per_row: bool) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale that maps its largest
    magnitude (a row's, or the whole tensor's) to e4m3's largest, 448."""
    top = x.abs().amax(-1, keepdim=True) if per_row else x.abs().amax()
    scale = top.clamp_min(torch.finfo(torch.float32).tiny) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _matmul(x: torch.Tensor, w: torch.Tensor, low: bool) -> torch.Tensor:
    """``x @ w`` with both operands in ``x``'s dtype (float8 operands where
    ``low``), summed in float32; the result in ``x``'s dtype."""
    if low:
        return (_fp8(x.float(), True) @ _fp8(w.float(), False)).to(x.dtype)
    return x @ w.to(x.dtype)


def ssd_scan(x, dt, A, B, C, D, state_dtype=torch.float32) -> torch.Tensor:
    """The SSD recurrence over one sequence's positions, in order. x (S, H,
    P), dt (S, H), A (H,), B and C (S, N), D (H,) -> y (S, H, P); the
    state ``h`` (H, N, P) is stored in ``state_dtype`` from one position
    to the next and updated in the inputs' precision."""
    decay = torch.exp(dt * A)  # (S, H)
    upd = (dt[:, :, None, None] * B[:, None, :, None]) * x[:, :, None, :]  # (S, H, N, P)
    states = torch.empty_like(upd)
    h = torch.zeros_like(upd[0]).to(state_dtype)
    for t in range(x.shape[0]):
        h = (decay[t, :, None, None] * h.to(upd.dtype) + upd[t]).to(state_dtype)
        states[t] = h
    return torch.einsum("sn,shnp->shp", C, states) + D[None, :, None] * x


def _layer(w: dict, x: torch.Tensor, dims: Dims, state_dtype, low: bool) -> torch.Tensor:
    """One Mamba-2 mixer over a sequence: x (S, D) -> (S, D), in ``x``'s
    dtype but for the SSD."""
    d_in, n, heads, p = dims.d_inner, dims.d_state, dims.heads, dims.headdim
    act = x.dtype
    zxbcdt = _matmul(x, w["in_proj"]["w"], low)
    z, xbc, dt = zxbcdt[:, :d_in], zxbcdt[:, d_in : 2 * d_in + 2 * n], zxbcdt[:, 2 * d_in + 2 * n :]
    k = dims.d_conv
    padded = torch.cat([xbc.new_zeros((k - 1, xbc.shape[1])), xbc])
    conv_w = w["conv_w"].to(act)
    taps = torch.stack([padded[j : j + xbc.shape[0]] * conv_w[j] for j in range(k)])
    xbc = F.silu(taps.float().sum(0).to(act)).float()
    xs = xbc[:, :d_in].reshape(-1, heads, p)
    bm, cm = xbc[:, d_in : d_in + n], xbc[:, d_in + n :]
    dt = F.softplus(dt.float() + w["dt_bias"].float())
    y = ssd_scan(xs, dt, -torch.exp(w["A_log"].float()), bm, cm, w["D"].float(), state_dtype).reshape(-1, d_in)
    y = _rms_norm(y.to(act) * F.silu(z), w["norm"]["scale"], dims.norm_eps)
    return _matmul(y, w["out_proj"]["w"], low)


def forward(dims: Dims, weights: dict, tokens: torch.Tensor, state_dtype=torch.float32,
            fp8_products: bool = False) -> torch.Tensor:
    """Teacher-forced logits of every position of one sequence: tokens (S,)
    -> (S, V) float32; the control's lower precisions where asked."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    act = getattr(torch, dims.dtype)
    table = weights["embed"]["w"]
    with torch.no_grad():
        x = table[tokens.long()].to(act)
        for block in weights["blocks"]:
            x = x + _layer(block["ssm"], _rms_norm(x, block["ln1"]["scale"], dims.norm_eps), dims, state_dtype,
                           fp8_products)
        return _matmul(_rms_norm(x, weights["final_norm"]["scale"], dims.norm_eps), table.T, fp8_products).float()


def _gaps(inp: Inputs, ref: torch.Tensor, logits: torch.Tensor, chosen: torch.Tensor) -> dict[str, float]:
    kept = inp.kept.to(ref.device).long()
    at = ref[kept]
    rms = at.pow(2).mean(-1, keepdim=True).sqrt()
    rel = (logits.to(ref.device).float() - at).abs() / rms
    greedy = ref[inp.first_greedy :]
    best = greedy.max(-1).values
    got = greedy.gather(1, chosen.to(ref.device).long()[:, None])[:, 0]
    token_gap = (best - got) / greedy.pow(2).mean(-1).sqrt()
    out = dict(logit_gap_max=float(rel.max()), logit_gap_mean=float(rel.mean()), token_gap=float(token_gap.max()))
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def judge(inp: Inputs, out: Decoded) -> dict[str, float]:
    """The three numbers for one sequence (see the module docstring); a
    number that cannot be formed (outputs of the wrong shape, a chosen
    token outside the vocabulary, a non-finite logit) reads ``inf``."""
    s = inp.tokens.shape[0]
    if (out.logits.shape != (inp.kept.shape[0], inp.dims.vocab) or out.chosen.shape != (s - inp.first_greedy,)
            or int(out.chosen.min()) < 0 or int(out.chosen.max()) >= inp.dims.vocab):
        return dict.fromkeys(NUMBERS, math.inf)
    ref = forward(inp.dims, inp.weights, inp.tokens)
    return _gaps(inp, ref, out.logits, out.chosen)


def decode_control(inp: Inputs, which: str = "fp8_products") -> Decoded:
    """A control's outputs for one sequence (``which`` of `CONTROLS`),
    teacher-forced on the same tokens; at each greedy position the token
    it puts first."""
    low = forward(inp.dims, inp.weights, inp.tokens, **CONTROLS[which])
    return Decoded(low[inp.kept.to(low.device).long()], low[inp.first_greedy :].argmax(-1))
