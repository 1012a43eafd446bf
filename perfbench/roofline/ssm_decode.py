"""Model operations and least bytes of one decode step of a Mamba-2
language model over a batch of B sequences (one new position each).

Operations a token: 2 a non-embedding parameter (each a multiply and an
add in its matrix-vector product; the norms' and the conv's weights
counted alike), 2 d V for the logits against the tied embedding, and
`STATE_FLOPS` an element of each layer's recurrent state (H x N x P):
the decay's multiply, dt B (x) x's two multiplies, the add, and C . h's
multiply and add. The elementwise work between them is not counted.

Least bytes a step: every layer's recurrent and conv states read once and
written once in float32, the weights read once in bfloat16 (the precision
the step computes in), and the float32 logits written once. At Mamba2-130M
and B = 64 that is 2.75 GB (2.48 of it the state), 0.82 ms at 3.35 TB/s.
"""
from __future__ import annotations

from perfbench.roofline.peaks import HBM_BYTES_PER_S

__all__ = ["STATE_FLOPS", "params", "state_bytes", "step_flops", "step_min_bytes", "step_min_ms"]

STATE_FLOPS = 6


def params(dims) -> tuple[int, int]:
    """``(non-embedding, embedding)`` parameter counts (tied embedding)."""
    d, d_in, n, h = dims.d_model, dims.d_inner, dims.d_state, dims.heads
    layer = (d + d * (2 * d_in + 2 * n + h) + dims.d_conv * (d_in + 2 * n) + 3 * h + d_in + d_in * d)
    return dims.n_layer * layer + d, dims.vocab * d


def state_bytes(dims, batch: int) -> int:
    """The float32 decode state of every layer: recurrent and conv."""
    per = dims.heads * dims.d_state * dims.headdim + (dims.d_conv - 1) * (dims.d_inner + 2 * dims.d_state)
    return batch * dims.n_layer * per * 4


def step_flops(dims, batch: int) -> float:
    body, _ = params(dims)
    state = dims.n_layer * dims.heads * dims.d_state * dims.headdim
    return float(batch * (2 * body + 2 * dims.d_model * dims.vocab + STATE_FLOPS * state))


def step_min_bytes(dims, batch: int) -> int:
    body, emb = params(dims)
    return 2 * state_bytes(dims, batch) + 2 * (body + emb) + batch * dims.vocab * 4


def step_min_ms(dims, batch: int) -> float:
    return step_min_bytes(dims, batch) / HBM_BYTES_PER_S * 1e3
