"""Faults planted in a language model's decode path, to show that the
judge finds them: each is a context manager that patches one place of
the timed path and restores it on exit, as `perfbench.harness.faults`
does for the Spar-Sink cells. `perfbench/calibrate.py --fault` reads them
on the card; ``perfbench/tests/test_perfbench_lm.py`` runs them on the CPU.

* ``unchanged_state``: every Mamba-2 layer's decode returns its state
  unchanged;
* ``state_reset``: the decode state is zeroed every `RESET_EVERY` steps;
* ``conv_shift``: the causal conv's window is read one position late (its
  oldest tap lost);
* ``previous_logits``: a step returns the logits of the step before;
* ``half_batch``: a step decodes the first half of its batch only, and the
  rest get that half's logits;
* ``altered_token``: the greedy choice is one token off where it is made.
"""
from __future__ import annotations

import importlib
from contextlib import ExitStack, contextmanager
from unittest import mock

import torch

__all__ = ["FAULTS", "RESET_EVERY", "planted"]

FAULTS = ("unchanged_state", "state_reset", "conv_shift", "previous_logits", "half_batch", "altered_token")
RESET_EVERY = 64


def _ssm():
    return importlib.import_module("repro_torch.models.ssm")


def _lm():
    return importlib.import_module("repro_torch.models.lm")


def _unchanged_state(stack: ExitStack) -> None:
    ssm = _ssm()
    decode = ssm.ssm_decode

    def stale(params, x, state, cfg):
        return decode(params, x, state, cfg)[0], state

    stack.enter_context(mock.patch.object(ssm, "ssm_decode", stale))


def _state_reset(stack: ExitStack) -> None:
    lm = _lm()
    step = lm.decode_step

    def reset(params, state, tokens, pos, cfg, extras=None):
        if pos % RESET_EVERY == 0:
            for t in state["ssm"]:
                t.zero_()
        return step(params, state, tokens, pos, cfg, extras)

    stack.enter_context(mock.patch.object(lm, "decode_step", reset))


def _conv_shift(stack: ExitStack) -> None:
    ssm = _ssm()
    decode = ssm.ssm_decode

    def shifted(params, x, state, cfg):
        w = params["conv_w"]
        return decode(dict(params, conv_w=torch.cat([w[1:], torch.zeros_like(w[:1])])), x, state, cfg)

    stack.enter_context(mock.patch.object(ssm, "ssm_decode", shifted))


def _previous_logits(stack: ExitStack) -> None:
    lm = _lm()
    step = lm.decode_step
    last = {}

    def previous(params, state, tokens, pos, cfg, extras=None):
        logits, state = step(params, state, tokens, pos, cfg, extras)
        out = last.get("logits", logits)
        last["logits"] = logits
        return out, state

    stack.enter_context(mock.patch.object(lm, "decode_step", previous))


def _half_batch(stack: ExitStack) -> None:
    lm = _lm()
    step = lm.decode_step

    def half(params, state, tokens, pos, cfg, extras=None):
        b = tokens.shape[0]
        keep = max(b // 2, 1)
        part = {"ssm": type(state["ssm"])(*(t[:, :keep] for t in state["ssm"]))}
        logits, _ = step(params, part, tokens[:keep], pos, cfg, extras)
        return logits.repeat(-(-b // keep), 1, 1)[:b], state

    stack.enter_context(mock.patch.object(lm, "decode_step", half))


def _altered_token(stack: ExitStack) -> None:
    kind = importlib.import_module("perfbench.kinds.lm_decode")
    greedy = kind.greedy
    stack.enter_context(mock.patch.object(kind, "greedy", lambda logits: (greedy(logits) + 1) % logits.shape[-1]))


@contextmanager
def planted(name: str):
    patch = {"unchanged_state": _unchanged_state, "state_reset": _state_reset, "conv_shift": _conv_shift,
             "previous_logits": _previous_logits, "half_batch": _half_batch, "altered_token": _altered_token}[name]
    with ExitStack() as stack:
        patch(stack)
        yield
