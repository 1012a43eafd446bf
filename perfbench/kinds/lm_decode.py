"""Language-model decoding in lockstep batches: the program's serve step
(``repro_torch.train.step.make_serve_step``, the step that
``launch.serve.serve`` drives), called as ``serve`` calls it, over batch
after batch as the traffic's discipline offers them.

Set-up draws the weights from the seed on the device (the configuration's
pattern; the reference is handed the same tensors), makes the program's
decode state (``models.init_decode_state``) and warms every operation a
step runs. In the window each batch's state is zeroed and its prompts
drawn from the seed; step ``i`` feeds position ``i``'s token, the prompt's
while there is one and then the greedy choice of the last step's logits,
and copies the chosen tokens to the host, as ``serve`` does (the copy
waits for the step). For the judged sequences (`sample`) the window keeps
the fed and chosen tokens and the float32 logits at the kept positions.
A traced run profiles steps ``trace_from`` to ``trace_from + trace_steps
- 1`` of the first batch."""
from __future__ import annotations

import random
import time

import torch

from perfbench.harness import lm_faults as FAULTS
from perfbench.harness.cells import Run, open_window, peak, sync, warm_profiler
from perfbench.harness.inputs import derive, generator
from perfbench.harness.trace import DeviceTrace
from perfbench.reference import ssm_lm as REFERENCE
from perfbench.roofline import ssm_decode

__all__ = ["CONFIG_KEYS", "FAULTS", "REFERENCE", "TRAFFIC_KEYS", "check", "control", "dims", "greedy", "kept_positions",
           "run", "sample", "vocab_rows"]

#: the configuration keys this kind reads (its pattern reads its own)
CONFIG_KEYS = frozenset({"arch", "d_model", "n_layer", "vocab_size", "pad_vocab_size_multiple", "d_state", "d_conv",
                         "expand", "headdim", "ngroups", "conv_bias", "norm_eps", "tie_embeddings", "dtype",
                         "state_dtype"})
#: the traffic keys this kind reads (its discipline reads its own)
TRAFFIC_KEYS = frozenset({"batch", "prompt_len", "prompt_low", "prompt_high", "sample", "sample_from", "kept_every",
                          "kept_last", "trace_from", "trace_steps"})


def vocab_rows(cfg: dict) -> int:
    """Rows of the embedding: the vocabulary padded to its multiple."""
    m = cfg["pad_vocab_size_multiple"]
    return -(-cfg["vocab_size"] // m) * m


def dims(cfg: dict) -> REFERENCE.Dims:
    return REFERENCE.Dims(cfg["d_model"], cfg["n_layer"], vocab_rows(cfg), cfg["d_state"], cfg["d_conv"],
                          cfg["expand"], cfg["headdim"], cfg["norm_eps"], cfg["dtype"])


def check(cell) -> None:
    """The program's configuration ``arch`` is the one the file states."""
    from repro_torch import configs

    cfg = cell.config
    port = configs.get(cfg["arch"])
    want = dict(family="ssm", d_model=cfg["d_model"], num_layers=cfg["n_layer"], vocab_size=vocab_rows(cfg),
                ssm_state=cfg["d_state"], ssm_conv=cfg["d_conv"], ssm_expand=cfg["expand"],
                ssm_head_dim=cfg["headdim"], tie_embeddings=cfg["tie_embeddings"], dtype=cfg["dtype"],
                logit_softcap=0.0)
    differ = {k: (getattr(port, k), v) for k, v in want.items() if getattr(port, k) != v}
    if differ:
        raise ValueError(f"{cell.name}: the program's {cfg['arch']} differs from the file (program, file): {differ}")
    if cfg["ngroups"] != 1 or cfg["conv_bias"] or cfg["state_dtype"] != "float32":
        raise ValueError(f"{cell.name}: the program's Mamba-2 block has one group, no conv bias and float32 "
                         "decode states")
    if not 0 <= cell.traffic["prompt_low"] < cell.traffic["prompt_high"] <= cfg["vocab_size"]:
        raise ValueError(f"{cell.name}: prompt tokens are drawn from [prompt_low, prompt_high) within the vocabulary")
    if cell.traffic["sample"] > 2 * cell.traffic["sample_from"]:
        raise ValueError(f"{cell.name}: at most one judged sequence in each half of the first sample_from batches")


def kept_positions(traffic: dict) -> list[int]:
    """The positions whose logits are kept for the judge: every
    ``kept_every``-th, and the last ``kept_last``."""
    steps = traffic["prompt_len"] + traffic["gen_len"]
    every = set(range(traffic["kept_every"] - 1, steps, traffic["kept_every"]))
    return sorted(every | set(range(steps - traffic["kept_last"], steps)))


def sample(cell, seed: int) -> list[tuple[int, int]]:
    """The judged sequences, ``(batch, row)``: ``sample`` halves of the
    first ``sample_from`` batches, drawn from the seed, and one row drawn
    in each, so that every half of a batch can be judged."""
    tr = cell.traffic
    rng = random.Random(derive(seed, "sample"))
    half = tr["batch"] // 2
    strata = rng.sample([(b, h) for b in range(tr["sample_from"]) for h in (0, 1)], tr["sample"])
    return sorted((b, h * half + rng.randrange(half)) for b, h in strata)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next tokens, (B, 1), as ``serve`` chooses them."""
    return torch.argmax(logits[:, -1:], dim=-1)


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Run:
    from repro_torch import configs
    from repro_torch.models import init_decode_state
    from repro_torch.tree import leaves
    from repro_torch.train.step import make_serve_step

    cfg, tr = cell.config, cell.traffic
    result = Run()
    port = configs.get(cfg["arch"])
    model = dims(cfg)
    weights = cell.pattern.make(cfg, model.vocab, device, generator(device, seed, "weights"))
    batch, prompt = tr["batch"], tr["prompt_len"]
    steps = prompt + tr["gen_len"]
    state = init_decode_state(port, batch, steps, device=device)
    step = make_serve_step(port)
    result.records["setup_marks"] = {"weights": time.perf_counter() - t_start}

    judged = sample(cell, seed)
    rows: dict[int, list[int]] = {}
    for b, r in judged:
        rows.setdefault(b, []).append(r)
    rows_of = {b: torch.tensor(rs, device=device) for b, rs in rows.items()}
    kept = kept_positions(tr)
    kept_set = set(kept)
    held: dict[int, dict] = {}  # batch -> its judged rows' prompts, chosen tokens and kept logits
    live: dict = {}
    last_end = 0.0
    trace_stop = tr["trace_from"] + tr["trace_steps"]

    def finished(logits) -> None:
        """Counts the batch's sequences whose last logits are not finite."""
        result.failed += int((~torch.isfinite(logits[:, -1]).all(-1)).sum())
        live["checked"] = True

    def one(b: int, i: int) -> None:
        nonlocal last_end
        if i == 0:
            for t in leaves(state):
                t.zero_()
            live["prompts"] = torch.randint(tr["prompt_low"], tr["prompt_high"], (batch, prompt), device=device,
                                            generator=generator(device, seed, "prompt", b))
            live["tok"] = live["prompts"][:, :1]
            if b >= 0:
                result.attempted += batch
            if b in rows_of:
                held[b] = {"prompts": live["prompts"][rows_of[b]].clone(), "chosen": [], "logits": []}
        if traced and b == 0 and i == tr["trace_from"]:
            result.trace = DeviceTrace()
            result.trace.begin()
        with result.spans.span("step"):
            logits, _ = step(weights, state, live["tok"], i)
        live["logits"], live["checked"] = logits, False
        keep = held.get(b)
        if keep is not None and i in kept_set:
            keep["logits"].append(logits[rows_of[b], -1])
        live["tok"] = greedy(logits) if i >= prompt - 1 else live["prompts"][:, i + 1 : i + 2]
        with result.spans.span("read"):
            host = live["tok"].cpu()  # waits for the step, as serve() does
        last_end = time.perf_counter()
        if keep is not None and i >= prompt - 1:
            keep["chosen"].append(host[rows[b], 0])
        if traced and b == 0 and i == trace_stop - 1:
            result.trace.finish()
        if i == steps - 1 and b >= 0:
            finished(logits)

    # warm every operation a step runs: the state's reset, a fed and a
    # greedy step with the judge's copies, and the check of a batch's end
    rows[-1], rows_of[-1] = [0], torch.tensor([0], device=device)
    for i in (0, prompt - 1, steps - 1):
        one(-1, i)
    finished(live["logits"])
    result.failed = 0
    del rows[-1], rows_of[-1], held[-1]
    if traced:
        warm_profiler(device)
    result.records["setup_marks"]["warm"] = time.perf_counter() - t_start

    open_window(device)
    result.memory_peak_bytes = peak(device)
    t0 = time.perf_counter()
    result.setup_s = t0 - t_start
    done = cell.discipline.drive(tr, one, t0, seconds, tr["sample_from"])
    if not live["checked"]:
        finished(live["logits"])
    sync(device)
    result.memory_peak_bytes = max(result.memory_peak_bytes, peak(device))
    result.e2e = {"decode_tokens_per_s": batch * done / (last_end - t0)}
    result.records.update(steps=done, traced_steps=tr["trace_steps"] if traced else 0,
                          step_flops=ssm_decode.step_flops(model, batch),
                          step_min_bytes=ssm_decode.step_min_bytes(model, batch))

    def release():
        live.clear()
        state.clear()
        positions = torch.tensor(kept, device=device)
        for b, r in judged:
            keep = held[b]
            k = rows[b].index(r)
            chosen = torch.stack([c[k] for c in keep["chosen"]]).to(device)
            tokens = torch.cat([keep["prompts"][k], chosen[:-1]])
            inp = REFERENCE.Inputs(model, weights, tokens, positions, prompt - 1)
            result.items.append((inp, REFERENCE.Decoded(torch.stack([x[k] for x in keep["logits"]]), chosen)))
        held.clear()

    result.release = release
    return result


def control(cell, seed: int, device, which: str = "fp8_products") -> list:
    """The judged sequences with a control's outputs in the program's place
    (``which`` of `perfbench.reference.ssm_lm.CONTROLS`), teacher-forced on
    the tokens the program fed them for ``seed`` (its shortest window)."""
    program = run(cell, seed, 0.0, False, device, time.perf_counter())
    program.release()
    return [(inp, REFERENCE.decode_control(inp, which)) for inp, _ in program.items]
