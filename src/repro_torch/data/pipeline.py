"""Deterministic synthetic LM token pipeline.

The port's own copy of the reference's ``repro.data.pipeline`` (numpy
only, so it is copied, not imported): every batch is a pure function of
``(seed, step, host_slice)`` via counter-based Philox, so there is no
pipeline state to checkpoint and a restart replays exactly. Sequences
follow a drifting random walk over the vocabulary, which a model can learn.
The batches are numpy arrays, bitwise equal to the reference's.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        *,
        seed: int = 0,
        host_index: int = 0,
        host_count: int = 1,
    ):
        if global_batch % host_count:
            raise ValueError(f"global_batch {global_batch} is not a multiple of host_count {host_count}")
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.seed = seed
        self.host_index = host_index

    def batch(self, step: int) -> np.ndarray:
        """(local_batch, seq) int32 tokens for this host at this step."""
        rng = np.random.Generator(
            np.random.Philox(seed=[self.seed, step, self.host_index, 0xDA7A])
        )
        b, s, v = self.local_batch, self.seq, self.vocab
        start = rng.integers(0, v, size=(b, 1))
        # mixture of small forward steps and occasional jumps => learnable
        steps = rng.choice(
            [1, 1, 2, 3, 5, -1, 17], size=(b, s - 1), p=[0.3, 0.2, 0.15, 0.1, 0.1, 0.1, 0.05]
        )
        toks = np.concatenate([start, steps], axis=1).cumsum(axis=1) % v
        return toks.astype(np.int32)
