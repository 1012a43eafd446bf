"""Seeds: the per-draw seeds made from ``--seed``, and the choice of the
answers to judge.

Every random draw comes from a `torch.Generator` seeded by `derive(seed,
tag)`, so the same seed gives the same inputs, and any whole number up to
2**64 - 1 is a valid seed. A draw that every seed shares (a traffic's
schedule) uses `SHARED` in the seed's place.
"""
from __future__ import annotations

import hashlib
import math
import random

import torch

__all__ = ["SHARED", "derive", "generator", "judged", "s0"]

#: stands for the run's seed in the draws that every seed shares
SHARED = -1


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the draw named by ``tags``, from the run's seed."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def s0(n: int) -> float:
    """The paper's pilot sketch size ``1e-3 n log^4 n`` (Sec. 5.1)."""
    return 1e-3 * n * math.log(n) ** 4


def judged(seed: int, sample_from: int, count: int, sizes: list[int], largest: int = 4) -> list[int]:
    """The indices of the estimates or requests to judge: ``count`` of the
    first ``sample_from``, drawn from the seed, of which ``largest`` (or
    all, where fewer) are of the largest problem size; ``sizes[i]`` is
    index ``i``'s size."""
    rng = random.Random(derive(seed, "sample"))
    top = max(sizes[:sample_from])
    big = [i for i in range(sample_from) if sizes[i] == top]
    rest = [i for i in range(sample_from) if sizes[i] != top]
    take = min(largest, count) if rest else count
    return sorted(rng.sample(big, take) + rng.sample(rest, count - take))
