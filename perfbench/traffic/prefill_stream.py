"""Prefill traffic: a closed loop of batches of ``batch`` prompts, each
batch of one prompt length. Lengths run from ``lo`` to ``hi`` in steps of
``step``; each block of as many batches as there are lengths holds every
length once, in an order drawn from the seed, so that every seed offers
the same mix. Tokens follow a zipf law (as the training traffic's),
clipped to the vocabulary; every prompt's tokens are its own."""
from __future__ import annotations

import numpy as np

from perfbench.harness import subseed

__all__ = ["batch", "batch_length", "lengths", "request"]


def lengths(p: dict) -> list[int]:
    """Every prompt length of the mix, ascending."""
    return list(range(p["lo"], p["hi"] + 1, p["step"]))


def batch_length(seed: int, j: int, p: dict) -> int:
    """The prompt length of batch `j`."""
    ls = lengths(p)
    block = np.random.default_rng(subseed(seed, "prefill", "block",
                                          j // len(ls)))
    return int(block.permutation(ls)[j % len(ls)])


def request(seed: int, i: int, p: dict, vocab: int) -> np.ndarray:
    """The int32 prompt of request `i`, in batch ``i // batch``."""
    n = batch_length(seed, i // p["batch"], p)
    rng = np.random.default_rng(subseed(seed, "prefill", "tokens", i))
    z = rng.zipf(p["zipf_a"], size=n)
    return np.minimum(z - 1, vocab - 1).astype(np.int32)


def batch(seed: int, j: int, p: dict, vocab: int) -> np.ndarray:
    """The int32 (batch, length) prompts of batch `j`."""
    B = p["batch"]
    return np.stack([request(seed, j * B + r, p, vocab) for r in range(B)])
