"""Training traffic: one global batch a step, its tokens drawn from a
zipf law (a copy of the port's ``train/data.py`` draw, seeded from
``--seed`` and the step, not imported), clipped to the vocabulary. Every
seed gives the same sizes; rows all differ."""
from __future__ import annotations

import numpy as np

from perfbench.harness import subseed

__all__ = ["batch"]


def batch(seed: int, step: int, p: dict, vocab: int) -> dict:
    """{"tokens", "targets"}: int32 (batch, seq) arrays of step `step`,
    the targets the tokens shifted by one; `p` the cell's traffic."""
    rng = np.random.default_rng(subseed(seed, "train", step))
    z = rng.zipf(p["zipf_a"], size=(p["batch"], p["seq"] + 1))
    seqs = np.minimum(z - 1, vocab - 1).astype(np.int32)
    return {"tokens": np.ascontiguousarray(seqs[:, :-1]),
            "targets": np.ascontiguousarray(seqs[:, 1:])}
