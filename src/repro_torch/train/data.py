"""Data pipeline: deterministic synthetic token streams.

Port of `repro.train.data`. Batch `i` of seed `s` is a pure function of
(i, s), drawn with numpy exactly as the reference draws it (the same
generator, seed and zipf draws per family), so the port's batches equal
the reference's and a restart replays identically. The tensors go to the
device the caller names.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig, ShapeSpec

__all__ = ["SyntheticTokens", "make_batch"]


def _tokens(rng: np.random.Generator, b: int, t: int, vocab: int) -> np.ndarray:
    # zipfian-ish marginal so the loss curve is non-trivial
    z = rng.zipf(1.3, size=(b, t + 1)).astype(np.int64)
    return np.minimum(z - 1, vocab - 1).astype(np.int32)


def make_batch(cfg: ModelConfig, shape: ShapeSpec, step: int, seed: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """Global batch for `step` (pure function of (cfg, shape, step, seed))
    as tensors on `device`: int32 tokens and targets, float32 frames or
    patches, drawn as the reference draws them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(hash((seed, step)) % (2 ** 31))
    B, T = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        Te = Td = T // 2
        seqs = _tokens(rng, B, Td, cfg.vocab_size)
        batch = {
            "frames": rng.standard_normal((B, Te, cfg.d_model)).astype(np.float32) * 0.1,
            "tokens": seqs[:, :-1],
            "targets": seqs[:, 1:],
        }
    elif cfg.family == "vlm":
        Np = cfg.num_patches
        Tt = max(T - Np, 1)
        seqs = _tokens(rng, B, Tt, cfg.vocab_size)
        batch = {
            "patches": rng.standard_normal((B, Np, cfg.d_model)).astype(np.float32) * 0.1,
            "tokens": seqs[:, :-1],
            "targets": seqs[:, 1:],
        }
    else:
        seqs = _tokens(rng, B, T, cfg.vocab_size)
        batch = {"tokens": seqs[:, :-1], "targets": seqs[:, 1:]}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


@dataclasses.dataclass
class SyntheticTokens:
    cfg: ModelConfig
    shape: ShapeSpec
    seed: int = 0
    device: str | torch.device = "cuda"
    start_step: int = 0

    def __iter__(self) -> Iterator[dict]:
        step = self.start_step
        while True:
            yield make_batch(self.cfg, self.shape, step, self.seed, self.device)
            step += 1
