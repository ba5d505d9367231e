"""Serving steps of the LM side: prefill (full-sequence forward) and
per-token decode.

Port of `repro.serve.serve_step`. `serve_step` advances every sequence in
the batch by one token (greedy, or sampled at a temperature) against the
decode cache, which it updates in place; `prefill` runs the full-sequence
forward. Both run on `device` (default the card) and move the tokens they
are given there, under `torch.no_grad`: serving builds no autograd graph,
even for a model the trainer turned gradients on for.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models import decode_step, forward
from ..models.config import ModelConfig

__all__ = ["make_prefill", "make_serve_step"]


def make_serve_step(cfg: ModelConfig, temperature: float = 0.0,
                    device: str | torch.device = "cuda",
                    max_len: int | None = None):
    """``serve_step(params, cache, tokens, generator=None) -> (next (B,)
    int32, cache)``. Greedy (first maximum, as `jnp.argmax`) unless
    `temperature` > 0 and a `torch.Generator` is given; sampling draws from
    torch's generator, so its tokens are not the reference's.

    Under a mesh's parallel context the tokens are this data rank's
    sequences, `params` and `cache` this rank's blocks, and the step picks
    from the whole logits `decode_step` gives every rank; ``max_len`` is
    the whole cache's length (`models.decode_step`)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, cache, tokens: torch.Tensor,
                   generator: torch.Generator | None = None):
        logits, cache = decode_step(params, cache, tokens.to(dev), cfg,
                                    max_len)
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = logits.argmax(dim=-1)
        return nxt.to(torch.int32), cache

    return serve_step


def make_prefill(cfg: ModelConfig, device: str | torch.device = "cuda"):
    """``prefill(params, batch) -> logits`` of `forward`; every tensor of
    `batch` (``tokens``, and ``patches`` or ``frames``) is moved to the
    device first."""
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill(params, batch: dict):
        return forward(params, {k: v.to(dev) for k, v in batch.items()}, cfg)

    return prefill
