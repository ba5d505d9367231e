"""Serve a reduced model on the port: prefill a prompt, decode greedily
with the KV cache.

The port of `examples/serve_lm.py`, with its default architecture,
qwen3-8b; `--arch` takes any of the ten (every family: dense, moe, vlm,
audio, ssm, hybrid), as the reference's does. The weights come from a
`torch.Generator` seeded with 0 on the card (the reference's
distributions, not its numbers); decode attention runs B7
(`csrc/decode_attention.cu`: self attention, and whisper's cross
attention to its cached memory) and the Mamba scan B8 on the card.

    PYTHONPATH=src python examples_torch/serve_lm.py [--arch qwen2-moe-a2.7b]
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import init_cache, init_params
from repro_torch.serve import make_serve_step

DEFAULT_ARCH = "qwen3-8b"       # the reference example's


def generate(cfg, params, prompt, n_tokens, device):
    """Teacher-force `prompt` (B, T) int32 into a fresh cache, then decode
    `n_tokens` greedy tokens. Returns (B, n_tokens) numpy int32."""
    B, T = prompt.shape
    cache = init_cache(cfg, B, T + n_tokens + 1, device=device)
    step = make_serve_step(cfg, device=device)
    prompt = torch.as_tensor(prompt, device=device)
    tok = prompt[:, 0]
    for t in range(1, T):
        _, cache = step(params, cache, tok)
        tok = prompt[:, t]
    out = []
    for _ in range(n_tokens):
        tok, cache = step(params, cache, tok)
        out.append(tok.cpu().numpy())
    gen = np.stack(out, 1)
    assert gen.shape == (B, n_tokens), gen.shape
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all(), "token out of vocab"
    assert cache["pos"].tolist() == [T + n_tokens - 1] * B, "cache position"
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=DEFAULT_ARCH)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain version")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch)
    params = init_params(cfg, 0, device=device)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    gen = generate(cfg, params, prompt, args.tokens, device)
    print(f"{cfg.name}: generated {gen.shape[1]} tokens/seq ({device})")
    print("sequences:", gen.tolist())


if __name__ == "__main__":
    main()
