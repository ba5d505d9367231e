"""Family-level model assembly: init / forward / cache / decode per family.

Port of `repro.models.zoo` for the dense and hybrid families:

  init_params(cfg, seed, device)             -> LM (an nn.Module)
  forward(params, batch, cfg)                -> logits (prefill)
  init_cache(cfg, batch, max_len, device)    -> decode cache dict
  decode_step(params, cache, tokens, cfg)    -> (logits, cache)

`batch` is a dict holding "tokens" (B, T). The parameters are `nn.Module`s
whose attribute names are the reference's pytree keys (`LM.tok_emb`,
`LM.blocks[i].attn.w_q`, ...); layers are an `nn.ModuleList` walked by a
Python loop where the reference scans over stacked layers, and the hybrid
forward's `lax.cond` is a Python `if`. `decode_step` updates the cache in
place (the KV slots, the SSM and conv states, ``pos``) and returns it.

The moe, vlm, audio and ssm (xLSTM) families raise `NotImplementedError`
naming their ROADMAP item, as does training: the JAX package has no
backward kernel for B6-B8, and `loss_fn` waits with `train/*` (A12f).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from .config import ModelConfig
from .layers import init_dense, init_norm, mlp, param, rms_norm
from .ssm import (
    _CONV_K,
    _HEAD_P,
    Mamba2,
    _mamba_dims,
    init_mamba2,
    mamba2_decode_step,
    mamba2_forward,
)
from .transformer import (
    Attention,
    Block,
    attn_decode,
    attn_forward,
    block_forward,
    init_attn,
    init_block,
)

__all__ = ["LM", "decode_step", "forward", "init_cache", "init_params", "loss_fn"]

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the families this slice does not port, and the ROADMAP item that will
_WAITING = {
    "moe": "the MoE family (ROADMAP A12b)",
    "audio": "the audio family (ROADMAP A12c)",
    "vlm": "the VLM family (ROADMAP A12d)",
    "ssm": "the xLSTM family (ROADMAP A12e)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"{cfg.name}: {_WAITING[cfg.family]} is not ported yet")
    if cfg.family not in ("dense", "hybrid"):
        raise ValueError(cfg.family)


class MambaBlock(nn.Module):
    """One hybrid layer: ln, mamba."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.ln = param((cfg.d_model,), dtype, device)
        self.mamba = Mamba2(cfg.d_model, cfg, dtype, device)


class SharedAttn(nn.Module):
    """zamba2's shared attention block: ln, attn, w_concat (2d, d)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.ln = param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.w_concat = param((2 * cfg.d_model, cfg.d_model), dtype, device)


class LM(nn.Module):
    """tok_emb (V, d), ln_f (d,), lm_head (d, V), blocks (a ModuleList of
    `Block` or `MambaBlock`) and, for the hybrid family, shared. Allocated
    uninitialised on `device`; `init_params` fills it from a seed,
    `repro_torch.convert.lm_params_from_numpy` from a reference pytree."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        _check_family(cfg)
        dt, d = _DT[cfg.dtype], cfg.d_model
        self.tok_emb = param((cfg.vocab_size, d), dt, device)
        self.ln_f = param((d,), dt, device)
        self.lm_head = param((d, cfg.vocab_size), dt, device)
        layer = Block if cfg.family == "dense" else MambaBlock
        self.blocks = nn.ModuleList(layer(cfg, dt, device)
                                    for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared = SharedAttn(cfg, dt, device)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> LM:
    """A model of `cfg` on `device`, its weights drawn from a
    `torch.Generator` on that device seeded with `seed` (the reference's
    distributions; not its numbers, which come from `jax.random`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = LM(cfg, dev)
    init_dense(p.tok_emb, gen, scale=0.02)
    init_norm(p.ln_f)
    init_dense(p.lm_head, gen)
    for blk in p.blocks:
        if cfg.family == "dense":
            init_block(blk, gen, cfg)
        else:
            init_norm(blk.ln)
            init_mamba2(blk.mamba, gen)
    if cfg.family == "hybrid":
        init_norm(p.shared.ln)
        init_attn(p.shared.attn, gen, cfg)
        init_dense(p.shared.w_concat, gen)
    return p


def _head(p: LM, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, p.ln_f) @ p.lm_head


def forward(params: LM, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, T, V) of the full sequence ``batch["tokens"]`` (B, T)."""
    _check_family(cfg)
    x = F.embedding(batch["tokens"], params.tok_emb)
    if cfg.family == "dense":
        for blk in params.blocks:
            x = block_forward(x, blk, cfg)
        return _head(params, x)
    emb0 = x
    shared = params.shared
    for i, blk in enumerate(params.blocks):
        if i % cfg.shared_attn_every == 0:
            a_in = torch.cat([x, emb0], dim=-1) @ shared.w_concat
            x = x + attn_forward(rms_norm(a_in, shared.ln), shared.attn, cfg)
        x = x + mamba2_forward(rms_norm(x, blk.ln), blk.mamba, cfg)[0]
    return _head(params, x)


def loss_fn(params, batch: dict, cfg: ModelConfig):
    """Training waits: the JAX package has no backward kernel for B6-B8."""
    raise NotImplementedError("training (loss_fn, train/*) is not ported yet "
                              "(ROADMAP A12f)")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """The decode cache: per-layer KV (dense), or per-layer SSM and conv
    states plus one KV slot per shared-attention application point
    (hybrid); ``pos`` (B,) int32."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt, hd = _DT[cfg.dtype], cfg.hd

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    pos = zeros((batch,), torch.int32)
    if cfg.family == "dense":
        kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
        return {"k": zeros(kv), "v": zeros(kv), "pos": pos}
    di, H, S = _mamba_dims(cfg.d_model, cfg)
    n_app = math.ceil(cfg.n_layers / cfg.shared_attn_every)
    kv = (n_app, batch, max_len, cfg.n_kv_heads, hd)
    return {
        "ssm": zeros((cfg.n_layers, batch, H, _HEAD_P, S), torch.float32),
        "conv": zeros((cfg.n_layers, batch, _CONV_K - 1, di + 2 * S)),
        "attn_k": zeros(kv),
        "attn_v": zeros(kv),
        "pos": pos,
    }


def decode_step(params: LM, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One decode step. tokens (B,) -> (logits (B, V), cache), the cache
    updated in place."""
    _check_family(cfg)
    pos = cache["pos"]
    x = F.embedding(tokens, params.tok_emb)                      # (B, d)
    if cfg.family == "dense":
        for i, blk in enumerate(params.blocks):
            a, _, _ = attn_decode(rms_norm(x, blk.ln1), blk.attn, cfg,
                                  cache["k"][i], cache["v"][i], pos)
            x = x + a
            x = x + mlp(rms_norm(x, blk.ln2)[:, None, :], blk.mlp, cfg.act)[:, 0]
    else:
        # one KV slot per application point of the shared block (ceil(L /
        # every) slots), not per layer: 38 copies of a long cache would be
        # a 5x memory regression, as the reference notes
        shared = params.shared
        emb0 = x   # zamba2's concat-skip uses the original embedding
        for i, blk in enumerate(params.blocks):
            if i % cfg.shared_attn_every == 0:
                slot = i // cfg.shared_attn_every
                a_in = torch.cat([x, emb0], dim=-1) @ shared.w_concat
                a, _, _ = attn_decode(rms_norm(a_in, shared.ln), shared.attn,
                                      cfg, cache["attn_k"][slot],
                                      cache["attn_v"][slot], pos)
                x = x + a
            y, _ = mamba2_decode_step(
                rms_norm(x, blk.ln),
                {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
                blk.mamba, cfg)
            x = x + y
    pos += 1
    return _head(params, x), cache
