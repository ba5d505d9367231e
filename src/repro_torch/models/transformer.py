"""Transformer block assembly: GQA attention blocks for the dense, MoE,
VLM and audio families.

Port of `repro.models.transformer`. Parameters are `nn.Module`s whose
attributes carry the reference's pytree keys and weight layouts; the
functions below take them where the reference takes the dicts. Where the
reference stacks layers on a leading axis and runs `scan_layers`, the port
keeps an `nn.ModuleList` and loops in Python (`repro_torch.models.zoo`).
The reference's sharding hints (`repro.parallel.constrain`) move nothing
in the port, where each rank already holds its own blocks, so the port
does not call them. The MoE block runs `moe_sharded` when the parallel
context spans a process group (of any size, one rank included) with ep
axes, as the reference does when its mesh has them, and `moe_ref`
otherwise.

`attn_decode` writes the new token's key and value into the caches it is
given in place (JAX returns updated copies) and returns them.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .layers import (
    MLP,
    apply_rope,
    attention,
    decode_attention,
    init_dense,
    init_mlp,
    init_norm,
    mlp,
    param,
    rms_norm,
    rope_cos_sin,
)
from ..parallel.sharding import current_ctx
from .moe import MoE, init_moe, moe_ref, moe_sharded

__all__ = ["Attention", "Block", "attn_decode", "attn_forward", "block_forward",
           "init_attn", "init_block"]


class Attention(nn.Module):
    """w_q (d, He*hd), w_k and w_v (d, Hkv*hd), w_o (He*hd, d), and with qk
    norm the (hd,) q_norm and k_norm (never in cross attention)."""

    def __init__(self, cfg, dtype, device, cross: bool = False):
        super().__init__()
        d, hd, He = cfg.d_model, cfg.hd, cfg.heads_eff
        self.w_q = param((d, He * hd), dtype, device)
        self.w_k = param((d, cfg.n_kv_heads * hd), dtype, device)
        self.w_v = param((d, cfg.n_kv_heads * hd), dtype, device)
        self.w_o = param((He * hd, d), dtype, device)
        for name in ("q_norm", "k_norm"):
            if cfg.qk_norm and not cross:
                self.register_parameter(name, param((hd,), dtype, device))
            else:
                self.register_parameter(name, None)


def init_attn(p: Attention, gen: torch.Generator, cfg) -> Attention:
    """Fill `p` from `gen`, zeroing padded heads; returns p."""
    init_dense(p.w_q, gen)
    init_dense(p.w_k, gen)
    init_dense(p.w_v, gen)
    init_dense(p.w_o, gen)
    if cfg.heads_eff > cfg.n_heads:
        # padded heads: zero their projections so they are numerically inert
        p.w_q[:, cfg.n_heads * cfg.hd:] = 0
        p.w_o[cfg.n_heads * cfg.hd:, :] = 0
    if p.q_norm is not None:
        init_norm(p.q_norm)
        init_norm(p.k_norm)
    return p


def _qkv(x: torch.Tensor, p: Attention, cfg, kv_src=None):
    B, T, _ = x.shape
    hd = cfg.hd
    kv_in = x if kv_src is None else kv_src
    Tk = kv_in.shape[1]
    q = (x @ p.w_q).reshape(B, T, cfg.heads_eff, hd)
    k = (kv_in @ p.w_k).reshape(B, Tk, cfg.n_kv_heads, hd)
    v = (kv_in @ p.w_v).reshape(B, Tk, cfg.n_kv_heads, hd)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    return q, k, v


def attn_forward(x: torch.Tensor, p: Attention, cfg, *, causal: bool = True,
                 use_rope: bool = True,
                 kv_src: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over a full sequence, x (B, T, d) -> (B, T, d): causal
    self-attention with RoPE by default; ``causal=False`` for an encoder;
    with ``kv_src`` (B, Tk, d) cross attention, its keys and values
    projected from kv_src and, as in the reference, no RoPE."""
    B, T, _ = x.shape
    q, k, v = _qkv(x, p, cfg, kv_src)
    if use_rope and kv_src is None:
        cos, sin = rope_cos_sin(torch.arange(T, device=x.device)[None, :],
                                cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = attention(q, k, v, causal=causal)
    return o.reshape(B, T, cfg.heads_eff * cfg.hd) @ p.w_o


def attn_decode(x: torch.Tensor, p: Attention, cfg, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos: torch.Tensor):
    """One token per sequence, x (B, d), at positions `pos` (B,). Writes
    its key and value into ``k_cache``/``v_cache`` (B, S, Hkv, hd) in place
    and attends to positions ``< pos + 1``; returns (out (B, d), k_cache,
    v_cache)."""
    B, _ = x.shape
    hd = cfg.hd
    q = (x @ p.w_q).reshape(B, cfg.heads_eff, hd)
    k = (x @ p.w_k).reshape(B, cfg.n_kv_heads, hd)
    v = (x @ p.w_v).reshape(B, cfg.n_kv_heads, hd)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)          # (B, hd/2)
    q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
    k = apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
    rows = torch.arange(B, device=x.device)
    k_cache[rows, pos] = k.to(k_cache.dtype)
    v_cache[rows, pos] = v.to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, pos + 1)
    return o.reshape(B, cfg.heads_eff * hd) @ p.w_o, k_cache, v_cache


class Block(nn.Module):
    """A decoder block: ln1, attn, ln2, and mlp (or, in the MoE family,
    moe); a cross block (whisper's decoder) also ln_x and xattn."""

    def __init__(self, cfg, dtype, device, cross: bool = False):
        super().__init__()
        self.ln1 = param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = param((cfg.d_model,), dtype, device)
        if cfg.family == "moe":
            self.moe = MoE(cfg.d_model, cfg, dtype, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device)
        if cross:
            self.ln_x = param((cfg.d_model,), dtype, device)
            self.xattn = Attention(cfg, dtype, device, cross=True)


def init_block(p: Block, gen: torch.Generator, cfg) -> Block:
    """Fill `p` from `gen`; returns p."""
    init_norm(p.ln1)
    init_attn(p.attn, gen, cfg)
    init_norm(p.ln2)
    if cfg.family == "moe":
        init_moe(p.moe, gen)
    else:
        init_mlp(p.mlp, gen)
    if hasattr(p, "xattn"):
        init_norm(p.ln_x)
        init_attn(p.xattn, gen, cfg)
    return p


def _ffn(x: torch.Tensor, p: Block, cfg) -> torch.Tensor:
    if cfg.family == "moe":
        ctx = current_ctx()
        if ctx.distributed and ctx.axes("ep"):
            return moe_sharded(x, p.moe, cfg, ctx.mesh, ep_axes=ctx.axes("ep"),
                               tp_axis=ctx.axes("tp")[0])
        return moe_ref(x, p.moe, cfg)
    return mlp(x, p.mlp, cfg.act)


def block_forward(x: torch.Tensor, p: Block, cfg, *, causal: bool = True,
                  use_rope: bool = True,
                  memory: torch.Tensor | None = None) -> torch.Tensor:
    """One block over a full sequence; with `memory` (B, Tk, d) and a cross
    block, cross attention to it after the self-attention."""
    x = x + attn_forward(rms_norm(x, p.ln1), p.attn, cfg, causal=causal,
                         use_rope=use_rope)
    if memory is not None and hasattr(p, "xattn"):
        x = x + attn_forward(rms_norm(x, p.ln_x), p.xattn, cfg, causal=False,
                             use_rope=False, kv_src=memory)
    return x + _ffn(rms_norm(x, p.ln2), p, cfg)
