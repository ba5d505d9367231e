"""Transformer block assembly: GQA attention blocks for the dense, MoE,
VLM and audio families.

Port of `repro.models.transformer`. Parameters are `nn.Module`s whose
attributes carry the reference's pytree keys and weight layouts; the
functions below take them where the reference takes the dicts. Where the
reference stacks layers on a leading axis and runs `scan_layers`, the port
keeps an `nn.ModuleList` and loops in Python (`repro_torch.models.zoo`).
The reference's sharding hints (`repro.parallel.constrain`) move nothing
in the port, where each rank already holds its own blocks, so the port
does not call them; under a model axis the blocks run on their heads and
columns instead (`layers.tp_enter`/`tp_leave`): attention column-parallel
in `w_q`/`w_k`/`w_v` on this rank's heads (the per-head q/k norms and
RoPE local, B6 on the local heads), row-parallel in `w_o`; where the kv
heads are replicated, each rank projects those its q heads use; cross
attention projects its keys and values from the whole encoder memory the
same way; the gated MLP column-parallel in `w_gate`/`w_up`, row-parallel
in `w_down`; a block whose heads or columns the axis does not divide runs
whole on every rank. The MoE block runs `moe_sharded` when the parallel
context spans a process group (of any size, one rank included) with ep
axes, as the reference does when its mesh has them, on this rank's d
block of its normed input, and `moe_ref` otherwise.

`attn_decode` writes the new token's key and value into the caches it is
given in place (JAX returns updated copies) and returns them. Under a
model axis q comes from this rank's heads (all of them where the block is
whole) and the kv side follows the cache's cut (`parallel.sharding.
kv_cache_cut`): by kv heads, each rank projects, writes and attends its
own; by sequence, every rank projects every kv head from the replicated
`w_k`/`w_v`, only the rank holding position ``pos[b]`` writes it, q is
gathered to all heads, each rank attends its positions and the ranks
merge (`layers.decode_attention_merged`), and this rank keeps its heads
for the row-parallel `w_o`; replicated, every rank writes and attends
the whole cache with all heads and keeps its own. `xattn_decode`, the
cross attention against whisper's cached memory, attends the same way.
In decode the MoE block's capacity is the one `moe_ref` gives the whole
batch (`_moe`).
"""
from __future__ import annotations

import torch
import torch.nn as nn

import torch.nn.functional as F

from .layers import (
    MLP,
    apply_rope,
    attention,
    decode_attention,
    decode_attention_merged,
    init_dense,
    init_mlp,
    init_norm,
    mlp,
    param,
    rms_norm,
    rms_norm_tp,
    rope_cos_sin,
    tp_enter,
    tp_leave,
    tp_of,
    whole_block,
)
from ..parallel.collectives import all_gather, psum_replicated, replicated_copy
from ..parallel.sharding import current_ctx, kv_cache_cut
from .moe import MoE, _capacity, init_moe, moe_ref, moe_sharded

__all__ = ["Attention", "Block", "attn_block", "attn_decode", "attn_forward",
           "attn_whole", "block_forward", "init_attn", "init_block",
           "xattn_decode"]


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


def _kv_weights(p: Attention, cfg, Hq: int, tp):
    """The kv projections for this rank's `Hq` q heads: `w_k`/`w_v` as
    they are where they are cut with the q heads or the block is whole;
    where they are replicated and the q heads cut, the columns of the kv
    heads those q heads use, and, where those q heads do not fall in equal
    groups on them, the kv head of each q head (a selection)."""
    hd, Hkv = cfg.hd, cfg.n_kv_heads
    if Hq == cfg.heads_eff or p.w_k.shape[1] != Hkv * hd:
        return p.w_k, p.w_v, None
    G = cfg.heads_eff // Hkv
    kv = [(tp.index * Hq + j) // G for j in range(Hq)]
    lo, n = kv[0], kv[-1] - kv[0] + 1
    cols = slice(lo * hd, (lo + n) * hd)
    sel = None
    if Hq % n or kv != [lo + j // (Hq // n) for j in range(Hq)]:
        sel = torch.tensor([h - lo for h in kv], device=p.w_k.device)
    return p.w_k[:, cols], p.w_v[:, cols], sel


def _qkv(x: torch.Tensor, p: Attention, cfg, kv_src=None, tp=None):
    B, T, _ = x.shape
    hd = cfg.hd
    kv_in = x if kv_src is None else kv_src
    Tk = kv_in.shape[1]
    Hq = p.w_q.shape[1] // hd
    w_k, w_v, sel = _kv_weights(p, cfg, Hq, tp)
    q = (x @ p.w_q).reshape(B, T, Hq, hd)
    k = (kv_in @ w_k).reshape(B, Tk, w_k.shape[1] // hd, hd)
    v = (kv_in @ w_v).reshape(B, Tk, w_v.shape[1] // hd, hd)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    if sel is not None:
        k, v = k.index_select(2, sel), v.index_select(2, sel)
    return q, k, v


def attn_forward(x: torch.Tensor, p: Attention, cfg, *, causal: bool = True,
                 use_rope: bool = True, kv_src: torch.Tensor | None = None,
                 tp=None) -> torch.Tensor:
    """Attention over a full sequence, x (B, T, d) -> (B, T, d): causal
    self-attention with RoPE by default; ``causal=False`` for an encoder;
    with ``kv_src`` (B, Tk, d) cross attention, its keys and values
    projected from kv_src and, as in the reference, no RoPE. Under a
    model axis (`tp`, `layers.tp_of`) x and kv_src are whole, the heads
    this rank's, and the output the row-parallel product's partial sum
    (or, of a block replicated whole, the whole output)."""
    B, T, _ = x.shape
    q, k, v = _qkv(x, p, cfg, kv_src, tp)
    if use_rope and kv_src is None:
        cos, sin = rope_cos_sin(torch.arange(T, device=x.device)[None, :],
                                cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = attention(q, k, v, causal=causal)
    return o.reshape(B, T, q.shape[2] * cfg.hd) @ p.w_o


def attn_whole(p: Attention, cfg, tp) -> bool:
    """Whether this attention block runs whole on every rank."""
    return whole_block(tp, p.w_q.shape[1], cfg.heads_eff * cfg.hd)


def attn_block(x: torch.Tensor, ln: torch.Tensor, p: Attention, cfg, tp, *,
               causal: bool = True, use_rope: bool = True,
               memory: torch.Tensor | None = None) -> torch.Tensor:
    """The residual update of a pre-norm attention block on x (this rank's
    residual: its d block under residual "tp"). `memory`, for cross
    attention, is the whole normed encoder output on every rank."""
    whole = attn_whole(p, cfg, tp)
    h = tp_enter(x, ln, tp, whole)
    if memory is not None and tp is not None and tp.residual != "tp" \
            and not whole:
        memory = replicated_copy(memory, tp.axis, tp.mesh)
    o = attn_forward(h, p, cfg, causal=causal, use_rope=use_rope,
                     kv_src=memory, tp=tp)
    return tp_leave(o, tp, whole)


def _cache_cut(cfg, tp, length: int | None) -> str:
    """The cut of a KV cache of `length` positions in all (None: a cache
    cut by heads or whole)."""
    if tp is None:
        return "heads"
    if length is None:
        return "heads" if cfg.n_kv_heads % tp.size == 0 else "whole"
    return kv_cache_cut(cfg.n_kv_heads, length, tp.size)


def _attend(q, k_cache, v_cache, lengths, cut: str, tp, whole: bool):
    """q (B, Hq_loc, hd), this rank's heads (all with `whole`), against a
    cache cut by `cut`: the attention output of the same heads."""
    if cut == "heads":
        return decode_attention(q, k_cache, v_cache, lengths)
    n = q.shape[1]
    qa = q if whole else all_gather(q, tp.axis, 1, tp.mesh)
    if cut == "seq":
        o = decode_attention_merged(qa, k_cache, v_cache, lengths, tp)
    else:
        o = decode_attention(qa, k_cache, v_cache, lengths)
    return o if whole else o.narrow(1, tp.index * n, n)


def attn_decode(x: torch.Tensor, p: Attention, cfg, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos: torch.Tensor, tp=None,
                max_len: int | None = None):
    """One token per sequence, x (B, d), at positions `pos` (B,). Writes
    its key and value into ``k_cache``/``v_cache`` (B, S, Hkv, hd) in place
    and attends to positions ``< pos + 1``; returns (out (B, d), k_cache,
    v_cache). Under a model axis (`tp`) x is whole, the caches this rank's
    blocks of caches `max_len` long (module docstring), and out the
    row-parallel product's partial sum (of a whole block, its whole)."""
    B, _ = x.shape
    hd = cfg.hd
    cut = _cache_cut(cfg, tp, max_len)
    q = (x @ p.w_q).reshape(B, p.w_q.shape[1] // hd, hd)
    k = (x @ p.w_k).reshape(B, p.w_k.shape[1] // hd, hd)
    v = (x @ p.w_v).reshape(B, p.w_v.shape[1] // hd, hd)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)          # (B, hd/2)
    q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
    k = apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
    rows = torch.arange(B, device=x.device)
    k, v = k.to(k_cache.dtype), v.to(v_cache.dtype)
    if cut == "seq":
        # only the rank holding position pos[b] writes it
        S = k_cache.shape[1]
        lo = tp.index * S
        mine = ((pos >= lo) & (pos < lo + S))[:, None, None]
        at = torch.where(mine[:, 0, 0], pos - lo, torch.zeros_like(pos))
        k = torch.where(mine, k, k_cache[rows, at])
        v = torch.where(mine, v, v_cache[rows, at])
    else:
        at = pos
    k_cache[rows, at] = k
    v_cache[rows, at] = v
    o = _attend(q, k_cache, v_cache, pos + 1, cut, tp, attn_whole(p, cfg, tp))
    return o.reshape(B, q.shape[1] * hd) @ p.w_o, k_cache, v_cache


def xattn_decode(x: torch.Tensor, p: Attention, cfg, xk: torch.Tensor,
                 xv: torch.Tensor, mem_len: torch.Tensor, tp=None,
                 mem_max: int | None = None) -> torch.Tensor:
    """Cross attention of one token per sequence, x (B, d) normed, against
    the cached memory ``xk``/``xv`` (B, M, Hkv, hd) valid below `mem_len`
    (B,): (B, d), under a model axis as `attn_decode` (the memory's cut
    from `mem_max`, its whole length)."""
    B, _ = x.shape
    hd = cfg.hd
    q = (x @ p.w_q).reshape(B, p.w_q.shape[1] // hd, hd)
    o = _attend(q, xk, xv, mem_len, _cache_cut(cfg, tp, mem_max), tp,
                attn_whole(p, cfg, tp))
    return o.reshape(B, q.shape[1] * hd) @ p.w_o


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


def _moe(x: torch.Tensor, p: Block, cfg, tp, decode: bool = False
         ) -> torch.Tensor:
    """The MoE block's residual update. Over a process group with ep axes
    `moe_sharded` takes this rank's d block of the normed input: under
    residual "tp" the block the rank holds, under "replicated" its slice
    of the whole (its output summed back whole). With `decode` (one token
    a sequence, the batch cut over the ep axes) its capacities are those
    that give `moe_ref`'s drops over the whole batch, as the reference's
    decode runs `moe_ref` on it: no first-stage drop, and each expert's
    capacity `moe_ref`'s."""
    ctx = current_ctx()
    if not (tp is not None and ctx.axes("ep")):
        return moe_ref(rms_norm(x, p.ln2), p.moe, cfg)
    ep = ctx.axes("ep")
    capacity = None
    if decode:
        k, n_loc = cfg.experts_per_tok, x.shape[0] * x.shape[1]
        capacity = (n_loc * k, _capacity(n_loc * tp.mesh.axis_size(ep) * k,
                                         cfg.n_experts, cfg.capacity_factor))

    def sharded(h):
        return moe_sharded(h, p.moe, cfg, tp.mesh, ep_axes=ep,
                           tp_axis=tp.axis, capacity=capacity)

    if tp.residual == "tp":
        return sharded(rms_norm_tp(x, p.ln2, tp))
    h = replicated_copy(rms_norm(x, p.ln2), tp.axis, tp.mesh)
    n = h.shape[-1] // tp.size
    y = sharded(h.narrow(-1, tp.index * n, n))
    y = F.pad(y, (tp.index * n, (tp.size - 1 - tp.index) * n))
    return psum_replicated(y, tp.axis, tp.mesh)


def _ffn(x: torch.Tensor, p: Block, cfg, tp, decode: bool = False
         ) -> torch.Tensor:
    if cfg.family == "moe":
        return _moe(x, p, cfg, tp, decode)
    whole = whole_block(tp, p.mlp.w_up.shape[1], cfg.d_ff)
    return tp_leave(mlp(tp_enter(x, p.ln2, tp, whole), p.mlp, cfg.act), tp,
                    whole)


def block_forward(x: torch.Tensor, p: Block, cfg, *, causal: bool = True,
                  use_rope: bool = True,
                  memory: torch.Tensor | None = None) -> torch.Tensor:
    """One block over a full sequence; with `memory` (B, Tk, d) and a cross
    block, cross attention to it after the self-attention. Under a model
    axis x is this rank's residual and `memory` whole (`attn_block`)."""
    tp = tp_of(cfg)
    x = x + attn_block(x, p.ln1, p.attn, cfg, tp, causal=causal,
                       use_rope=use_rope)
    if memory is not None and hasattr(p, "xattn"):
        x = x + attn_block(x, p.ln_x, p.xattn, cfg, tp, causal=False,
                           use_rope=False, memory=memory)
    return x + _ffn(x, p, cfg, tp)
