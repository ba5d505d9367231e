"""Shared transformer layers: RMSNorm, RoPE, GQA attention, gated MLPs.

Port of `repro.models.layers`. Weights keep the reference's layouts (a
projection is ``x @ W`` with W of shape (d_in, d_out)), so that carrying a
reference model across is a copy. Casts follow the reference's: RMSNorm
normalises in float32 and casts back to x's type before the weight,
RoPE and the activations compute in float32 and cast back.

Attention goes through the port's kernels: `attention` through B6
(`repro_torch.kernels.ops.flash_attention`, the counterpart of the
reference's ``attn_impl="pallas"`` branch; the reference's default XLA
path computes the same function) and `decode_attention` through B7 (the
counterpart of `decode_attention_xla`). On CPU tensors both run the
kernels' plain versions.

Tensor parallelism (`TP`, `tp_of`): under a parallel context whose mesh
spans a process group with a model axis, of any size, one rank included,
each rank holds its blocks of the weights (`parallel.sharding.tp_pspecs`)
and the layers run their own collectives. A block enters through
`tp_enter` (its pre-norm; under ``cfg.residual == "tp"``, where each rank
holds a d / tp block of the residual, the blocks all-gathered and normed
whole on every rank; under "replicated" the whole normed residual,
through `replicated_copy` into a cut block),
computes on its heads or columns, and leaves through `tp_leave` (after a
row-parallel product a reduce-scatter over d, or a `psum_replicated`;
from a block replicated whole, this rank's d block, or all of it). A norm
over a dimension cut over the axis (Mamba2's and the mLSTM's inner norms,
the MoE block's input under "tp") sums its mean of squares over the axis
(`rms_norm_tp`). At a model axis of size 1 every collective is a copy and
every block its whole: the same arithmetic as without a mesh, bit for
bit. `tp_enter` and `tp_leave` take a decode step's (B, d) token as they
take a sequence's (B, T, d).

Decoding over a KV cache cut by sequence (`parallel.sharding.
kv_cache_cut`) goes through `decode_attention_merged`: each rank runs B7
on its positions and keeps its rows' softmax statistics (M, L), and the
ranks merge their outputs with one maximum and one sum over the axis.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import ops
from ..parallel.collectives import (
    all_gather,
    pmax,
    psum,
    psum_replicated,
    psum_scatter,
    replicated_copy,
)
from ..parallel.sharding import current_ctx

__all__ = [
    "MLP",
    "TP",
    "apply_rope",
    "attention",
    "decode_attention",
    "decode_attention_merged",
    "init_dense",
    "init_mlp",
    "init_norm",
    "mlp",
    "param",
    "rms_norm",
    "rms_norm_tp",
    "rope_cos_sin",
    "tp_enter",
    "tp_leave",
    "tp_of",
    "whole_block",
]


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter, made without ``requires_grad`` so that
    serving builds no autograd graph; the trainer (`repro_torch.train.
    init_state`) turns gradients on."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def init_dense(w: torch.Tensor, gen: torch.Generator,
               scale: float | None = None) -> torch.Tensor:
    """Fill weight `w` with normal draws times `scale` (default
    ``1/sqrt(d_in)`` of a (d_in, d_out) projection), drawn in float32 and
    cast to w's type, as the reference."""
    scale = scale if scale is not None else w.shape[0] ** -0.5
    draw = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                       device=w.device)
    return w.copy_(draw.mul_(scale))


def init_norm(w: torch.Tensor) -> torch.Tensor:
    return w.fill_(1.0)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32. x enters through one node (the cast, or of a
    float32 x a view), so that the gradients of its uses in here add up
    there before they reach x, as they do where x is first all-gathered
    (`tp_enter`)."""
    xf = _as_f32(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype != torch.float32 else x.view_as(x)


@dataclasses.dataclass(frozen=True)
class TP:
    """This rank's place on the model axis of a process-group mesh: the
    axis, its size, this rank's index along it, and the residual layout
    (``cfg.residual``)."""
    mesh: object
    axis: object
    size: int
    index: int
    residual: str


def tp_of(cfg) -> TP | None:
    """The model axis of the current parallel context, or None where the
    context spans no process group or has no model axis."""
    ctx = current_ctx()
    axes = ctx.axes("tp") if ctx.distributed else None
    if not axes:
        return None
    if cfg.residual not in ("tp", "replicated"):
        raise ValueError(f"residual layout {cfg.residual!r}")
    mesh = ctx.mesh
    return TP(mesh, axes[0] if len(axes) == 1 else tuple(axes),
              mesh.axis_size(axes), mesh.axis_index(axes), cfg.residual)


def whole_block(tp: TP | None, local: int, full: int) -> bool:
    """Whether a block whose weight has `local` of `full` columns here is
    replicated whole over a model axis above 1 (its heads or columns not
    divisible by it)."""
    return tp is not None and tp.size > 1 and local == full


def rms_norm_tp(x: torch.Tensor, w: torch.Tensor, tp: TP,
                eps: float = 1e-6) -> torch.Tensor:
    """`rms_norm` over a last dimension cut over the model axis: the mean
    of squares is the ranks' means of their blocks summed (`psum`: each
    rank scales only its own block) over the axis size. `w` is the whole
    weight (this rank's block of it is taken) or the block."""
    xf = _as_f32(x)
    var = psum((xf * xf).mean(dim=-1, keepdim=True), tp.axis,
               tp.mesh) / tp.size
    n = x.shape[-1]
    if w.shape[0] != n:
        w = w.narrow(0, tp.index * n, n)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def tp_enter(x: torch.Tensor, w: torch.Tensor, tp: TP | None,
             whole: bool = False) -> torch.Tensor:
    """A block's pre-norm with weight `w` and its way in: the whole normed
    input, on each rank (module docstring). Under residual "tp" the
    residual's blocks are all-gathered and every rank norms the whole (the
    same bytes as gathering the normed blocks, and no sum of squares to
    reduce). Without a model axis `rms_norm`."""
    if tp is None:
        return rms_norm(x, w)
    if tp.residual == "tp":
        return rms_norm(all_gather(x, tp.axis, x.ndim - 1, tp.mesh), w)
    h = rms_norm(x, w)
    return h if whole else replicated_copy(h, tp.axis, tp.mesh)


def tp_leave(y: torch.Tensor, tp: TP | None, whole: bool = False) -> torch.Tensor:
    """A block's output back into the residual's layout: `y` is the
    row-parallel product's partial sum, or with `whole` the whole output
    every rank computed."""
    if tp is None:
        return y
    if whole:
        if tp.residual != "tp":
            return y
        n = y.shape[-1] // tp.size
        return y.narrow(-1, tp.index * n, n)
    if tp.residual == "tp":
        return psum_scatter(y, tp.axis, y.ndim - 1, tp.mesh)
    return psum_replicated(y, tp.axis, tp.mesh)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim//2), float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE on split halves (not interleaved pairs).
    x (..., T, H, D); cos/sin (..., T, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """GQA attention over a full sequence (prefill, an encoder, cross
    attention): q (B, Tq, Hq, D), k/v (B, Tk, Hkv, D) -> (B, Tq, Hq, D),
    through B6 in its (B, H, T, D) layout. Causal or not; Tq may differ
    from Tk (cross attention)."""
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), causal=causal)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One new token per sequence, q (B, Hq, D), against (B, S, Hkv, D)
    caches valid below ``lengths`` (B,), through B7."""
    return ops.decode_attention(q, k_cache, v_cache,
                                lengths.to(torch.int32).contiguous())


def decode_attention_merged(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, lengths: torch.Tensor,
                            tp: TP) -> torch.Tensor:
    """`decode_attention` against a cache cut by sequence over the model
    axis: this rank's block (B, S_loc, Hkv, D) holds positions [r S_loc,
    (r + 1) S_loc), r its index on the axis; q (B, Hq, D) and ``lengths``
    (B,) are every rank's whole. B7 runs on the local lengths ``clamp(
    lengths - r S_loc, 0, S_loc)`` and returns each row's output o_r and
    its statistics (M_r, L_r); then, with M* the maximum of the M_r over
    the axis and w_r = L_r exp(M_r - M*), out = sum_r o_r w_r / sum_r w_r
    (0 where the sum is 0), one all-reduce of the (o_r w_r, w_r) rows. A
    rank whose positions all lie at or past a sequence's length has L = 0
    and weighs nothing. Returns (B, Hq, D) in q's type, on every rank."""
    S_loc = k_cache.shape[1]
    local = torch.clamp(lengths.to(torch.int32) - tp.index * S_loc, 0, S_loc)
    o, st = ops.decode_attention(q, k_cache, v_cache,
                                 local.to(torch.int32).contiguous(), stats=True)
    m, l = st[..., 0], st[..., 1]
    w = l * torch.exp(m - pmax(m, tp.axis, tp.mesh))
    both = psum_replicated(torch.cat([o.float() * w[..., None], w[..., None]],
                                     dim=-1), tp.axis, tp.mesh)
    num, den = both[..., :-1], both[..., -1:]
    return torch.where(den > 0, num / den, torch.zeros_like(num)).to(q.dtype)


class MLP(nn.Module):
    """Gated (swiglu) or plain (gelu) feed-forward weights."""

    def __init__(self, d: int, d_ff: int, act: str, dtype, device):
        super().__init__()
        self.w_up = param((d, d_ff), dtype, device)
        self.w_down = param((d_ff, d), dtype, device)
        if act == "swiglu":
            self.w_gate = param((d, d_ff), dtype, device)
        else:
            self.register_parameter("w_gate", None)


def mlp(x: torch.Tensor, w: MLP, act: str) -> torch.Tensor:
    if act == "swiglu":
        gate = x @ w.w_gate
        up = x @ w.w_up
        h = F.silu(gate.float()).to(x.dtype) * up
    else:  # gelu (tanh approximation, as jax.nn.gelu)
        h = x @ w.w_up
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ w.w_down


def init_mlp(m: MLP, gen: torch.Generator) -> MLP:
    """Fill `m`'s weights from `gen`, in the reference's order; returns m."""
    init_dense(m.w_up, gen)
    init_dense(m.w_down, gen)
    if m.w_gate is not None:
        init_dense(m.w_gate, gen)
    return m
