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
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import ops

__all__ = [
    "MLP",
    "apply_rope",
    "attention",
    "decode_attention",
    "init_dense",
    "init_mlp",
    "init_norm",
    "mlp",
    "param",
    "rms_norm",
    "rope_cos_sin",
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
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


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
