"""Public entry points of the port's kernels that the reference exposes in
`repro.kernels.ops`.

Each picks its path from the device of its input: a CUDA tensor goes to the
hand-written kernel (which raises if it cannot launch), a CPU tensor to the
kernel's plain PyTorch version. There is no fallback between the two.
`flash_attention` and `mamba_scan` are differentiable: when gradients are
on and an input wants one, they run through an autograd function whose
backward is B6b or B8b (the plain pair on the CPU); otherwise they build no
graph, so serving pays nothing for autograd.
"""
from __future__ import annotations

import torch

from .decode_attention import decode_attention_kernel_call, decode_attention_plain
from .feature_extract import flow_stats_kernel_call, flow_stats_plain
from .flash_attention import (
    FlashAttention,
    flash_attention_kernel_call,
    flash_attention_plain,
)
from .mamba_scan import MambaScan, mamba_scan_kernel_call, mamba_scan_plain
from .tree_infer import forest_infer_kernel_call, forest_infer_plain

__all__ = ["decode_attention", "flash_attention", "flow_stats", "forest_infer",
           "mamba_scan"]


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def forest_infer(x, feature, threshold, leaf, depth: int, *,
                 block_t: int = 8) -> torch.Tensor:
    """Dense forest inference, (N, F) features -> (N, K) mean votes."""
    if x.is_cuda:
        return forest_infer_kernel_call(x, feature, threshold, leaf, depth,
                                        block_t=block_t)
    return forest_infer_plain(x, feature, threshold, leaf, depth,
                              block_t=block_t)


def flow_stats(values, mask) -> torch.Tensor:
    """Masked per-flow statistics, (N, P) values and mask -> (N, 5) float32
    count, sum, sum of squares, min, max (min and max 0 on an empty row).
    Any N: the ragged edge is masked, not padded."""
    if values.is_cuda:
        return flow_stats_kernel_call(values, mask)
    return flow_stats_plain(values, mask)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """GQA attention, q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D) -> q's shape.
    Any Tq and Tk: ragged edges are masked, not padded."""
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, scale, not q.is_cuda)
    if q.is_cuda:
        return flash_attention_kernel_call(q, k, v, causal=causal, scale=scale)
    return flash_attention_plain(q, k, v, causal=causal, scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: float | None = None) -> torch.Tensor:
    """One-token GQA attention, q (B, Hq, D) against (B, S, Hkv, D) caches
    valid below ``lengths`` (B,) -> (B, Hq, D)."""
    if q.is_cuda:
        return decode_attention_kernel_call(q, k_cache, v_cache, lengths,
                                            scale=scale)
    return decode_attention_plain(q, k_cache, v_cache, lengths, scale=scale)


def mamba_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Chunked SSD scan -> (y (B, T, H, P), final state (B, H, P, S)).
    Unlike the reference's, which returns y only, this returns the state
    too, and takes any T."""
    if _wants_grad(x, dt, A, Bm, Cm):
        return MambaScan.apply(x, dt, A, Bm, Cm, chunk, not x.is_cuda)
    if x.is_cuda:
        return mamba_scan_kernel_call(x, dt, A, Bm, Cm, chunk=chunk)
    return mamba_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
