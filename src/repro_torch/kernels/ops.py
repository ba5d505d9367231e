"""Public entry points of the port's kernels that the reference exposes in
`repro.kernels.ops`.

Each picks its path from the device of its input: a CUDA tensor goes to the
hand-written kernel (which raises if it cannot launch), a CPU tensor to the
kernel's plain PyTorch version. There is no fallback between the two.
`flash_attention` and `mamba_scan` are differentiable: when gradients are
on and an input wants one, they run through an autograd function whose
backward is B6b or B8b (the plain pair on the CPU); otherwise they build no
graph, so serving pays nothing for autograd.

A meta tensor (the census, `repro_torch.launch.step_stats`, runs a step
on them) takes neither: B6, B6b, B7, B8 and B8b return empty outputs of
their shapes (through `_MetaFlash` and `_MetaScan` where gradients flow)
and add their closed-form operations and bytes to `meta_costs()`, the
counts `chip_smoke.py`'s bounds use: B6 4 D per attended (query, key)
pair and head, B6b 10 D; B7 4 D per cached position and query head (the
census counts a full cache); B8 the chunked form's products, B8b twice
them; bytes each input read and each output written once. Running their
plain versions on meta would walk every block and chunk in Python.
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
           "mamba_scan", "meta_costs", "reset_meta_costs"]

_META_COSTS: dict = {}


def reset_meta_costs() -> None:
    _META_COSTS.clear()


def meta_costs() -> dict:
    """{kernel: {"calls", "flops", "bytes"}} of the kernels run on meta
    tensors since the last `reset_meta_costs`."""
    return {k: dict(v) for k, v in _META_COSTS.items()}


def _tally(name: str, flops: int, nbytes: int) -> None:
    c = _META_COSTS.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
    c["calls"] += 1
    c["flops"] += int(flops)
    c["bytes"] += int(nbytes)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _attn_pairs(q, k, causal: bool) -> int:
    """(query, key) pairs one head of q (B, H, Tq, D) attends of k's Tk:
    under a causal mask the query i of Tq sees the keys up to i + Tk - Tq
    (B6's bottom-right alignment)."""
    Tq, Tk = q.shape[2], k.shape[2]
    if not causal:
        return Tq * Tk
    return int(torch.clamp(torch.arange(Tq) + (Tk - Tq + 1), 0, Tk).sum())


class _MetaFlash(torch.autograd.Function):
    """B6 and B6b on meta tensors: shapes and costs only."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        B, H, _, D = q.shape
        ctx.save_for_backward(q, k, v)
        ctx.ops = B * H * D * _attn_pairs(q, k, causal)
        _tally("flash_attention", 4 * ctx.ops, 2 * _nbytes(q) + _nbytes(k, v))
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        _tally("flash_attention_bwd", 10 * ctx.ops, 4 * _nbytes(q)
               + 2 * _nbytes(k, v))
        return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
                None)


def _scan_ops(x, Bm, chunk: int) -> int:
    B, T, H, P = x.shape
    S, c = Bm.shape[-1], chunk
    tri = c * (c + 1) // 2
    return B * H * -(-T // c) * (tri * 2 * S + tri * 2 * P + 4 * c * P * S)


class _MetaScan(torch.autograd.Function):
    """B8 and B8b on meta tensors: shapes and costs only."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        B, _, H, P = x.shape
        h = torch.empty((B, H, P, Bm.shape[-1]), dtype=torch.float32,
                        device=x.device)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        _tally("mamba_scan", _scan_ops(x, Bm, chunk),
               2 * _nbytes(x) + _nbytes(dt, A, Bm, Cm, h))
        return torch.empty_like(x), h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        _tally("mamba_scan_bwd", 2 * _scan_ops(x, Bm, ctx.chunk),
               3 * _nbytes(x) + 2 * _nbytes(dt, A, Bm, Cm))
        return (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A),
                torch.empty_like(Bm), torch.empty_like(Cm), None)


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
    if q.is_meta:
        return _MetaFlash.apply(q, k, v, causal)
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, scale, not q.is_cuda)
    if q.is_cuda:
        return flash_attention_kernel_call(q, k, v, causal=causal, scale=scale)
    return flash_attention_plain(q, k, v, causal=causal, scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: float | None = None, stats: bool = False):
    """One-token GQA attention, q (B, Hq, D) against (B, S, Hkv, D) caches
    valid below ``lengths`` (B,) -> (B, Hq, D); with `stats` also the
    rows' float32 (B, Hq, 2) softmax statistics (M, L)."""
    if q.is_meta:
        B, Hq, D = q.shape
        S = k_cache.shape[1]
        _tally("decode_attention", 4 * D * Hq * B * S,
               2 * _nbytes(q) + _nbytes(k_cache, v_cache, lengths))
        out = torch.empty_like(q)
        if stats:
            return out, torch.empty((B, Hq, 2), dtype=torch.float32,
                                    device=q.device)
        return out
    if q.is_cuda:
        return decode_attention_kernel_call(q, k_cache, v_cache, lengths,
                                            scale=scale, stats=stats)
    return decode_attention_plain(q, k_cache, v_cache, lengths, scale=scale,
                                  stats=stats)


def mamba_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Chunked SSD scan -> (y (B, T, H, P), final state (B, H, P, S)).
    Unlike the reference's, which returns y only, this returns the state
    too, and takes any T."""
    if x.is_meta:
        return _MetaScan.apply(x, dt, A, Bm, Cm, chunk)
    if _wants_grad(x, dt, A, Bm, Cm):
        return MambaScan.apply(x, dt, A, Bm, Cm, chunk, not x.is_cuda)
    if x.is_cuda:
        return mamba_scan_kernel_call(x, dt, A, Bm, Cm, chunk=chunk)
    return mamba_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
