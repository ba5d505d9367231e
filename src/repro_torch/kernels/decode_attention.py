"""One-token GQA attention against a KV cache: the CUDA kernel B7 and its
plain version.

Port of `repro.kernels.decode_attention`: one new query token per sequence,
q (B, Hq, D), attends to a (B, S, Hkv, D) cache whose positions at or past
``lengths[b]`` are masked; the g = Hq / Hkv query heads of a group share
one pass over the cache. As in the TPU kernel a sequence of length 0 gives
0 (the jnp oracle gives NaN).

`decode_attention_kernel_call` launches ``csrc/decode_attention.cu`` (see
the source note); `decode_attention_plain` computes the same function with
torch ops, in float32. `repro_torch.kernels.ops.decode_attention` picks
between them by the device of `q`.
"""
from __future__ import annotations

import torch

from ._build import check_tensor, launch
from .flash_attention import HEAD_DIMS

__all__ = ["MAX_GROUP", "decode_attention_kernel_call", "decode_attention_plain"]

MAX_GROUP = 16   # query heads per kv head; kMaxGroup in the source
_DTYPES = (torch.float32, torch.bfloat16)


def _shapes(q, k_cache, v_cache, lengths):
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("expected q (B, Hq, D) and caches (B, S, Hkv, D), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != B or k_cache.shape[3] != D or Hkv < 1 or Hq % Hkv
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)}: batch and head size "
                         "must match and Hq be a multiple of Hkv")
    return B, Hq, Hkv, S, D


def decode_attention_plain(q, k_cache, v_cache, lengths, *,
                           scale: float | None = None) -> torch.Tensor:
    """(B, Hq, D) attention output in q's type; runs on any device."""
    B, Hq, Hkv, S, D = _shapes(q, k_cache, v_cache, lengths)
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, g, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    out = out / torch.where(den > 0, den, torch.ones_like(den))
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention_kernel_call(q, k_cache, v_cache, lengths, *,
                                 scale: float | None = None) -> torch.Tensor:
    """Launch the B7 CUDA kernel on CUDA tensors; returns (B, Hq, D) in q's
    type.

    q and the caches are contiguous, of one type (float32 or bfloat16),
    with D in `HEAD_DIMS` and at most `MAX_GROUP` query heads per kv head;
    lengths is int32 (B,). Anything else raises. Launches on the current
    stream and does not synchronise.
    """
    B, Hq, Hkv, S, D = _shapes(q, k_cache, v_cache, lengths)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel takes D in {HEAD_DIMS}")
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{Hq // Hkv} query heads per kv head: the kernel "
                         f"takes at most {MAX_GROUP}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes float32 or bfloat16")
    dev = q.device
    check_tensor("q", q, q.dtype, (B, Hq, D), dev)
    check_tensor("k_cache", k_cache, q.dtype, (B, S, Hkv, D), dev)
    check_tensor("v_cache", v_cache, q.dtype, (B, S, Hkv, D), dev)
    check_tensor("lengths", lengths, torch.int32, (B,), dev)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else D ** -0.5
    launch("decode_attention_launch", dev,
           q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D,
           int(q.dtype == torch.bfloat16), float(scale))
    decode_attention_kernel_call.launches += 1
    return out


decode_attention_kernel_call.launches = 0
