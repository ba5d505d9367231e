"""GQA attention over a full sequence: the CUDA kernel B6 and its plain
version.

Port of `repro.kernels.flash_attention` (online-softmax attention tiled
over query and key blocks, causal blocks above the diagonal skipped). The
semantics are the TPU kernel's, which differ from the jnp oracle
`repro_torch.kernels.ref.flash_attention_ref` in one place: a row that may
see no key (causal with ``Tq > Tk``) gives 0 where the oracle gives NaN.
Causal rows see keys up to their position plus ``Tk - Tq``. Ragged
``Tq`` and ``Tk`` are handled in the kernel; nothing is padded.

`flash_attention_kernel_call` launches ``csrc/flash_attention.cu`` (see the
source note for its design and bound); `flash_attention_plain` computes the
same function with torch ops in the kernel's order of arithmetic: an
online softmax over tiles of 64 keys, masked entries weighted 0, a row
with no valid key 0. On the card the two agree to the last bit where the
GEMMs accumulate each tile in key order, and to float32 rounding
elsewhere; a one-pass softmax differs from the kernel by enough to flip
bf16 roundings, which a deep bf16 model amplifies.
`repro_torch.kernels.ops.flash_attention` picks between them by the device
of `q`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_tensor, launch

__all__ = ["HEAD_DIMS", "TILE_K", "flash_attention_kernel_call",
           "flash_attention_plain"]

HEAD_DIMS = (32, 64, 128)   # the head sizes the kernel is compiled for
TILE_K = 64                 # keys per tile, kBK in the source
_DTYPES = (torch.float32, torch.bfloat16)


def _shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("expected q (B, Hq, Tq, D) and k, v (B, Hkv, Tk, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch "
                         "and head size must match and Hq be a multiple of Hkv")
    return B, Hq, Hkv, Tq, Tk, D


def _lane_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (64 keys) in the kernel's order: each lane's
    keys j and j + 32, then the xor butterfly over 32 lanes."""
    x = p[..., :32] + p[..., 32:]
    for w in (16, 8, 4, 2, 1):
        x = x[..., :w] + x[..., w:2 * w]
    return x


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    """(B, Hq, Tq, D) attention output in q's type; runs on any device.

    The kernel's online softmax, tile by tile of `TILE_K` keys: the running
    max from -1e30 over valid keys, ``l = l * alpha + sum(p)`` (the sum in
    the kernel's lane order), ``acc = acc * alpha + p @ v_tile``; masked
    keys weigh 0, and a row with no valid key gives 0."""
    B, Hq, Hkv, Tq, Tk, D = _shapes(q, k, v)
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    pad = (-Tk) % TILE_K
    kf = F.pad(k.float(), (0, 0, 0, pad)).repeat_interleave(g, dim=1)
    vf = F.pad(v.float(), (0, 0, 0, pad)).repeat_interleave(g, dim=1)
    qf = q.float()
    dev = q.device
    qpos = torch.arange(Tq, device=dev)[:, None] + (Tk - Tq)
    m = torch.full((B, Hq, Tq, 1), -1e30, device=dev)
    l = torch.zeros((B, Hq, Tq, 1), device=dev)
    acc = torch.zeros((B, Hq, Tq, D), device=dev)
    for k0 in range(0, Tk + pad, TILE_K):
        s = torch.matmul(qf, kf[:, :, k0:k0 + TILE_K].transpose(-1, -2)) * scale
        key = k0 + torch.arange(TILE_K, device=dev)[None, :]
        valid = key < Tk
        if causal:
            valid = valid & (key <= qpos)
        m_new = torch.maximum(
            m, s.masked_fill(~valid, -1e30).amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
        l = l * alpha + _lane_sum(p)
        acc = acc * alpha + torch.matmul(p, vf[:, :, k0:k0 + TILE_K])
        m = m_new
    out = torch.where(l > 0, acc / l, torch.zeros_like(acc))
    return out.to(q.dtype)


def flash_attention_kernel_call(q, k, v, *, causal: bool = True,
                                scale: float | None = None) -> torch.Tensor:
    """Launch the B6 CUDA kernel on CUDA tensors; returns (B, Hq, Tq, D) in
    q's type.

    q, k and v are contiguous, of one type (float32 or bfloat16), with head
    size D in `HEAD_DIMS`; anything else raises. Launches on the current
    stream and does not synchronise.
    """
    B, Hq, Hkv, Tq, Tk, D = _shapes(q, k, v)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel takes D in {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes float32 or bfloat16")
    dev = q.device
    check_tensor("q", q, q.dtype, (B, Hq, Tq, D), dev)
    check_tensor("k", k, q.dtype, (B, Hkv, Tk, D), dev)
    check_tensor("v", v, q.dtype, (B, Hkv, Tk, D), dev)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else D ** -0.5
    launch("flash_attention_launch", dev,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           B, Hq, Hkv, Tq, Tk, D, int(causal), int(q.dtype == torch.bfloat16),
           float(scale))
    flash_attention_kernel_call.launches += 1
    return out


flash_attention_kernel_call.launches = 0
