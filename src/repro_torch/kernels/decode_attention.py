"""One-token GQA attention against a KV cache: the CUDA kernel B7 and its
plain version.

Port of `repro.kernels.decode_attention`: one new query token per sequence,
q (B, Hq, D), attends to a (B, S, Hkv, D) cache whose positions at or past
``lengths[b]`` are masked; the g = Hq / Hkv query heads of a group share
one pass over the cache. As in the TPU kernel a sequence of length 0 gives
0 (the jnp oracle gives NaN).

`decode_attention_kernel_call` launches ``csrc/decode_attention.cu``: a
split-S kernel over (kv head, batch, split), then a merge of each row's
splits in split order (see the source note). The splits come from
`split_plan`, a function of (B, Hkv, S) alone, so the launch reads
nothing back and a CUDA graph can capture it.
`decode_attention_plain` computes the same function with torch ops in the
kernel's arithmetic, step by step:

- the same splits; each score a chain over a lane's `VEC` columns
  (product, then add), the row's ``D / VEC`` lanes summed in the xor
  butterfly, times scale;
- per split, m = max(-1e30, the valid scores) and p = exp(s - m);
- per split, stripe ``j % stripes`` of position j adds ``l += p`` and
  ``acc += p * v`` in position order from 0; the stripes meet in adjacent
  pairs within a warp, then in warp order;
- the merge: M = max of the splits' m, e = exp(m_s - M), ``L += l_s * e``,
  ``O += acc_s * e`` in split order, out = O / L (0 where L = 0).

With ``stats=True`` both also return each row's softmax statistics,
float32 (B, Hq, 2): M, the maximum of the splits' maxima (-1e30 for an
empty row), and L, the merge's rescaled sum (0 for an empty row), the
values the merge forms before it writes O / L. They let ranks that hold
other positions of the same rows merge their outputs with this one
(`repro_torch.models.layers.decode_attention_merged`); `out` is the same
with or without them.

On the card the two agree to the last bit in float32 and bfloat16 (bf16
products are exact in float32; float32 ones round once on both sides),
the statistics included.
A head dim below a tile width (`flash_attention.tile_width`: the reduced
configs' 8, 12, 16, 20) runs the next width's layout on zero-padded rows
in both.
`repro_torch.kernels.ops.decode_attention` picks between them by the
device of `q`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ._build import check_tensor, launch
from .flash_attention import check_head_dim, pad_head, tile_width

__all__ = ["MAX_GROUP", "MAX_SPLIT_LEN", "SPLIT_TILE", "decode_attention_kernel_call",
           "decode_attention_plain", "split_plan"]

MAX_GROUP = 16       # query heads per kv head; the source's widest G
VEC = 8              # columns a lane holds of a row (kVec)
WARPS = 4            # warps of a split block (kWarps)
SPLIT_TILE = 64      # positions a cp.async stage holds (kTile)
MAX_SPLIT_LEN = 1024   # the scores of a split stay in shared memory
# blocks to aim for: about 8 per SM of the H100's 132 (about 5 fit at
# once). Splits past their sequence's length end at once, and more, shorter
# splits spread the rest more evenly over the SMs than 4 per SM did
TARGET_BLOCKS = 8 * 132
_DTYPES = (torch.float32, torch.bfloat16)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(B: int, Hkv: int, S: int) -> tuple[int, int]:
    """(n_split, split_len) of the cache axis for batch B, Hkv kv heads and
    S positions: about TARGET_BLOCKS blocks of (kv head, batch, split),
    splits of whole SPLIT_TILE tiles (at least one, at most MAX_SPLIT_LEN
    positions), ``n_split * split_len >= S``. Depends on the shapes only."""
    want = min(max(1, _cdiv(TARGET_BLOCKS, max(1, B * Hkv))),
               max(1, _cdiv(S, SPLIT_TILE)))
    split_len = SPLIT_TILE * _cdiv(max(1, _cdiv(S, want)), SPLIT_TILE)
    split_len = min(split_len, MAX_SPLIT_LEN)
    return max(1, _cdiv(S, split_len)), split_len


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


def _layout(D: int) -> tuple[int, int, int]:
    """(lanes a row, columns a lane, row groups a warp) of the kernel at
    tile width D (32, 64 or 128). A D that no kernel takes (odd, or above
    128) gets one lane a row and D 128's stripes."""
    if tile_width(D) == D:
        return D // VEC, VEC, 32 * VEC // D
    return 1, D, 2


def _scale(scale: float | None, D: int) -> float:
    # the kernel takes scale as a float32
    return float(np.float32(scale if scale is not None else D ** -0.5))


def decode_attention_plain(q, k_cache, v_cache, lengths, *,
                           scale: float | None = None, stats: bool = False):
    """(B, Hq, D) attention output in q's type, and with `stats` the rows'
    float32 (B, Hq, 2) (M, L) after it; runs on any device, in the
    kernel's order (see the module note)."""
    B, Hq, Hkv, S, D = _shapes(q, k_cache, v_cache, lengths)
    scale = _scale(scale, D)
    width = tile_width(D) or D
    if width != D:     # the kernel's zero-padded rows
        got = decode_attention_plain(pad_head(q, width),
                                     pad_head(k_cache, width),
                                     pad_head(v_cache, width), lengths,
                                     scale=scale, stats=stats)
        if stats:
            return got[0][..., :D].contiguous(), got[1]
        return got[..., :D].contiguous()
    g = Hq // Hkv
    n_split, L = split_plan(B, Hkv, S)
    lanes, vec, rows_per_warp = _layout(D)
    stripes = WARPS * rows_per_warp
    dev = q.device
    pad = n_split * L - S

    def splits(c):                   # (B, S, Hkv, D) -> (B, Hkv, ns, L, D)
        c = F.pad(c.float(), (0, 0, 0, 0, 0, pad))
        return c.reshape(B, n_split, L, Hkv, D).permute(0, 3, 1, 2, 4)

    kf, vf = splits(k_cache), splits(v_cache)
    pos = torch.arange(n_split * L, device=dev).reshape(n_split, L)
    valid = (pos[None] < lengths.to(dev).long()[:, None, None])[:, None, :, None]
    # 1. scores (B, Hkv, ns, g, L): lane chains, then the butterfly
    x = (q.float().reshape(B, Hkv, 1, g, 1, D) * kf[:, :, :, None]).unflatten(
        -1, (lanes, vec))
    c = x[..., 0]
    for e in range(1, vec):
        c = c + x[..., e]
    w = lanes
    while w > 1:
        w //= 2
        c = c[..., :w] + c[..., w:2 * w]
    s = c[..., 0] * scale
    del x, c
    # 2. the split's maximum and p
    m = s.masked_fill(~valid, -1e30).amax(dim=-1, keepdim=True).clamp(min=-1e30)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    # 3. stripes in position order
    pr = p.unflatten(-1, (L // stripes, stripes))        # (..., g, I, R)
    vr = vf.unflatten(3, (L // stripes, stripes))        # (B, Hkv, ns, I, R, D)
    vd = valid.unflatten(-1, (L // stripes, stripes))    # (B, 1, ns, 1, I, R)
    acc = torch.zeros((B, Hkv, n_split, g, stripes, D), device=dev)
    l = torch.zeros((B, Hkv, n_split, g, stripes), device=dev)
    for i in range(L // stripes):
        pi = pr[..., i, :]
        l = l + pi
        acc = acc + torch.where(vd[..., i, :, None],
                                pi[..., None] * vr[:, :, :, None, i],
                                torch.zeros((), device=dev))
    # 4. adjacent pairs within a warp, then warp order
    acc = acc.unflatten(-2, (WARPS, rows_per_warp))
    l = l.unflatten(-1, (WARPS, rows_per_warp))
    while acc.shape[-2] > 1:
        acc = acc[..., 0::2, :] + acc[..., 1::2, :]
        l = l[..., 0::2] + l[..., 1::2]
    acc, l = acc[..., 0, :], l[..., 0]                    # (..., g, W, D)
    a_s, l_s = acc[..., 0, :], l[..., 0]
    for wi in range(1, WARPS):
        a_s = a_s + acc[..., wi, :]
        l_s = l_s + l[..., wi]
    # the merge, in split order: a_s (B, Hkv, ns, g, D), l_s and m_s (.., g)
    m_s = m[..., 0]
    m_max = m_s.amax(dim=2, keepdim=True)
    e = torch.exp(m_s - m_max)
    den = torch.zeros((B, Hkv, g), device=dev)
    num = torch.zeros((B, Hkv, g, D), device=dev)
    for si in range(n_split):
        den = den + l_s[:, :, si] * e[:, :, si]
        num = num + a_s[:, :, si] * e[:, :, si, :, None]
    out = torch.where(den[..., None] > 0, num / den[..., None],
                      torch.zeros_like(num)).reshape(B, Hq, D).to(q.dtype)
    if stats:
        return out, torch.stack([m_max[:, :, 0], den], dim=-1).reshape(B, Hq, 2)
    return out


def decode_attention_kernel_call(q, k_cache, v_cache, lengths, *,
                                 scale: float | None = None,
                                 stats: bool = False):
    """Launch the B7 CUDA kernels on CUDA tensors; returns (B, Hq, D) in q's
    type, and with `stats` the rows' float32 (B, Hq, 2) (M, L) after it,
    written by the merge kernel.

    q and the caches are contiguous, of one type (float32 or bfloat16),
    start on 16-byte boundaries, with an even D from 2 to 128 and at most
    `MAX_GROUP` query heads per kv head; lengths is int32 (B,). Anything
    else raises. Allocates the (B, Hq, n_split, D + 2) float32 workspace of
    the splits' partial states and the output with `torch.empty`, launches
    the split and merge kernels on the current stream, and neither
    synchronises nor reads anything back, so a CUDA graph can capture the
    call.
    """
    B, Hq, Hkv, S, D = _shapes(q, k_cache, v_cache, lengths)
    check_head_dim(D)
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
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("the kernel loads q and the caches as 16-byte "
                         "vectors: each must start on a 16-byte boundary")
    out = torch.empty_like(q)
    st = torch.empty((B, Hq, 2), dtype=torch.float32, device=dev) \
        if stats else None
    if out.numel() == 0:
        return (out, st) if stats else out
    n_split, split_len = split_plan(B, Hkv, S)
    ws = torch.empty((B, Hq, n_split, D + 2), dtype=torch.float32, device=dev)
    launch("decode_attention_launch", dev,
           q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           lengths.data_ptr(), ws.data_ptr(), out.data_ptr(),
           st.data_ptr() if stats else None, B, Hq, Hkv, S, D,
           int(q.dtype == torch.bfloat16), split_len, n_split,
           _scale(scale, D))
    decode_attention_kernel_call.launches += 1
    return (out, st) if stats else out


decode_attention_kernel_call.launches = 0
