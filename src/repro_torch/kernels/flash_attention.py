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
source note for its design and bound): bfloat16 inputs go to a tensor-core
kernel (wgmma on 64-key tiles that TMA loads), float32 inputs to a scalar
float32 kernel. `flash_attention_plain` computes the same function with
torch ops in each kernel's arithmetic, an online softmax over tiles of
`TILE_K` keys, masked entries weighted 0, a row with no valid key 0:

- float32: the scalar kernel's order, each tile's row sum in its lane
  butterfly (`_lane_sum`).
- bfloat16: the tensor-core kernel's, S and P V as bf16 GEMMs into float32
  (cuBLAS's on the card, which sum as wgmma does), exp2 of the scores
  times scale * log2(e), P rounded to bf16, the row sum l over that
  rounded P in the kernel's quad order (`_quad_sum`), ``acc = acc * alpha
  + P_bf16 @ V``.

On the card each agrees with its kernel to the last bit; a difference of
one bf16 rounding, carried through a deep random bf16 model, would move
some of its argmaxes. On the CPU the bf16 GEMMs are float32 products, one
rounding from the card's.

Head dims: the kernels are compiled for the tile widths `TILE_HEAD_DIMS`
(32, 64, 128) and take any even D up to `MAX_HEAD_DIM` (the reduced
configs' 8, 12, 16 and 20 among them) by running the next width
(`tile_width`) on rows zero-padded in shared memory: the float32 kernel
pads as it loads, the bf16 kernel's TMA boxes reach past the rows' ends.
TMA needs rows of a multiple of 16 bytes, so the wrapper first zero-pads
a bf16 D that is not a multiple of 8 (12, 20) to the next one, and keeps
the first D columns of the result. The plain versions pad to the tile
width: zero columns, the tile width's arithmetic, the first D columns.
`repro_torch.kernels.ops.flash_attention` picks between kernel and plain
version by the device of `q`.

The gradient (B6b, which no TPU kernel has: the reference trains through
XLA's autodiff) is `FlashAttention`, a `torch.autograd.Function` whose
backward launches ``csrc/flash_attention_bwd.cu``
(`flash_attention_bwd_kernel_call`) on the card and runs
`flash_attention_bwd_plain` on the CPU. Both recompute the softmax
statistics from q and k, so the forward writes nothing more when a
gradient is wanted, and the serving launch is unchanged. Two launches (dQ,
then dK and dV, a kv head's query heads and tiles in order), no atomics,
so a gradient is the same bits every run. float32 runs scalar kernels in
float32 (products of depth D or 64 as fmaf chains); bfloat16 runs
tensor-core kernels (wgmma on tiles that TMA loads): B6's own statistics
pass, P and dS rounded to bf16, every product a bf16 wgmma into float32
of depth D or 64, each tile's product from zero, added in a fixed order.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ._build import check_tensor, launch

__all__ = ["MAX_HEAD_DIM", "TILE_HEAD_DIMS", "TILE_K", "FlashAttention",
           "check_head_dim", "flash_attention_bwd_kernel_call",
           "flash_attention_bwd_plain", "flash_attention_kernel_call",
           "flash_attention_plain", "pad_head", "tile_width"]

TILE_HEAD_DIMS = (32, 64, 128)   # the tile widths the kernels are compiled for
MAX_HEAD_DIM = 128
TILE_K = 64                 # keys per tile, kBK and kWgBK in the source
_DTYPES = (torch.float32, torch.bfloat16)
_LOG2E = 1.4426950408889634   # the kernel's float32 factor is scale * this


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


def tile_width(D: int) -> int | None:
    """The tile width B6's and B7's kernels run head dim D at: D itself
    for 32, 64 and 128, the next of those for any other even D up to 128
    (its rows zero-padded), None where no kernel takes D (odd, or above
    128)."""
    if D < 2 or D > MAX_HEAD_DIM or D % 2:
        return None
    return next(w for w in TILE_HEAD_DIMS if w >= D)


def check_head_dim(D: int) -> None:
    """Raise where no kernel takes head dim D (`tile_width` is None)."""
    if tile_width(D) is None:
        raise ValueError(f"head dim {D}: the kernels take an even head dim "
                         f"from 2 to {MAX_HEAD_DIM}")


def pad_head(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with its last axis zero-padded to `width`."""
    return F.pad(x, (0, width - x.shape[-1]))


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
    max from -1e30 over valid keys, ``l = l * alpha + sum(p)``, ``acc = acc
    * alpha + p @ v_tile``; masked keys weigh 0, and a row with no valid
    key gives 0. bfloat16 inputs follow the tensor-core kernel
    (`_plain_bf16`), float32 inputs the scalar kernel (`_plain_f32`)."""
    B, Hq, Hkv, Tq, Tk, D = _shapes(q, k, v)
    scale = scale if scale is not None else D ** -0.5
    width = tile_width(D) or D
    if width != D:     # the kernel's zero-padded rows
        out = flash_attention_plain(pad_head(q, width), pad_head(k, width),
                                    pad_head(v, width), causal=causal,
                                    scale=scale)
        return out[..., :D].contiguous()
    if q.dtype == torch.bfloat16:
        return _plain_bf16(q, k, v, causal, scale)
    return _plain_f32(q, k, v, causal, scale)


def _plain_f32(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """The scalar kernel's order: float32 GEMMs per tile, each tile's row
    sum in the kernel's lane order (`_lane_sum`)."""
    B, Hq, Hkv, Tq, Tk, D = _shapes(q, k, v)
    g = Hq // Hkv
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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, K) @ (..., K, N) in float32 from bf16 operands. On the card
    a bf16 GEMM with float32 output (the tensor cores, as the kernel's
    wgmma: exact products, float32 sums in 16-deep steps in K order);
    elsewhere a float32 product."""
    if not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    lead = a.shape[:-2]
    return torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                     out_dtype=torch.float32).reshape(*lead, a.shape[-2],
                                                      b.shape[-1])


def _quad_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (64 keys) in the tensor-core kernel's order:
    the thread holding keys 8j + 2q and 8j + 2q + 1 (q = lane % 4) adds
    each pair, then its 8 pairs in key order; the four threads' sums then
    meet in a quad shuffle, (s0 + s1) + (s2 + s3)."""
    x = p.unflatten(-1, (8, 4, 2))
    x = x[..., 0] + x[..., 1]
    t = x[..., 0, :]
    for j in range(1, 8):
        t = t + x[..., j, :]
    return ((t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3]))[..., None]


def _plain_bf16(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """The tensor-core kernel's arithmetic: S = Q K^T and P V as bf16 GEMMs
    into float32 (`_mm_f32`), the scores times scale * log2(e) rounded to
    float32 and exponentiated by exp2, P rounded to bf16, l summed over
    that rounded P in the kernel's order (`_quad_sum`), ``acc = acc *
    alpha + P_bf16 @ V`` with the tile's product from zero, out = acc / l.
    On the card this repeats the kernel wherever cuBLAS's GEMM sums as
    wgmma does."""
    acc, _, l = _online_bf16(q, k, v, causal, scale)
    out = torch.where(l > 0, acc / l, torch.zeros_like(acc))
    return out.to(q.dtype)


def _log2_factor(scale: float) -> float:
    """The kernel's float32 factor of the scores: scale and log2(e) as
    float32, multiplied."""
    return float(np.float32(np.float32(scale) * np.float32(_LOG2E)))


def _online_bf16(q, k, v, causal: bool, scale: float):
    """The tensor-core kernel's online softmax over 64-key tiles: (acc
    (B, Hq, Tq, D) float32 or None where v is None, the running max m
    (log2 units) and the row sum l, (B, Hq, Tq, 1) each)."""
    B, Hq, Hkv, Tq, Tk, D = _shapes(q, k, k)
    g = Hq // Hkv
    pad = (-Tk) % TILE_K
    kb = F.pad(k, (0, 0, 0, pad)).repeat_interleave(g, dim=1)
    vb = None if v is None else F.pad(v, (0, 0, 0, pad)).repeat_interleave(
        g, dim=1)
    c = _log2_factor(scale)
    dev = q.device
    qpos = torch.arange(Tq, device=dev)[:, None] + (Tk - Tq)
    m = torch.full((B, Hq, Tq, 1), -1e30, device=dev)
    l = torch.zeros((B, Hq, Tq, 1), device=dev)
    acc = None if v is None else torch.zeros((B, Hq, Tq, D), device=dev)
    for k0 in range(0, Tk + pad, TILE_K):
        s = _mm_f32(q, kb[:, :, k0:k0 + TILE_K].transpose(-1, -2)) * c
        key = k0 + torch.arange(TILE_K, device=dev)[None, :]
        valid = key < Tk
        if causal:
            valid = valid & (key <= qpos)
        s = s.masked_fill(~valid, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new).to(torch.bfloat16)
        l = l * alpha + _quad_sum(p.float())
        if acc is not None:
            acc = acc * alpha + _mm_f32(p, vb[:, :, k0:k0 + TILE_K])
        m = m_new
    return acc, m, l


def flash_attention_kernel_call(q, k, v, *, causal: bool = True,
                                scale: float | None = None) -> torch.Tensor:
    """Launch the B6 CUDA kernel on CUDA tensors; returns (B, Hq, Tq, D) in
    q's type.

    q, k and v are contiguous, of one type (float32 or bfloat16), with an
    even head size D from 2 to `MAX_HEAD_DIM` (`check_head_dim`); bfloat16
    tensors start on 16-byte boundaries (TMA reads them); anything else
    raises; a bfloat16 D that is not a multiple of 8 runs on copies
    zero-padded to the next one. Launches on the current stream and does
    not synchronise.
    """
    B, Hq, Hkv, Tq, Tk, D = _shapes(q, k, v)
    check_head_dim(D)
    if q.dtype == torch.bfloat16 and D % 8:
        width = D + 8 - D % 8
        out = flash_attention_kernel_call(
            pad_head(q, width), pad_head(k, width), pad_head(v, width),
            causal=causal, scale=scale if scale is not None else D ** -0.5)
        return out[..., :D].contiguous()
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes float32 or bfloat16")
    dev = q.device
    check_tensor("q", q, q.dtype, (B, Hq, Tq, D), dev)
    check_tensor("k", k, q.dtype, (B, Hkv, Tk, D), dev)
    check_tensor("v", v, q.dtype, (B, Hkv, Tk, D), dev)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 kernel loads q, k and v by TMA: each must "
                         "start on a 16-byte boundary")
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


def _stats_f32(qf, kf, causal: bool, scale: float, Tk: int):
    """The scalar kernel's running max m and row sum l over the 64-key
    tiles, (B, Hq, Tq, 1) each: `_plain_f32` without the output. kf is
    (B, Hq, Tk padded to TILE_K, D)."""
    B, Hq, Tq, _ = qf.shape
    dev = qf.device
    qpos = torch.arange(Tq, device=dev)[:, None] + (Tk - Tq)
    m = torch.full((B, Hq, Tq, 1), -1e30, device=dev)
    l = torch.zeros((B, Hq, Tq, 1), device=dev)
    for k0 in range(0, kf.shape[2], TILE_K):
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
        m = m_new
    return m, l


def flash_attention_bwd_plain(q, k, v, out, dout, *, causal: bool = True,
                              scale: float | None = None):
    """(dq, dk, dv) of B6's function at q, k, v, given its output `out` and
    the output's gradient `dout`, each in its input's type; runs on any
    device. Delta = dO . O is a float32 chain over the columns in order;
    then per 64-key tile S, P (0 where masked or l = 0), dP = dO V^T, dS =
    P (dP - Delta) scale and dQ += dS K; then, for each query head of a kv
    head's group in order and each 64-row query tile in order, dV += P^T dO
    and dK += dS^T Q, each tile's product from zero. A small D runs on rows
    zero-padded to the tile width, as the kernels; on the card a batch of
    one matrix runs as two equal ones, as `mamba_scan_plain` does, so that
    cuBLAS adds in k order.

    - float32 (`_bwd_f32`): the scalar kernel's arithmetic, m and l as
      B6's float32 loop, P = exp(S scale - m) / l, every product a float32
      GEMM of depth D or 64.
    - bfloat16 (`_bwd_bf16`): the tensor-core kernel's, m and l as B6's
      bf16 loop, P = exp2(S scale log2(e) - m) (1 / l) in float32, rounded
      to bf16 for dV, dS rounded to bf16, every product a bf16 GEMM into
      float32 (`_mm_f32`)."""
    B, Hq, Hkv, Tq, Tk, D = _shapes(q, k, v)
    scale = scale if scale is not None else D ** -0.5
    if q.is_cuda and B * Hkv == 1:
        grads = flash_attention_bwd_plain(
            *(t.expand(2, *t.shape[1:]) for t in (q, k, v, out, dout)),
            causal=causal, scale=scale)
        return tuple(g[:1].contiguous() for g in grads)
    dof, of = dout.float(), out.float()
    delta = torch.zeros((B, Hq, Tq, 1), device=q.device)
    for c in range(D):
        delta = delta + dof[..., c:c + 1] * of[..., c:c + 1]
    width = tile_width(D) or D
    padk = (-Tk) % TILE_K
    qw, kw, vw, dow = (pad_head(t, width) for t in (q, k, v, dout))
    bwd = _bwd_bf16 if q.dtype == torch.bfloat16 else _bwd_f32
    dq, P, DS = bwd(qw, kw, vw, dow, delta, causal, scale)
    g = Hq // Hkv
    padq = (-Tq) % TILE_K

    def by_group(x):   # (B, Hq, Tq, X) -> (B, Hkv, g, Tq padded, X)
        return F.pad(x, (0, 0, 0, padq)).unflatten(1, (Hkv, g))

    P, DS = by_group(P), by_group(DS)
    Qg, dOg = by_group(qw), by_group(dow)
    mm = _mm_f32 if q.dtype == torch.bfloat16 else torch.matmul
    if q.dtype != torch.bfloat16:
        Qg, dOg = Qg.float(), dOg.float()
    dk = torch.zeros((B, Hkv, Tk + padk, width), device=q.device)
    dv = torch.zeros_like(dk)
    for hh in range(g):
        for i0 in range(0, Tq + padq, TILE_K):
            rows = slice(i0, i0 + TILE_K)
            pt = P[:, :, hh, rows].transpose(-1, -2).contiguous()
            dst = DS[:, :, hh, rows].transpose(-1, -2).contiguous()
            dv = dv + mm(pt, dOg[:, :, hh, rows])
            dk = dk + mm(dst, Qg[:, :, hh, rows])
    return (dq[..., :D].to(q.dtype).contiguous(),
            dk[:, :, :Tk, :D].to(k.dtype).contiguous(),
            dv[:, :, :Tk, :D].to(v.dtype).contiguous())


def _key_tiles(q, k, v, causal: bool):
    """k and v zero-padded to whole 64-key tiles and repeated over each
    kv head's query heads, and each tile's (first key, Tq x 64 mask of the
    keys a row may see)."""
    B, Hq, Hkv, Tq, Tk, _ = _shapes(q, k, v)
    g = Hq // Hkv
    pad = (-Tk) % TILE_K
    kr = F.pad(k, (0, 0, 0, pad)).repeat_interleave(g, dim=1)
    vr = F.pad(v, (0, 0, 0, pad)).repeat_interleave(g, dim=1)
    dev = q.device
    qpos = torch.arange(Tq, device=dev)[:, None] + (Tk - Tq)
    tiles = []
    for k0 in range(0, Tk + pad, TILE_K):
        key = k0 + torch.arange(TILE_K, device=dev)[None, :]
        valid = key < Tk
        if causal:
            valid = valid & (key <= qpos)
        tiles.append((k0, valid))
    return kr, vr, tiles


def _bwd_f32(q, k, v, dout, delta, causal: bool, scale: float):
    """The scalar kernel's dQ pass on rows padded to the tile width: (dQ,
    P, dS), P and dS (B, Hq, Tq, Tk padded) float32."""
    qf, dof = q.float(), dout.float()
    kr, vr, tiles = _key_tiles(qf, k.float(), v.float(), causal)
    m, l = _stats_f32(qf, kr, causal, scale, k.shape[2])
    dq = torch.zeros_like(qf)
    p_tiles, ds_tiles = [], []
    for k0, valid in tiles:
        kt = kr[:, :, k0:k0 + TILE_K]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        p = torch.where(valid & (l > 0), torch.exp(s - m) / l,
                        torch.zeros_like(s))
        dp = torch.matmul(dof, vr[:, :, k0:k0 + TILE_K].transpose(-1, -2))
        ds = (p * (dp - delta)) * scale
        dq = dq + torch.matmul(ds, kt)
        p_tiles.append(p)
        ds_tiles.append(ds)
    return dq, torch.cat(p_tiles, -1), torch.cat(ds_tiles, -1)


def _bwd_bf16(q, k, v, dout, delta, causal: bool, scale: float):
    """The tensor-core kernels' dQ pass on rows padded to the tile width:
    m and l from B6's bf16 loop (`_online_bf16`), then per key tile S and
    dP as bf16 GEMMs into float32, P = exp2(S c - m) (1 / l) (0 where
    masked or l = 0), dS = P (dP - Delta) scale rounded to bf16 and dQ +=
    dS K; returns (dQ float32, P and dS (B, Hq, Tq, Tk padded) bf16)."""
    _, m, l = _online_bf16(q, k, None, causal, scale)
    rl = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    c = _log2_factor(scale)
    kr, vr, tiles = _key_tiles(q, k, v, causal)
    dq = torch.zeros(q.shape, device=q.device)
    p_tiles, ds_tiles = [], []
    for k0, valid in tiles:
        kt = kr[:, :, k0:k0 + TILE_K]
        s = (_mm_f32(q, kt.transpose(-1, -2)) * c).masked_fill(~valid,
                                                                -math.inf)
        p = torch.exp2(s - m) * rl
        dp = _mm_f32(dout, vr[:, :, k0:k0 + TILE_K].transpose(-1, -2))
        ds = ((p * (dp - delta)) * scale).to(torch.bfloat16)
        dq = dq + _mm_f32(ds, kt)
        p_tiles.append(p.to(torch.bfloat16))
        ds_tiles.append(ds)
    return dq, torch.cat(p_tiles, -1), torch.cat(ds_tiles, -1)


def flash_attention_bwd_kernel_call(q, k, v, out, dout, *, causal: bool = True,
                                    scale: float | None = None):
    """Launch B6b on CUDA tensors: (dq, dk, dv) in q's type.

    q, k, v, out and dout are contiguous, of one type (float32 or
    bfloat16), with an even head size D from 2 to `MAX_HEAD_DIM`; bfloat16
    q, k, v and dout start on 16-byte boundaries (TMA reads them); anything
    else raises; a bfloat16 D that is not a multiple of 8 runs on copies
    zero-padded to the next one. Allocates the gradients and a float32
    scratch of the per-row statistics (3, B, Hq, Tq rounded up to 64),
    launches on the current stream (a dQ kernel, then a dK/dV kernel) and
    does not synchronise."""
    B, Hq, Hkv, Tq, Tk, D = _shapes(q, k, v)
    check_head_dim(D)
    if q.dtype == torch.bfloat16 and D % 8:
        width = D + 8 - D % 8
        grads = flash_attention_bwd_kernel_call(
            *(pad_head(t, width) for t in (q, k, v, out, dout)),
            causal=causal, scale=scale if scale is not None else D ** -0.5)
        return tuple(g[..., :D].contiguous() for g in grads)
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes float32 or bfloat16")
    dev = q.device
    check_tensor("q", q, q.dtype, (B, Hq, Tq, D), dev)
    check_tensor("k", k, q.dtype, (B, Hkv, Tk, D), dev)
    check_tensor("v", v, q.dtype, (B, Hkv, Tk, D), dev)
    check_tensor("out", out, q.dtype, (B, Hq, Tq, D), dev)
    check_tensor("dout", dout, q.dtype, (B, Hq, Tq, D), dev)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v, dout)):
        raise ValueError("the bf16 kernels load q, k, v and dout by TMA: "
                         "each must start on a 16-byte boundary")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty((3, B, Hq, -(-Tq // TILE_K) * TILE_K),
                        dtype=torch.float32, device=dev)
    scale = scale if scale is not None else D ** -0.5
    launch("flash_attention_bwd_launch", dev,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           stats.data_ptr(), B, Hq, Hkv, Tq, Tk, D, int(causal),
           int(q.dtype == torch.bfloat16), float(scale))
    flash_attention_bwd_kernel_call.launches += 1
    return dq, dk, dv


flash_attention_bwd_kernel_call.launches = 0


class FlashAttention(torch.autograd.Function):
    """B6 with its gradient: the forward is B6 (or its plain version), the
    backward B6b (or its plain version); ``plain`` picks the plain pair,
    which a CPU tensor always takes. Saves q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale, plain: bool):
        fwd = flash_attention_plain if plain else flash_attention_kernel_call
        out = fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.scale, ctx.plain = causal, scale, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        bwd = (flash_attention_bwd_plain if ctx.plain
               else flash_attention_bwd_kernel_call)
        dq, dk, dv = bwd(q, k, v, out, dout.contiguous(), causal=ctx.causal,
                         scale=ctx.scale)
        return dq, dk, dv, None, None, None

