"""Masked per-flow statistics: the CUDA kernel B5 and its plain version.

Port of `repro.kernels.feature_extract`. Over a dense ``(N, P)`` matrix of
packet values and its mask, each flow row reduces to five float32 numbers,
``count, sum, sum of squares, min, max`` of its valid packets, from which
mean, std and load follow; a row with no valid packet gives 0 for min and
max.

`flow_stats_kernel_call` launches ``csrc/flow_stats.cu`` (one warp per
row, lane ``l`` over packets ``l, l+32, ...``, the lanes merged in a
``__shfl_xor_sync`` butterfly; see the source note). `flow_stats_plain`
computes the same function with torch ops in the same order: each lane's
column summed in stride order, then the lanes combined as the butterfly
combines them, so on one and the same input the two are bitwise equal.
Unlike the reference, nothing is padded: the kernel masks the ragged row
edge. `repro_torch.kernels.ops.flow_stats` picks between them by the
device of `values`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_tensor, launch

__all__ = ["flow_stats_kernel_call", "flow_stats_plain", "mask_u8"]

_BIG = 3.4e38
LANES = 32   # one warp per row in csrc/flow_stats.cu


def mask_u8(mask: torch.Tensor) -> torch.Tensor:
    """The mask as the contiguous uint8 tensor the kernel reads (non-zero
    = valid): a view of a contiguous bool mask, a copy of any other."""
    if mask.dtype == torch.bool and mask.is_contiguous():
        return mask.view(torch.uint8)
    if mask.dtype == torch.uint8:
        return mask.contiguous()
    return (mask != 0).to(torch.uint8).contiguous()


def _butterfly(x: torch.Tensor, op) -> torch.Tensor:
    """Combine (N, 32) lane values as the kernel's xor butterfly does
    (offsets 16, 8, 4, 2, 1): lane l's result is then lane 0's."""
    w = LANES
    while w > 1:
        w //= 2
        x = op(x[:, :w], x[:, w:2 * w])
    return x[:, 0]


def flow_stats_plain(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, 5) float32 = count, sum, sumsq, min, max over the valid packets,
    in the kernel's order of arithmetic. Runs on any device."""
    if values.ndim != 2 or tuple(mask.shape) != tuple(values.shape):
        raise ValueError(f"expected values and mask (N, P), got "
                         f"{tuple(values.shape)} and {tuple(mask.shape)}")
    N, P = values.shape
    v = values.to(torch.float32)
    m = mask != 0
    J = -(-P // LANES)
    # packet p = j*32 + l lands in column j of lane l; padded packets are
    # invalid, and adding their +0.0 leaves every running sum as it was
    v = F.pad(v, (0, J * LANES - P)).view(N, J, LANES)
    m = F.pad(m, (0, J * LANES - P)).view(N, J, LANES)
    mf = m.to(torch.float32)
    cnt = torch.zeros((N, LANES), dtype=torch.float32, device=v.device)
    s = torch.zeros_like(cnt)
    sq = torch.zeros_like(cnt)
    for j in range(J):
        vj, mj = v[:, j], mf[:, j]
        cnt = cnt + mj
        s = s + vj * mj
        sq = sq + (vj * vj) * mj
    big = torch.tensor(_BIG, dtype=torch.float32, device=v.device)
    mn = torch.where(m, v, big).amin(dim=1) if P else big.expand(N, LANES)
    mx = torch.where(m, v, -big).amax(dim=1) if P else (-big).expand(N, LANES)
    cnt = _butterfly(cnt, torch.add)
    s = _butterfly(s, torch.add)
    sq = _butterfly(sq, torch.add)
    has = cnt > 0
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    mn = torch.where(has, _butterfly(mn, torch.fmin), zero)
    mx = torch.where(has, _butterfly(mx, torch.fmax), zero)
    return torch.stack([cnt, s, sq, mn, mx], dim=1)


def flow_stats_kernel_call(values: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Launch the B5 CUDA kernel; returns (N, 5) float32 on the card.

    `values` is a contiguous (N, P) float32 CUDA tensor, `mask` a bool,
    uint8 or integer tensor of the same shape on the same device (made a
    contiguous uint8 tensor here). Raises on anything else. Launches on the
    current stream and does not synchronise."""
    dev = values.device
    if values.ndim != 2:
        raise ValueError(f"values: expected (N, P), got {tuple(values.shape)}")
    N, P = values.shape
    if mask.dtype.is_floating_point or mask.dtype.is_complex:
        raise TypeError(f"mask: dtype {mask.dtype}, expected bool or integer")
    check_tensor("values", values, torch.float32, (N, P), dev)
    if mask.device != dev or tuple(mask.shape) != (N, P):
        raise ValueError(f"mask: {tuple(mask.shape)} on {mask.device}, "
                         f"expected {(N, P)} on {dev}")
    m = mask_u8(mask)
    out = torch.empty((N, 5), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    launch("flow_stats_launch", dev, values.data_ptr(), m.data_ptr(),
           out.data_ptr(), N, P)
    flow_stats_kernel_call.launches += 1
    return out


flow_stats_kernel_call.launches = 0
