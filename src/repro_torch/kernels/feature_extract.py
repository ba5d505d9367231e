"""Masked per-flow statistics: the CUDA kernel B5 and its plain version.

Port of `repro.kernels.feature_extract`. Over a dense ``(N, P)`` matrix of
packet values and its mask, each flow row reduces to five float32 numbers,
``count, sum, sum of squares, min, max`` of its valid packets, from which
mean, std and load follow; a row with no valid packet gives 0 for min and
max.

`flow_stats_kernel_call` launches ``csrc/flow_stats.cu``: each row's
packet axis cut into `split_plan(P)` parts, one warp a part, lane ``l``
over the groups of 4 packets at ``128 i + 4 l`` of its part (16-byte
loads where the row allows), the lanes merged in a ``__shfl_xor_sync``
butterfly, then the parts in order (see the source note).
`flow_stats_plain` computes the same function with torch ops in the same
order: the same parts, each lane's groups and their packets in order, the
lanes combined as the butterfly combines them, then the parts in order,
so on one and the same input the two are bitwise equal. Unlike the
reference, nothing is padded: the kernel masks the ragged row edge.
`repro_torch.kernels.ops.flow_stats` picks between them by the device of
`values`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_tensor, launch

__all__ = ["flow_stats_kernel_call", "flow_stats_plain", "mask_u8",
           "split_plan"]

_BIG = 3.4e38
LANES = 32       # a warp reduces one part of a row
GROUP = 4        # consecutive packets a lane takes at a time (kGroup)
SPAN = LANES * GROUP   # packets a warp takes a step (kSpan)
MAX_STEPS = 4    # steps a part aims at: one round of loads (kRound)
MAX_PARTS = 8    # warps of a block (kWarps)


def split_plan(P: int) -> tuple[int, int]:
    """(parts, part_len) of a row of P packets: the fewest parts (1, 2, 4
    or 8) that keep each at no more than MAX_STEPS steps of SPAN packets,
    each part a whole number of steps, ``parts * part_len >= P``. A
    function of P alone."""
    steps = max(1, -(-P // SPAN))
    parts = 1
    while parts < MAX_PARTS and parts * MAX_STEPS < steps:
        parts *= 2
    return parts, SPAN * -(-steps // parts)


def mask_u8(mask: torch.Tensor) -> torch.Tensor:
    """The mask as the contiguous uint8 tensor the kernel reads (non-zero
    = valid): a view of a contiguous bool mask, a copy of any other."""
    if mask.dtype == torch.bool and mask.is_contiguous():
        return mask.view(torch.uint8)
    if mask.dtype == torch.uint8:
        return mask.contiguous()
    return (mask != 0).to(torch.uint8).contiguous()


def _butterfly(x: torch.Tensor, op) -> torch.Tensor:
    """Combine lane values (last axis, 32) as the kernel's xor butterfly
    does (offsets 16, 8, 4, 2, 1): lane l's result is then lane 0's."""
    w = LANES
    while w > 1:
        w //= 2
        x = op(x[..., :w], x[..., w:2 * w])
    return x[..., 0]


def _in_part_order(x: torch.Tensor, op) -> torch.Tensor:
    """Combine (N, parts) values in part order, as the kernel's merge."""
    out = x[:, 0]
    for w in range(1, x.shape[1]):
        out = op(out, x[:, w])
    return out


def flow_stats_plain(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, 5) float32 = count, sum, sumsq, min, max over the valid packets,
    in the kernel's order of arithmetic. Runs on any device."""
    if values.ndim != 2 or tuple(mask.shape) != tuple(values.shape):
        raise ValueError(f"expected values and mask (N, P), got "
                         f"{tuple(values.shape)} and {tuple(mask.shape)}")
    N, P = values.shape
    parts, part_len = split_plan(P)
    steps = part_len // SPAN
    # packet p = w * part_len + i * 128 + 4 * l + e lands at [w, i, l, e]:
    # part w, step i, lane l, place e in the lane's group. Padded packets
    # are invalid, and adding their +0.0 leaves every running sum as it
    # was, as the kernel's skipping them does
    pad = (0, parts * part_len - P)
    shape = (N, parts, steps, LANES, GROUP)
    v = F.pad(values.to(torch.float32), pad).view(shape)
    m = F.pad(mask != 0, pad).view(shape)
    mf = m.to(torch.float32)
    cnt = torch.zeros((N, parts, LANES), dtype=torch.float32, device=v.device)
    s = torch.zeros_like(cnt)
    sq = torch.zeros_like(cnt)
    for i in range(steps):
        for e in range(GROUP):
            vj, mj = v[:, :, i, :, e], mf[:, :, i, :, e]
            cnt = cnt + mj
            s = s + vj * mj
            sq = sq + (vj * vj) * mj
    big = torch.tensor(_BIG, dtype=torch.float32, device=v.device)
    mn = torch.where(m, v, big).amin(dim=(2, 4))         # (N, parts, lanes)
    mx = torch.where(m, v, -big).amax(dim=(2, 4))
    cnt = _in_part_order(_butterfly(cnt, torch.add), torch.add)
    s = _in_part_order(_butterfly(s, torch.add), torch.add)
    sq = _in_part_order(_butterfly(sq, torch.add), torch.add)
    mn = _in_part_order(_butterfly(mn, torch.fmin), torch.fmin)
    mx = _in_part_order(_butterfly(mx, torch.fmax), torch.fmax)
    has = cnt > 0
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    mn = torch.where(has, mn, zero)
    mx = torch.where(has, mx, zero)
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
    parts, part_len = split_plan(P)
    launch("flow_stats_launch", dev, values.data_ptr(), m.data_ptr(),
           out.data_ptr(), N, P, parts, part_len)
    flow_stats_kernel_call.launches += 1
    return out


flow_stats_kernel_call.launches = 0
