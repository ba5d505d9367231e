"""Random-forest inference: the CUDA kernel B1 and its plain version.

Port of `repro.kernels.tree_infer`. Trees live in the dense complete
level-order layout of `repro_torch.core.forest`, and traversal is index
arithmetic over the depth:

    node <- 2*node + 1 + (x[feat[node]] > thresh[node])

`forest_infer_kernel_call` launches ``csrc/forest_infer.cu`` (one warp
per flow: its lanes over the trees, then over the classes, see the source
note);
`forest_infer_plain` computes the same function with torch ops, in the
same order: per block of `block_t` trees, the block's votes summed in tree
order, divided by the padded tree count and added to the accumulator, then
the ``(T + rem) / T`` rescale. On one and the same `x` the two are bitwise
equal. `repro_torch.kernels.ops.forest_infer` picks between them by the
device of `x`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_tensor, launch

__all__ = ["pad_forest_blocks", "tree_blocking", "forest_infer_plain",
           "forest_infer_kernel_call", "MAX_CLASSES", "MAX_DEPTH"]

MAX_CLASSES = 64   # cato::kMaxClasses in csrc/forest_common.cuh
MAX_DEPTH = 24     # 2**depth node slots must index in int32


def pad_forest_blocks(feature, threshold, leaf, block_t: int):
    """Pad the tree axis to a `block_t` multiple with pass-through trees.

    Padding trees have +inf thresholds (every comparison goes left) and
    all-zero leaves, so they contribute nothing to the vote sum; callers
    divide by the padded count and rescale by ``(T + rem) / T`` afterwards.
    Returns ``(feature, threshold, leaf, rem_t)``.
    """
    T = feature.shape[0]
    rem_t = (-T) % block_t
    if rem_t:
        feature = F.pad(feature, (0, 0, 0, rem_t))
        threshold = F.pad(threshold, (0, 0, 0, rem_t), value=float("inf"))
        leaf = F.pad(leaf, (0, 0, 0, 0, 0, rem_t))
    return feature, threshold, leaf, rem_t


def tree_blocking(T: int, block_t: int) -> tuple[int, int, float]:
    """(bt, n_trees_padded, rescale) for T trees in blocks of `block_t`."""
    bt = min(block_t, T)
    rem_t = (-T) % bt
    return bt, T + rem_t, (T + rem_t) / T if rem_t else 1.0


def forest_infer_plain(x, feature, threshold, leaf, depth: int, *,
                       block_t: int = 8) -> torch.Tensor:
    """Mean leaf payload over trees, (N, K), in the kernel's block order.

    x (N, F) float32; feature (T, 2**depth - 1) int32; threshold the same
    shape, float32; leaf (T, 2**depth, K) float32. Runs on any device.
    """
    N = x.shape[0]
    T, K = feature.shape[0], leaf.shape[2]
    bt, tp, rescale = tree_blocking(T, block_t)
    feature, threshold, leaf, _ = pad_forest_blocks(feature, threshold, leaf, bt)
    rows = torch.arange(N, device=x.device)[:, None]
    trees = torch.arange(bt, device=x.device)[None, :]
    feature = feature.long()
    acc = torch.zeros((N, K), dtype=torch.float32, device=x.device)
    # a tensor, not a Python number: on CUDA torch divides by a number as a
    # multiply by its reciprocal, which rounds otherwise than the kernels'
    # division unless tp is a power of two
    n_pad = torch.tensor(float(tp), device=x.device)
    for j0 in range(0, tp, bt):
        fj, tj, lj = feature[j0:j0 + bt], threshold[j0:j0 + bt], leaf[j0:j0 + bt]
        node = torch.zeros((N, bt), dtype=torch.long, device=x.device)
        for _ in range(depth):
            f = fj[trees, node]
            node = 2 * node + 1 + (x[rows, f] > tj[trees, node]).long()
        votes = lj[trees, node - (2 ** depth - 1)]       # (N, bt, K)
        block = torch.zeros_like(acc)
        for t in range(bt):      # in tree order, as the kernel adds them
            block = block + votes[:, t]
        acc = acc + block / n_pad
    return acc * rescale


def forest_infer_kernel_call(x, feature, threshold, leaf, depth: int, *,
                             block_t: int = 8) -> torch.Tensor:
    """Launch the B1 CUDA kernel on CUDA tensors; returns (N, K) float32.

    Checks device, dtype, shape and contiguity and raises on anything the
    kernel does not take. Feature ids are not checked here (that would
    cost a device reduction per call): `repro_torch.convert.forest_tables`
    checks them once, when the tables are made. Each warp reads its
    flow's row of x from device memory. Launches on the current stream,
    reads nothing back and does not synchronise.
    """
    dev = x.device
    if x.ndim != 2 or feature.ndim != 2 or leaf.ndim != 3:
        raise ValueError("expected x (N, F), feature (T, NI), leaf (T, NL, K)")
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"forest depth {depth} outside [0, {MAX_DEPTH}]")
    N, nf = x.shape
    T, K = feature.shape[0], leaf.shape[2]
    if T < 1 or not 1 <= K <= MAX_CLASSES:
        raise ValueError(f"need >= 1 tree and 1..{MAX_CLASSES} classes, "
                         f"got T={T}, K={K}")
    ni = 2 ** depth - 1
    check_tensor("x", x, torch.float32, (N, nf), dev)
    check_tensor("feature", feature, torch.int32, (T, ni), dev)
    check_tensor("threshold", threshold, torch.float32, (T, ni), dev)
    check_tensor("leaf", leaf, torch.float32, (T, ni + 1, K), dev)
    out = torch.empty((N, K), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    bt, tp, rescale = tree_blocking(T, block_t)
    launch("forest_infer_launch", dev,
           x.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
           leaf.data_ptr(), out.data_ptr(),
           N, nf, T, depth, K, bt, tp, rescale)
    forest_infer_kernel_call.launches += 1
    return out


forest_infer_kernel_call.launches = 0
