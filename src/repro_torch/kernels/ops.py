"""Public entry points of the port's kernels that the reference exposes in
`repro.kernels.ops`.

Each picks its path from the device of its input: a CUDA tensor goes to the
hand-written kernel (which raises if it cannot launch), a CPU tensor to the
kernel's plain PyTorch version. There is no fallback between the two.
"""
from __future__ import annotations

import torch

from .tree_infer import forest_infer_kernel_call, forest_infer_plain

__all__ = ["forest_infer"]


def forest_infer(x, feature, threshold, leaf, depth: int, *,
                 block_t: int = 8) -> torch.Tensor:
    """Dense forest inference, (N, F) features -> (N, K) mean votes."""
    if x.is_cuda:
        return forest_infer_kernel_call(x, feature, threshold, leaf, depth,
                                        block_t=block_t)
    return forest_infer_plain(x, feature, threshold, leaf, depth,
                              block_t=block_t)
