"""Oracles for the port's kernels, and the straddle rule for comparing
pipelines whose feature columns agree only to float32 rounding.

`forest_infer_ref` is the port of `repro.kernels.ref.forest_infer_ref`: the
plain mean over all trees, with no tree blocking.

`straddled_flows` says which flows may legitimately get different forest
outputs from two feature matrices that agree to rounding. The forest's
thresholds are quantile edges of training features, so a threshold can
equal a feature value exactly, and a column one ulp off then takes the
other branch. A flow is *straddled* when some tree's path, walked with
either matrix, meets a node whose two feature values differ and whose
threshold lies between them (inclusive). Every other flow must agree.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["forest_infer_ref", "straddled_flows"]


def forest_infer_ref(x, feature, threshold, leaf, depth: int) -> torch.Tensor:
    """Mean leaf payload over trees, (N, K). Matches forest_apply_np."""
    N, T = x.shape[0], feature.shape[0]
    rows = torch.arange(N, device=x.device)[:, None]
    trees = torch.arange(T, device=x.device)[None, :]
    feature = feature.long()
    node = torch.zeros((N, T), dtype=torch.long, device=x.device)
    for _ in range(depth):
        f = feature[trees, node]
        node = 2 * node + 1 + (x[rows, f] > threshold[trees, node]).long()
    return leaf[trees, node - (2 ** depth - 1)].mean(dim=1)


def straddled_flows(xa, xb, feature, threshold, depth: int) -> np.ndarray:
    """(N,) bool: flows whose path in some tree, under `xa` or `xb`, meets a
    node with ``xa[f] != xb[f]`` and ``min <= threshold <= max``.

    Arguments are numpy arrays (or anything `np.asarray` takes): two
    (N, F) feature matrices and the forest's (T, 2**depth - 1) tables.
    """
    xa = np.asarray(xa, np.float32)
    xb = np.asarray(xb, np.float32)
    feature = np.asarray(feature)
    threshold = np.asarray(threshold, np.float32)
    lo, hi = np.minimum(xa, xb), np.maximum(xa, xb)
    differs = xa != xb
    rows = np.arange(xa.shape[0])
    out = np.zeros(xa.shape[0], bool)
    for x in (xa, xb):
        for t in range(feature.shape[0]):
            node = np.zeros(xa.shape[0], np.int64)
            for _ in range(depth):
                f = feature[t, node]
                th = threshold[t, node]
                out |= (differs[rows, f] & (lo[rows, f] <= th)
                        & (th <= hi[rows, f]))
                node = 2 * node + 1 + (x[rows, f] > th)
    return out
