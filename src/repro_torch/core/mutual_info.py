"""Mutual information estimation (feature -> class label).

Used by CATO's dimensionality-reduction preprocessing ("exclude features with
a mutual information score of zero", paper §3.3) and to build the per-feature
priors P(f in F | x in Pareto). Continuous features are quantile-binned; MI is
computed from the joint histogram with a small-sample bias guard (permutation
baseline subtraction so that independent features score ~0).

The port's own copy of `repro.core.mutual_info` (numpy only), so that the
port never imports the JAX package.
"""
from __future__ import annotations

import numpy as np

__all__ = ["mutual_information", "mi_scores"]


def _binned(x: np.ndarray, n_bins: int) -> np.ndarray:
    qs = np.linspace(0, 100, n_bins + 1)[1:-1]
    edges = np.unique(np.percentile(x, qs))
    return np.searchsorted(edges, x, side="left")


def mutual_information(
    x: np.ndarray, y: np.ndarray, n_bins: int = 16, rng: np.random.Generator | None = None
) -> float:
    """MI(x; y) in nats; y integer labels; debiased by permutation baseline."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y)
    _, y = np.unique(y, return_inverse=True)
    xb = _binned(x, n_bins)

    def _mi(xb_):
        joint = np.zeros((xb_.max() + 1, y.max() + 1))
        np.add.at(joint, (xb_, y), 1.0)
        joint /= joint.sum()
        px = joint.sum(axis=1, keepdims=True)
        py = joint.sum(axis=0, keepdims=True)
        nz = joint > 0
        return float((joint[nz] * np.log(joint[nz] / (px @ py)[nz])).sum())

    mi = _mi(xb)
    rng = rng or np.random.default_rng(0)
    base = _mi(rng.permutation(xb))
    return max(0.0, mi - base)


def mi_scores(
    X: np.ndarray, y: np.ndarray, n_bins: int = 16, seed: int = 0
) -> np.ndarray:
    """Per-column MI scores for a feature matrix X (n, F)."""
    rng = np.random.default_rng(seed)
    return np.array(
        [mutual_information(X[:, j], y, n_bins, rng) for j in range(X.shape[1])]
    )
