"""Histogram-based decision trees and random forests (numpy training).

The port's own copy of `repro.core.forest`: the trainer, the numpy
inference oracle and the surrogate helpers (`train_tree`,
`forest_predict_value`, `forest_predict_per_tree`), seeded exactly as the
original so both packages grow identical forests from one seed. It backs
the traffic-analysis models (decision tree for app-class, random forest for
iot-class, as in the paper's §4) and the optimizer's regression surrogate.

There is no sklearn in this environment, so training is implemented here:
level-wise (breadth-first) greedy splitting on quantile-binned features,
vectorized with ``np.bincount`` over (node, feature, bin) keys — the
LightGBM-style histogram algorithm.

Trees are stored in a *dense complete level-order layout*: a tree of
``max_depth`` D is a perfect binary tree with ``2**D - 1`` internal slots and
``2**D`` leaf slots. Traversal is pure index arithmetic —
``node <- 2*node + 1 + (x[feat] > thresh)`` — with no pointer chasing, which
is exactly the representation the TPU Pallas kernel (`repro.kernels.tree_infer`)
consumes, and what the port's CUDA traversal kernel (`csrc/forest_infer.cu`)
walks. Unused internal slots are pass-through (feature 0, threshold +inf:
always branch left); unused leaves replicate their parent's prediction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "DenseForest",
    "train_forest",
    "train_tree",
    "forest_apply_np",
    "forest_predict_class",
    "forest_predict_value",
    "forest_predict_per_tree",
]


@dataclasses.dataclass
class DenseForest:
    """A forest in dense complete level-order layout.

    Attributes:
      feature:   (n_trees, 2**D - 1) int32   — split feature per internal node.
      threshold: (n_trees, 2**D - 1) float32 — split threshold (x <= t: left).
      leaf:      (n_trees, 2**D, n_out) float32 — leaf payload (class histogram
                 for classifiers, scalar mean for regressors with n_out == 1).
      depth:     D
      n_features: number of input features the trees were trained on.
      classes:   optional class labels (classification only).
    """

    feature: np.ndarray
    threshold: np.ndarray
    leaf: np.ndarray
    depth: int
    n_features: int
    classes: Optional[np.ndarray] = None

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def n_out(self) -> int:
        return self.leaf.shape[-1]

    def feature_importance(self) -> np.ndarray:
        """Split-count importance over features (cheap RFE driver)."""
        imp = np.zeros(self.n_features, dtype=np.float64)
        live = self.threshold < np.inf  # pass-through slots have +inf
        for t in range(self.n_trees):
            f = self.feature[t][live[t]]
            np.add.at(imp, f, 1.0)
        s = imp.sum()
        return imp / s if s > 0 else imp


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def _quantile_bins(X: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature bin edges from quantiles. Returns (n_feat, n_bins-1)."""
    qs = np.linspace(0, 100, n_bins + 1)[1:-1]
    edges = np.nanpercentile(X, qs, axis=0).T.astype(np.float32)  # (F, B-1)
    return edges


def _digitize(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bin each feature column by its edges. Returns uint8 (n, F)."""
    n, F = X.shape
    out = np.empty((n, F), dtype=np.uint8)
    for f in range(F):
        out[:, f] = np.searchsorted(edges[f], X[:, f], side="left")
    return out


# ---------------------------------------------------------------------------
# Level-wise tree growth
# ---------------------------------------------------------------------------

def _grow_tree(
    binned: np.ndarray,        # (n, F) uint8
    edges: np.ndarray,         # (F, B-1) float32 bin upper-edges
    y_onehot: np.ndarray,      # (n, K) float32 — one-hot labels or y[:, None]
    max_depth: int,
    min_samples_leaf: int,
    feature_subsample: Optional[np.ndarray],  # candidate feature ids or None
    rng: np.random.Generator,
    classification: bool,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Grow one tree level-wise; return dense (feature, threshold, leaf)."""
    n, F = binned.shape
    K = y_onehot.shape[1]
    B = int(edges.shape[1]) + 1
    n_internal = 2 ** max_depth - 1
    n_leaves = 2 ** max_depth

    feat_arr = np.zeros(n_internal, dtype=np.int32)
    thr_arr = np.full(n_internal, np.inf, dtype=np.float32)
    leaf_arr = np.zeros((n_leaves, K), dtype=np.float32)

    # node assignment of each sample within the current level, offset-free:
    # at level d, nodes are numbered 0..2**d-1 (local); global internal index
    # of local node j at level d is (2**d - 1) + j.
    node = np.zeros(n, dtype=np.int64)
    active = np.ones(n, dtype=bool)  # samples in nodes that may still split

    cand_feats = (
        np.arange(F, dtype=np.int64) if feature_subsample is None else feature_subsample
    )

    y_idx_full = y_onehot.argmax(axis=1) if classification else None

    # Track per-node "is frozen" (became leaf early); frozen samples keep
    # propagating left so their final leaf is deterministic.
    for d in range(max_depth):
        base = 2 ** d - 1
        idx = np.nonzero(active)[0]
        if idx.size == 0:
            break
        # compact node renumbering: only populated nodes get histogram slots
        uniq, nd = np.unique(node[idx], return_inverse=True)
        width = uniq.size
        # per (node, feature, bin, class) histogram via ONE fused bincount:
        # keys: (((nd * Fc + fi) * B + bin) * K + class)
        Fc = cand_feats.size
        sub_binned = binned[idx][:, cand_feats]  # (m, Fc)
        key_base = (nd[:, None] * Fc + np.arange(Fc)[None, :]) * B + sub_binned
        size = width * Fc * B
        if classification:
            y_idx = y_idx_full[idx]  # (m,)
            keys_k = key_base * K + y_idx[:, None]
            hist_y = np.bincount(keys_k.ravel(), minlength=size * K).astype(
                np.float64
            ).reshape(width, Fc, B, K)
            hist_cnt = hist_y.sum(axis=-1)
        else:
            hist_cnt = np.bincount(key_base.ravel(), minlength=size).astype(
                np.float64
            ).reshape(width, Fc, B)
            w = np.repeat(y_onehot[idx, 0], Fc)
            hist_y = np.bincount(
                key_base.ravel(), weights=w, minlength=size
            ).reshape(width, Fc, B)[..., None]

        # cumulative left stats over bins (split at bin b => left: bins <= b)
        cnt_l = np.cumsum(hist_cnt, axis=2)                     # (W, Fc, B)
        y_l = np.cumsum(hist_y, axis=2)                         # (W, Fc, B, K)
        cnt_tot = cnt_l[:, :, -1:]                              # (W, Fc, 1)
        y_tot = y_l[:, :, -1:, :]
        cnt_r = cnt_tot - cnt_l
        y_r = y_tot - y_l

        with np.errstate(divide="ignore", invalid="ignore"):
            if classification:
                # gini impurity decrease ∝ sum_k l_k^2 / n_l + r_k^2 / n_r
                score = np.where(cnt_l > 0, (y_l ** 2).sum(-1) / cnt_l, 0.0) + np.where(
                    cnt_r > 0, (y_r ** 2).sum(-1) / cnt_r, 0.0
                )
            else:
                # variance reduction ∝ s_l^2 / n_l + s_r^2 / n_r
                score = np.where(cnt_l > 0, y_l[..., 0] ** 2 / cnt_l, 0.0) + np.where(
                    cnt_r > 0, y_r[..., 0] ** 2 / cnt_r, 0.0
                )

        # forbid splits producing undersized children or at the last bin
        ok = (cnt_l >= min_samples_leaf) & (cnt_r >= min_samples_leaf)
        ok[:, :, -1] = False
        score = np.where(ok, score, -np.inf)

        flat = score.reshape(width, -1)
        best = np.argmax(flat, axis=1)                          # (W,)
        best_score = flat[np.arange(width), best]
        best_f_local = best // B
        best_bin = best % B

        # parent score (no-split baseline)
        node_cnt = cnt_tot[:, 0, 0]
        node_y = y_tot[:, 0, 0, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            if classification:
                parent = np.where(node_cnt > 0, (node_y ** 2).sum(-1) / node_cnt, 0.0)
            else:
                parent = np.where(node_cnt > 0, node_y[:, 0] ** 2 / node_cnt, 0.0)
        do_split = best_score > parent + 1e-12

        f_global = cand_feats[best_f_local]
        thr = edges[f_global, np.minimum(best_bin, B - 2)]
        # scatter compact results back to the level's dense slots
        feat_arr[base + uniq] = np.where(do_split, f_global, 0)
        thr_arr[base + uniq] = np.where(do_split, thr, np.inf)

        # route samples: x goes right iff bin > split_bin *and* node split
        nd_split = do_split[nd]
        go_right = nd_split & (
            binned[idx, f_global[nd]] > best_bin[nd]
        )
        node[idx] = uniq[nd] * 2 + go_right
        # samples in non-split nodes keep flowing left (pass-through)

    # leaves: final node at depth max_depth
    full = node  # every sample ends at depth == number of completed levels
    # If loop broke early, propagate remaining levels as pass-through (left).
    leaf_idx = full
    cnt = np.bincount(leaf_idx, minlength=n_leaves).astype(np.float64)
    for k in range(K):
        leaf_arr[:, k] = np.bincount(
            leaf_idx, weights=y_onehot[:, k], minlength=n_leaves
        )
    nz = cnt > 0
    leaf_arr[nz] /= cnt[nz, None]
    # empty leaves inherit nearest populated ancestor value via parent fill
    if (~nz).any():
        # fill upward: average over populated sibling or global mean
        global_mean = y_onehot.mean(axis=0)
        # walk each empty leaf up through its pass-through chain: since
        # pass-through routes left, an empty leaf's nearest populated
        # relative is its left-walk sibling subtree; fall back to global mean.
        fill = leaf_arr[nz].mean(axis=0) if nz.any() else global_mean
        leaf_arr[~nz] = fill
    return feat_arr, thr_arr, leaf_arr


def train_tree(
    X: np.ndarray,
    y: np.ndarray,
    *,
    max_depth: int = 8,
    min_samples_leaf: int = 1,
    n_bins: int = 32,
    classification: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> DenseForest:
    """Train a single decision tree (no bootstrap, all features)."""
    return train_forest(
        X,
        y,
        n_trees=1,
        max_depth=max_depth,
        min_samples_leaf=min_samples_leaf,
        n_bins=n_bins,
        classification=classification,
        bootstrap=False,
        max_features=None,
        rng=rng,
    )


def train_forest(
    X: np.ndarray,
    y: np.ndarray,
    *,
    n_trees: int = 100,
    max_depth: int = 8,
    min_samples_leaf: int = 1,
    n_bins: int = 32,
    classification: bool = True,
    bootstrap: bool = True,
    max_features: Optional[str | int] = "sqrt",
    rng: Optional[np.random.Generator] = None,
) -> DenseForest:
    """Train a random forest. X: (n, F) float; y: (n,) int labels or float."""
    rng = rng or np.random.default_rng(0)
    X = np.asarray(X, dtype=np.float32)
    n, F = X.shape
    if classification:
        classes, y_enc = np.unique(np.asarray(y), return_inverse=True)
        K = classes.size
        y_onehot = np.zeros((n, K), dtype=np.float32)
        y_onehot[np.arange(n), y_enc] = 1.0
    else:
        classes = None
        y_onehot = np.asarray(y, dtype=np.float64)[:, None]
        K = 1

    edges = _quantile_bins(X, n_bins)
    binned = _digitize(X, edges)

    if max_features is None:
        m_feat = F
    elif max_features == "sqrt":
        m_feat = max(1, int(np.sqrt(F)))
    else:
        m_feat = int(max_features)

    feats, thrs, leaves = [], [], []
    for t in range(n_trees):
        if bootstrap:
            sel = rng.integers(0, n, size=n)
        else:
            sel = np.arange(n)
        sub = rng.choice(F, size=m_feat, replace=False) if m_feat < F else None
        f, th, lf = _grow_tree(
            binned[sel],
            edges,
            y_onehot[sel],
            max_depth,
            min_samples_leaf,
            np.sort(sub) if sub is not None else None,
            rng,
            classification,
        )
        feats.append(f)
        thrs.append(th)
        leaves.append(lf)

    return DenseForest(
        feature=np.stack(feats).astype(np.int32),
        threshold=np.stack(thrs).astype(np.float32),
        leaf=np.stack(leaves).astype(np.float32),
        depth=max_depth,
        n_features=F,
        classes=classes,
    )


# ---------------------------------------------------------------------------
# Inference (numpy reference)
# ---------------------------------------------------------------------------

def forest_apply_np(forest: DenseForest, X: np.ndarray) -> np.ndarray:
    """Average leaf payload across trees. Returns (n, n_out)."""
    X = np.asarray(X, dtype=np.float32)
    n = X.shape[0]
    acc = np.zeros((n, forest.n_out), dtype=np.float64)
    for t in range(forest.n_trees):
        node = np.zeros(n, dtype=np.int64)
        for _ in range(forest.depth):
            f = forest.feature[t][node]
            th = forest.threshold[t][node]
            node = 2 * node + 1 + (X[np.arange(n), f] > th)
        leaf = node - (2 ** forest.depth - 1)
        acc += forest.leaf[t][leaf]
    return (acc / forest.n_trees).astype(np.float32)


def forest_predict_class(forest: DenseForest, X: np.ndarray) -> np.ndarray:
    probs = forest_apply_np(forest, X)
    idx = probs.argmax(axis=1)
    return forest.classes[idx] if forest.classes is not None else idx


def forest_predict_value(forest: DenseForest, X: np.ndarray) -> np.ndarray:
    return forest_apply_np(forest, X)[:, 0]


def forest_predict_per_tree(forest: DenseForest, X: np.ndarray) -> np.ndarray:
    """Per-tree regression predictions, (n_trees, n). Surrogate uncertainty."""
    X = np.asarray(X, dtype=np.float32)
    n = X.shape[0]
    out = np.empty((forest.n_trees, n), dtype=np.float32)
    for t in range(forest.n_trees):
        node = np.zeros(n, dtype=np.int64)
        for _ in range(forest.depth):
            f = forest.feature[t][node]
            th = forest.threshold[t][node]
            node = 2 * node + 1 + (X[np.arange(n), f] > th)
        leaf = node - (2 ** forest.depth - 1)
        out[t] = forest.leaf[t][leaf, 0]
    return out
