"""Model training for traffic-analysis pipelines (paper §4, Model Training).

The paper trains scikit-learn models with 5-fold nested CV + grid search and
then re-trains a matching Rust (SmartCore) model for serving. Neither library
is used here, so `repro_torch.core.forest` (the port's copy of the histogram
trainer) plays both roles: the trained `DenseForest` *is* the serving
artifact — its dense level-order layout is what the CUDA `forest_infer`
kernel executes.

Hyperparameter search is a validation-split grid over tree depth (the paper
greps depths 3–20; we use a compressed grid for tractability — recorded in
EXPERIMENTS.md §Adaptations).
"""
from __future__ import annotations

import numpy as np

from ..core.forest import DenseForest, forest_predict_class, train_forest

__all__ = ["macro_f1", "train_traffic_model", "MODEL_GRIDS"]


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Macro-averaged F1 over the classes present in y_true."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    classes = np.unique(y_true)
    f1s = []
    for c in classes:
        tp = float(np.sum((y_pred == c) & (y_true == c)))
        fp = float(np.sum((y_pred == c) & (y_true != c)))
        fn = float(np.sum((y_pred != c) & (y_true == c)))
        prec = tp / (tp + fp) if tp + fp > 0 else 0.0
        rec = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1s.append(2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0)
    return float(np.mean(f1s))


# (n_trees, depth grid, max_features) per model type
MODEL_GRIDS = {
    # random forest — iot-class (paper: 100 trees, depth 3..20)
    "rf": dict(n_trees=25, depths=(6, 10), max_features="sqrt"),
    # single decision tree — app-class
    "tree": dict(n_trees=1, depths=(6, 10), max_features=None),
    # fast variants for ground-truth exhaustive enumeration
    "rf-fast": dict(n_trees=12, depths=(8,), max_features="sqrt"),
    "tree-fast": dict(n_trees=1, depths=(8,), max_features=None),
}


def train_traffic_model(
    X_train: np.ndarray,
    y_train: np.ndarray,
    *,
    model: str = "rf",
    val_frac: float = 0.25,
    seed: int = 0,
) -> tuple[DenseForest, float]:
    """Train with a depth grid selected on an internal validation split.

    Returns (best forest retrained on all of X_train, validation F1).
    """
    grid = dict(MODEL_GRIDS[model])
    # feature subsampling only helps with enough columns to subsample
    if X_train.shape[1] <= 8:
        grid["max_features"] = None
    rng = np.random.default_rng(seed)
    n = X_train.shape[0]
    perm = rng.permutation(n)
    n_val = max(1, int(n * val_frac))
    vi, ti = perm[:n_val], perm[n_val:]

    best_depth, best_f1 = grid["depths"][0], -1.0
    if len(grid["depths"]) > 1:
        for depth in grid["depths"]:
            f = train_forest(
                X_train[ti], y_train[ti],
                n_trees=grid["n_trees"], max_depth=depth,
                max_features=grid["max_features"], classification=True,
                rng=np.random.default_rng(seed),
            )
            f1 = macro_f1(y_train[vi], forest_predict_class(f, X_train[vi]))
            if f1 > best_f1:
                best_depth, best_f1 = depth, f1

    final = train_forest(
        X_train, y_train,
        n_trees=grid["n_trees"], max_depth=best_depth,
        max_features=grid["max_features"], classification=True,
        rng=np.random.default_rng(seed + 1),
    )
    return final, best_f1
