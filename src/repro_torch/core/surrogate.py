"""Random-forest surrogate model for the CATO Optimizer.

The paper (§4) uses HyperMapper's random-forest surrogate, "shown to perform
well compared to more traditional Gaussian processes for highly discontinuous
and non-linear objective functions". One regression forest per objective;
per-tree predictions provide the posterior samples the acquisition function
integrates over (tree t of every objective's forest forms one joint sample,
a cheap quasi-posterior coupling).

The port's own copy of `repro.core.surrogate` (numpy only), so that the
port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .forest import DenseForest, forest_predict_per_tree, train_forest

__all__ = ["RFSurrogate"]


@dataclasses.dataclass
class RFSurrogate:
    n_trees: int = 32
    max_depth: int = 8
    min_samples_leaf: int = 2
    seed: int = 0
    _forests: list[DenseForest] = dataclasses.field(default_factory=list)

    def fit(self, X: np.ndarray, Y: np.ndarray) -> "RFSurrogate":
        """X: (n, d) encoded points; Y: (n, m) objective values (minimize)."""
        X = np.asarray(X, dtype=np.float32)
        Y = np.asarray(Y, dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        self._forests = []
        depth = int(min(self.max_depth, max(2, np.ceil(np.log2(max(2, X.shape[0]))))))
        for j in range(Y.shape[1]):
            f = train_forest(
                X,
                Y[:, j],
                n_trees=self.n_trees,
                max_depth=depth,
                min_samples_leaf=self.min_samples_leaf,
                classification=False,
                bootstrap=True,
                max_features=None,
                rng=rng,
            )
            self._forests.append(f)
        return self

    @staticmethod
    def with_fidelity(X: np.ndarray, levels: np.ndarray) -> np.ndarray:
        """Append a fidelity-level input column (0.0 = cheapest backend,
        1.0 = measured) so one forest pools observations across
        fidelities: low-fidelity points inform the posterior wherever the
        objectives agree, and the level input lets trees split the
        fidelities apart wherever they systematically disagree — cheap
        points inform but never *pollute* measured predictions.
        Candidates are scored with the column pinned to the target
        fidelity (see `CatoOptimizer._propose_batch`)."""
        X = np.asarray(X, dtype=np.float32)
        lv = np.asarray(levels, dtype=np.float32).reshape(len(X), 1)
        return np.concatenate([X, lv], axis=1)

    def posterior_samples(self, X: np.ndarray) -> np.ndarray:
        """(n_trees, n, m) joint posterior draws at X."""
        per_obj = [forest_predict_per_tree(f, X) for f in self._forests]  # m x (T, n)
        return np.stack(per_obj, axis=-1)

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        s = self.posterior_samples(X)
        return s.mean(axis=0), s.std(axis=0)
