"""The CATO search space X = P(F) x N (paper §3.1, Table 1).

The port's own copy of `repro.core.search_space`.

A *feature representation* ``x = (F, n)`` is encoded as a flat vector of
``|F| + 1`` floats: binary indicator per candidate feature followed by the
connection depth (integer in [1, N]). This mirrors the paper's BO
formulation (§3.3): "one dimension per feature in F and one for the
connection depth n".
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = ["FeatureRep", "SearchSpace"]


@dataclasses.dataclass(frozen=True)
class FeatureRep:
    """x = (F, n): selected feature names + connection depth."""

    features: tuple[str, ...]
    depth: int

    def __post_init__(self):
        object.__setattr__(self, "features", tuple(sorted(self.features)))

    def key(self) -> tuple:
        return (self.features, self.depth)


@dataclasses.dataclass
class SearchSpace:
    """Encodes/decodes feature representations and samples them."""

    feature_names: tuple[str, ...]
    max_depth: int  # N — upper bound on connection depth
    min_depth: int = 1

    def __post_init__(self):
        self.feature_names = tuple(self.feature_names)

    @property
    def n_features(self) -> int:
        return len(self.feature_names)

    @property
    def dim(self) -> int:
        return self.n_features + 1

    @property
    def size(self) -> float:
        return float(2 ** self.n_features) * (self.max_depth - self.min_depth + 1)

    # -- encoding ------------------------------------------------------------
    def encode(self, x: FeatureRep) -> np.ndarray:
        v = np.zeros(self.dim, dtype=np.float32)
        name_to_idx = {n: i for i, n in enumerate(self.feature_names)}
        for f in x.features:
            v[name_to_idx[f]] = 1.0
        v[-1] = float(x.depth)
        return v

    def decode(self, v: np.ndarray) -> FeatureRep:
        mask = np.asarray(v[: self.n_features]) > 0.5
        depth = int(np.clip(round(float(v[-1])), self.min_depth, self.max_depth))
        feats = tuple(n for n, m in zip(self.feature_names, mask) if m)
        return FeatureRep(features=feats, depth=depth)

    def encode_batch(self, xs: Sequence[FeatureRep]) -> np.ndarray:
        return np.stack([self.encode(x) for x in xs])

    # -- sampling ------------------------------------------------------------
    def sample_uniform(self, rng: np.random.Generator, n: int) -> list[FeatureRep]:
        out = []
        for _ in range(n):
            mask = rng.random(self.n_features) < 0.5
            if not mask.any():
                mask[rng.integers(self.n_features)] = True
            depth = int(rng.integers(self.min_depth, self.max_depth + 1))
            out.append(
                FeatureRep(
                    tuple(np.array(self.feature_names)[mask].tolist()), depth
                )
            )
        return out

    def sample_from_priors(
        self,
        rng: np.random.Generator,
        n: int,
        feature_probs: np.ndarray,
        depth_pmf: np.ndarray,
    ) -> list[FeatureRep]:
        """Sample reps with per-feature Bernoulli priors + depth pmf."""
        depths = self.min_depth + rng.choice(
            len(depth_pmf), size=n, p=depth_pmf / depth_pmf.sum()
        )
        out = []
        for i in range(n):
            mask = rng.random(self.n_features) < feature_probs
            if not mask.any():
                mask[int(np.argmax(feature_probs))] = True
            out.append(
                FeatureRep(
                    tuple(np.array(self.feature_names)[mask].tolist()),
                    int(depths[i]),
                )
            )
        return out

    def mutate(
        self, rng: np.random.Generator, x: FeatureRep, depth_step: int | None = None
    ) -> FeatureRep:
        """Neighbor move: flip one feature OR perturb depth (equal prob.)."""
        names = list(self.feature_names)
        feats = set(x.features)
        if rng.random() < 0.5 or self.max_depth == self.min_depth:
            f = names[rng.integers(len(names))]
            if f in feats and len(feats) > 1:
                feats.remove(f)
            else:
                feats.add(f)
            return FeatureRep(tuple(feats), x.depth)
        step = depth_step or max(1, (self.max_depth - self.min_depth) // 4)
        d = int(
            np.clip(
                x.depth + rng.integers(-step, step + 1),
                self.min_depth,
                self.max_depth,
            )
        )
        return FeatureRep(tuple(feats), d)

    def enumerate_all(self) -> Iterable[FeatureRep]:
        """Exhaustive iteration — only for ground-truth spaces (paper Fig. 6)."""
        F = self.n_features
        for bits in range(1, 2 ** F):
            feats = tuple(
                self.feature_names[i] for i in range(F) if bits & (1 << i)
            )
            for d in range(self.min_depth, self.max_depth + 1):
                yield FeatureRep(feats, d)
