"""Baseline search strategies and point-solution feature selectors.

Pareto-front estimators compared in paper §5.3 (Fig. 6/7):
  - SIMANNEAL   multi-objective simulated annealing (Appendix E)
  - RANDSEARCH  uniform sampling without replacement
  - ITERATEALL  all features, packet depth incremented per iteration

Point-solution selectors compared in §5.2 (Fig. 5), each at a fixed depth:
  - ALL    use every candidate feature
  - RFEk   recursive feature elimination down to k features
  - MIk    top-k features by mutual information

The port's own copy of `repro.core.baselines` (numpy only), so that the
port never imports the JAX package: the same seed gives the same draws,
observations and selections as the reference.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .evaluator import MemoizedEvaluator
from .forest import train_forest
from .mutual_info import mi_scores
from .optimizer import CatoResult, Observation
from .search_space import FeatureRep, SearchSpace

__all__ = [
    "run_random_search",
    "run_iterate_all",
    "run_simulated_annealing",
    "select_all",
    "select_mi_topk",
    "select_rfe_topk",
]


def _shared_evaluator(profiler) -> MemoizedEvaluator:
    """Baselines evaluate through the same memoized layer as
    `CatoOptimizer` (pass an existing `MemoizedEvaluator` to share its
    per-fidelity cache across algorithms), so cost comparisons are
    measured through identical code — DESIGN.md §10.2."""
    if isinstance(profiler, MemoizedEvaluator):
        return profiler
    return MemoizedEvaluator(profiler)


def run_random_search(
    space: SearchSpace,
    profiler: Callable | MemoizedEvaluator,
    n_iterations: int,
    seed: int = 0,
    fidelity: str | None = None,
) -> CatoResult:
    ev = _shared_evaluator(profiler)
    rng = np.random.default_rng(seed)
    obs, seen = [], set()
    it = 0
    while len(obs) < n_iterations:
        x = space.sample_uniform(rng, 1)[0]
        if x.key() in seen:
            continue
        seen.add(x.key())
        obs.append(ev.evaluate(x, it, fidelity))
        it += 1
    return CatoResult(obs, space)


def run_iterate_all(
    space: SearchSpace,
    profiler: Callable | MemoizedEvaluator,
    n_iterations: int,
    fidelity: str | None = None,
) -> CatoResult:
    """All features; depth = 1, 2, 3, ... (paper §5.3)."""
    ev = _shared_evaluator(profiler)
    obs = []
    for it in range(n_iterations):
        d = space.min_depth + it
        if d > space.max_depth:
            break
        x = FeatureRep(space.feature_names, d)
        obs.append(ev.evaluate(x, it, fidelity))
    return CatoResult(obs, space)


def run_simulated_annealing(
    space: SearchSpace,
    profiler: Callable | MemoizedEvaluator,
    n_iterations: int,
    seed: int = 0,
    t0: float = 1.0,
    cooling: float = 0.99,
    fidelity: str | None = None,
) -> CatoResult:
    """Multi-objective SA per paper Appendix E.

    Neighbors perturb the feature set or the depth with equal probability;
    the depth step size decays linearly over the run. A dominating neighbor
    is always accepted; otherwise accept with prob exp((f(x)-f(x_i))/T_i)
    where f is the equal-weighted combination of normalized objectives.
    """
    ev = _shared_evaluator(profiler)
    rng = np.random.default_rng(seed)
    obs: list[Observation] = []

    cur = space.sample_uniform(rng, 1)[0]
    cur_obs = ev.evaluate(cur, 0, fidelity)
    obs.append(cur_obs)
    T = t0

    def scalar(o: Observation, lo, hi) -> float:
        span = np.where(hi > lo, hi - lo, 1.0)
        y = (np.array(o.objectives) - lo) / span
        return float(y.mean())

    for it in range(1, n_iterations):
        # linearly decaying max depth step (Appendix E)
        frac = 1.0 - it / max(1, n_iterations)
        step = max(1, int(frac * (space.max_depth - space.min_depth)))
        nb = space.mutate(rng, cur_obs.x, depth_step=step)
        nb_obs = ev.evaluate(nb, it, fidelity)
        obs.append(nb_obs)

        Y = np.array([o.objectives for o in obs])
        lo, hi = Y.min(0), Y.max(0)
        dominates = (
            nb_obs.cost <= cur_obs.cost and nb_obs.perf >= cur_obs.perf
            and (nb_obs.cost < cur_obs.cost or nb_obs.perf > cur_obs.perf)
        )
        if dominates:
            cur_obs = nb_obs
        else:
            p = np.exp(
                (scalar(cur_obs, lo, hi) - scalar(nb_obs, lo, hi)) / max(T, 1e-9)
            )
            if rng.random() < min(1.0, p):
                cur_obs = nb_obs
        T *= cooling
    return CatoResult(obs, space)


# ---------------------------------------------------------------------------
# Point-solution feature selectors (paper §5.2 baselines)
# ---------------------------------------------------------------------------

def select_all(space: SearchSpace, depth: int) -> FeatureRep:
    return FeatureRep(space.feature_names, depth)


def select_mi_topk(
    space: SearchSpace,
    depth: int,
    X_feat: np.ndarray,
    y: np.ndarray,
    k: int = 10,
    seed: int = 0,
) -> FeatureRep:
    """Top-k features by mutual information (columns of X_feat follow
    space.feature_names order, computed at `depth`)."""
    mi = mi_scores(X_feat, y, seed=seed)
    top = np.argsort(-mi)[:k]
    return FeatureRep(tuple(space.feature_names[i] for i in top), depth)


def select_rfe_topk(
    space: SearchSpace,
    depth: int,
    X_feat: np.ndarray,
    y: np.ndarray,
    k: int = 10,
    seed: int = 0,
    n_trees: int = 25,
    max_depth: int = 8,
) -> FeatureRep:
    """Recursive feature elimination with a forest importance ranking.

    Trains on all remaining features, removes the least important, repeats
    until k remain (Guyon et al. [26] wrapper).
    """
    rng = np.random.default_rng(seed)
    remaining = list(range(space.n_features))
    while len(remaining) > k:
        f = train_forest(
            X_feat[:, remaining],
            y,
            n_trees=n_trees,
            max_depth=max_depth,
            classification=True,
            rng=rng,
        )
        imp = f.feature_importance()
        drop = int(np.argmin(imp))
        remaining.pop(drop)
    return FeatureRep(tuple(space.feature_names[i] for i in remaining), depth)
