"""CATO prior construction (paper §3.3, "Tailoring BO for Traffic Analysis").

Two prior families, both derived automatically (no user knowledge needed):

1. Feature priors — P(f in F | x in Pareto) = (1 - delta) * I(f)/I_max + delta/2,
   with damping coefficient delta (default 0.4, tuned in paper Fig. 9a).
2. Connection-depth prior — a linearly-decaying pmf over [1, N], implemented
   as the paper does with a Beta(alpha=1, beta=2) density discretized over
   the depth range: fewer packets are a priori cheaper.

``pi_value`` evaluates the joint prior density of an encoded representation;
the Optimizer injects it πBO-style by multiplying the acquisition with
``pi(x) ** (beta_pibo / (1 + t))`` so the prior's influence decays over
iterations t (Hvarfner et al., πBO).

The port's own copy of `repro.core.priors` (numpy only), so that the
port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .mutual_info import mi_scores
from .search_space import FeatureRep, SearchSpace

__all__ = ["CatoPriors", "build_priors"]


@dataclasses.dataclass
class CatoPriors:
    feature_probs: np.ndarray  # (F,) P(f in Pareto-optimal rep)
    depth_pmf: np.ndarray      # (N - min_depth + 1,) linear decay
    mi: np.ndarray             # raw MI scores (diagnostics / RFE-MI baselines)
    keep_mask: np.ndarray      # dimensionality-reduction mask (MI > 0)

    def pi_log(self, space: SearchSpace, x: FeatureRep) -> float:
        """log prior density of a representation under independent priors."""
        v = space.encode(x)
        m = v[: space.n_features] > 0.5
        p = np.clip(self.feature_probs, 1e-6, 1 - 1e-6)
        lp = float(np.sum(np.where(m, np.log(p), np.log1p(-p))))
        d_idx = int(x.depth - space.min_depth)
        d_idx = min(max(d_idx, 0), len(self.depth_pmf) - 1)
        lp += float(np.log(self.depth_pmf[d_idx] + 1e-12))
        return lp

    def pi_log_clipped(self, space, x, lo: float = -4.0) -> float:
        """Clipped log prior: keeps πBO's suppression of unlikely regions
        bounded so the acquisition can still overrule the prior once the
        surrogate sees real structure (prevents the prior from walling off
        the high-perf / high-depth corner entirely)."""
        return max(self.pi_log(space, x), lo)


def beta12_pmf(n: int) -> np.ndarray:
    """Discretized Beta(1, 2) over n cells: density 2(1-u) — linear decay."""
    # integrate 2(1-u) over each cell [i/n, (i+1)/n]
    edges = np.linspace(0.0, 1.0, n + 1)
    cdf = 2 * edges - edges ** 2  # Beta(1,2) CDF
    pmf = np.diff(cdf)
    return pmf / pmf.sum()


def build_priors(
    space: SearchSpace,
    X_feat: np.ndarray,
    y: np.ndarray,
    delta: float = 0.4,
    mi_bins: int = 16,
    seed: int = 0,
) -> CatoPriors:
    """Derive priors from the training data itself (paper: automatic).

    ``X_feat`` holds one column per candidate feature in ``space`` order,
    computed at the maximum connection depth (cheap, single pass).
    """
    mi = mi_scores(X_feat, y, n_bins=mi_bins, seed=seed)
    keep = mi > 0.0
    i_max = mi.max() if mi.max() > 0 else 1.0
    probs = (1.0 - delta) * (mi / i_max) + delta / 2.0
    # dropped features get ~zero prior (the dimensionality-reduction step)
    probs = np.where(keep, probs, 1e-3)
    n_depth = space.max_depth - space.min_depth + 1
    return CatoPriors(
        feature_probs=probs.astype(np.float64),
        depth_pmf=beta12_pmf(n_depth),
        mi=mi,
        keep_mask=keep,
    )
