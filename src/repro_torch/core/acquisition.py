"""Acquisition: Expected Hypervolume Improvement with πBO prior injection.

EHVI is estimated by Monte-Carlo over the RF surrogate's per-tree joint
posterior samples. The 2-objective hypervolume improvement of a single
candidate against a staircase front is exact and vectorized over candidates
(O(M * |front|) per posterior sample).

Prior injection follows πBO (Hvarfner et al., ICLR'22), which the paper
adapts to the multi-objective setting (§4): the acquisition is multiplied by
``pi(x) ** (beta / (1 + t))`` so prior influence decays with iteration t.

The port's own copy of `repro.core.acquisition` (numpy only), so that the
port never imports the JAX package.
"""
from __future__ import annotations

import numpy as np

from .pareto import pareto_mask

__all__ = ["hvi_contribution", "ehvi", "qehvi_greedy", "apply_pibo"]


def hvi_contribution(
    front: np.ndarray, pts: np.ndarray, ref: tuple[float, float] = (1.0, 1.0)
) -> np.ndarray:
    """Hypervolume gained by adding each of pts (M, 2) to `front` (K, 2).

    Minimization staircase; all values expected ~normalized (ref box (1,1)).
    """
    pts = np.asarray(pts, dtype=np.float64)
    rx, ry = float(ref[0]), float(ref[1])
    if front is None or len(front) == 0:
        w = np.maximum(0.0, rx - np.maximum(pts[:, 0], 0.0))
        h = np.maximum(0.0, ry - np.maximum(pts[:, 1], 0.0))
        # clip to ref box only from above; points beyond ref contribute 0
        w = np.where(pts[:, 0] >= rx, 0.0, rx - pts[:, 0])
        h = np.where(pts[:, 1] >= ry, 0.0, ry - pts[:, 1])
        return np.maximum(w, 0.0) * np.maximum(h, 0.0)

    F = np.asarray(front, dtype=np.float64)
    F = F[pareto_mask(F)]
    F = F[np.argsort(F[:, 0])]
    # intervals over x: [lo_j, r_j) with staircase height bound_j
    lo = np.concatenate([[-np.inf], F[:, 0]])           # (k+1,)
    r = np.concatenate([F[:, 0], [rx]])                 # (k+1,)
    bound = np.concatenate([[ry], F[:, 1]])             # (k+1,)

    a = pts[:, 0:1]  # (M,1)
    b = pts[:, 1:2]
    width = np.minimum(r[None, :], rx) - np.maximum(lo[None, :], a)
    height = np.minimum(bound[None, :], ry) - b
    area = np.maximum(width, 0.0) * np.maximum(height, 0.0)
    return area.sum(axis=1)


def ehvi(
    post_samples: np.ndarray,  # (T, M, 2) posterior draws (normalized objs)
    front: np.ndarray,         # (K, 2) current normalized front
    ref: tuple[float, float] = (1.0, 1.0),
) -> np.ndarray:
    """Monte-Carlo EHVI per candidate, (M,)."""
    T = post_samples.shape[0]
    acc = np.zeros(post_samples.shape[1], dtype=np.float64)
    for t in range(T):
        acc += hvi_contribution(front, post_samples[t], ref)
    return acc / T


def qehvi_greedy(
    post_samples: np.ndarray,  # (T, M, 2) posterior draws (normalized objs)
    front: np.ndarray,         # (K, 2) current normalized front
    q: int,
    *,
    ref: tuple[float, float] = (1.0, 1.0),
    log_prior: np.ndarray | None = None,
    iteration: int = 0,
    beta: float = 0.0,
) -> list[int]:
    """Greedy q-EHVI batch selection: candidate indices, best first.

    Joint q-EHVI is approximated by the standard sequential-greedy
    scheme: pick the EHVI argmax, *fantasize* the pick into every
    posterior sample's front (sample t contributes its own draw of the
    pick, preserving the joint coupling across objectives), rescore the
    remainder against the augmented fronts, repeat. Hypervolume
    improvement is submodular, so greedy keeps the (1 - 1/e)
    approximation guarantee. πBO prior weight (`log_prior`) is applied
    at every pick of the batch — the whole batch belongs to the same
    iteration `t` in the decay schedule.
    """
    T, M, _ = post_samples.shape
    base = np.asarray(front, dtype=np.float64).reshape(-1, 2)
    fronts = [base] * T
    chosen: list[int] = []
    avail = np.ones(M, dtype=bool)
    for _ in range(min(q, M)):
        acc = np.zeros(M, dtype=np.float64)
        for t in range(T):
            acc += hvi_contribution(fronts[t], post_samples[t], ref)
        acq = acc / T
        if log_prior is not None:
            acq = apply_pibo(acq, log_prior, iteration, beta)
        pick = int(np.argmax(np.where(avail, acq, -np.inf)))
        chosen.append(pick)
        avail[pick] = False
        fronts = [
            np.vstack([fronts[t], post_samples[t, pick][None, :]])
            for t in range(T)
        ]
    return chosen


def scalarized_ei(
    post_samples: np.ndarray,  # (T, M, 2) posterior draws (normalized objs)
    Y_obs: np.ndarray,         # (n, 2) normalized observations
    lam: float,
) -> np.ndarray:
    """ParEGO-style expected improvement under a random augmented-Chebyshev
    scalarization — spreads samples across the front (HyperMapper uses random
    scalarizations of the posterior for its multi-objective mode)."""
    w = np.array([lam, 1.0 - lam])

    def scal(Y):
        return np.max(Y * w, axis=-1) + 0.05 * np.sum(Y * w, axis=-1)

    best = scal(Y_obs).min()
    s = scal(post_samples)          # (T, M)
    return np.maximum(0.0, best - s).mean(axis=0)


def apply_pibo(
    acq: np.ndarray, log_prior: np.ndarray, iteration: int, beta: float = 10.0
) -> np.ndarray:
    """acq * pi(x)^(beta/(1+t)), computed stably in log space."""
    w = beta / (1.0 + iteration)
    lp = log_prior - log_prior.max()
    return (acq + 1e-12) * np.exp(w * lp)
