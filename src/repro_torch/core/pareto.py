"""Pareto-front utilities and the Hypervolume Indicator (2-objective exact).

Convention: ALL objectives are *minimized*. CATO's two objectives are
``(cost(x), -perf(x))`` (paper §3.3). The paper reports HVI against a
worst-case reference point (F1 = 0, normalized cost = 1); we normalize both
objectives to [0, 1] and use ref = (1, 1), reporting the *ratio*
``HV(estimated) / HV(true)`` which matches the paper's 0–1 scale
(e.g. CATO 0.98 vs SIMANNEAL 0.88 in Fig. 6).

The port's own copy of `repro.core.pareto` (numpy only), so that the
port never imports the JAX package.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "pareto_mask",
    "pareto_front",
    "hypervolume_2d",
    "hvi_ratio",
    "knee_index",
    "normalize_objectives",
]


def pareto_mask(Y: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows of Y (n, m), minimization.

    A point is on the front iff no other point is <= it in every objective
    and < in at least one.
    """
    Y = np.asarray(Y, dtype=np.float64)
    n = Y.shape[0]
    mask = np.ones(n, dtype=bool)
    # O(n^2) vectorized — fine for the n <= few-thousand fronts here.
    for i in range(n):
        if not mask[i]:
            continue
        dominated = np.all(Y <= Y[i], axis=1) & np.any(Y < Y[i], axis=1)
        if dominated.any():
            mask[i] = False
            continue
        # points i dominates can be dropped from future consideration
        kills = np.all(Y[i] <= Y, axis=1) & np.any(Y[i] < Y, axis=1)
        mask &= ~kills
        mask[i] = True
    return mask


def pareto_front(Y: np.ndarray) -> np.ndarray:
    """Return the non-dominated subset of Y, sorted by first objective."""
    P = np.asarray(Y)[pareto_mask(Y)]
    return P[np.argsort(P[:, 0])]


def hypervolume_2d(front: np.ndarray, ref: tuple[float, float] = (1.0, 1.0)) -> float:
    """Exact 2-D hypervolume of a minimization front w.r.t. reference point.

    Points outside the reference box contribute their clipped projection.
    """
    front = np.asarray(front, dtype=np.float64)
    if front.size == 0:
        return 0.0
    front = front[pareto_mask(front)]
    front = front[np.argsort(front[:, 0])]
    rx, ry = float(ref[0]), float(ref[1])
    hv = 0.0
    prev_y = ry
    for x, y in front:
        x = min(x, rx)
        y = min(y, ry)
        if x >= rx or y >= prev_y:
            continue
        hv += (rx - x) * (prev_y - y)
        prev_y = y
    return hv


def knee_index(front: np.ndarray) -> int:
    """Index of the knee of a 2-objective minimization front.

    The knee is the point with the largest perpendicular distance below
    the chord between the front's extremes, after min-max normalization
    (so the pick is scale-invariant). It is the classic
    diminishing-returns operating point: past it, improving one
    objective costs disproportionately in the other — which makes it the
    default point `serve.deploy` pushes into a live runtime. Degenerate
    fronts (fewer than 3 points, or a zero-length chord) fall back to
    the middle point.
    """
    F = np.asarray(front, dtype=np.float64)
    if F.ndim != 2 or F.shape[1] != 2 or len(F) == 0:
        raise ValueError(f"front must be (k, 2), got {F.shape}")
    if len(F) < 3:
        return len(F) // 2
    Fn, _, _ = normalize_objectives(F)
    order = np.argsort(Fn[:, 0], kind="stable")
    Fs = Fn[order]
    a, b = Fs[0], Fs[-1]
    chord = b - a
    norm = float(np.hypot(*chord))
    if norm <= 0.0:
        return int(order[len(order) // 2])
    # signed cross product: positive = below the chord (toward the ideal)
    d = (chord[0] * (a[1] - Fs[:, 1]) - chord[1] * (a[0] - Fs[:, 0])) / norm
    return int(order[int(np.argmax(d))])


def normalize_objectives(
    Y: np.ndarray, lo: np.ndarray | None = None, hi: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Min-max normalize objective columns to [0, 1]; returns (Yn, lo, hi)."""
    Y = np.asarray(Y, dtype=np.float64)
    lo = Y.min(axis=0) if lo is None else np.asarray(lo, dtype=np.float64)
    hi = Y.max(axis=0) if hi is None else np.asarray(hi, dtype=np.float64)
    span = np.where(hi > lo, hi - lo, 1.0)
    return (Y - lo) / span, lo, hi


def hvi_ratio(
    est: np.ndarray,
    true: np.ndarray,
    ref: tuple[float, float] = (1.0, 1.0),
    lo: np.ndarray | None = None,
    hi: np.ndarray | None = None,
) -> float:
    """HV(est)/HV(true) after joint normalization by the TRUE front's range.

    This is the Fig. 6 / Fig. 7 metric: 1.0 means the estimated front matches
    the ground-truth front's dominated hypervolume.
    """
    true = np.asarray(true, dtype=np.float64)
    if lo is None or hi is None:
        _, lo, hi = normalize_objectives(true)
    tn, _, _ = normalize_objectives(true, lo, hi)
    en, _, _ = normalize_objectives(np.asarray(est, dtype=np.float64), lo, hi)
    denom = hypervolume_2d(tn, ref)
    if denom <= 0:
        return 0.0
    return float(hypervolume_2d(en, ref) / denom)
