"""RETA rebalancing planner + elastic headroom policy (DESIGN.md §9.2).

Port of `repro.serve.control.planner`, unchanged but for its imports (numpy
only).

Both planners are pure functions over telemetry: they propose indirection
rewrites, the runtime's migration protocol applies them (or skips a move
whose destination table cannot absorb the stranded flows). Keeping
planning side-effect-free makes every decision unit-testable and replay
deterministic.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["HeadroomPolicy", "plan_rebalance", "plan_retirement"]


def plan_rebalance(
    rates: np.ndarray,
    indirection: np.ndarray,
    active: list[bool],
    *,
    max_moves: int = 8,
    trigger: float = 1.05,
) -> dict[int, int]:
    """Greedy bucket-migration plan: move load from hot shards to cold.

    Classic longest-processing-time repair: while the hottest active
    shard exceeds `trigger` times the mean, move its largest bucket that
    still fits under half the hot/cold gap (so the move cannot overshoot
    and invert the imbalance); if every owned bucket is larger, fall back
    to the smallest one when it still strictly improves. Loads update
    locally after each planned move, so one step can plan several
    coordinated moves. Returns {bucket: destination shard}; empty when
    balanced.

    Buckets are the steering quantum: a single bucket hotter than the
    mean shard load is an unsplittable elephant herd — the planner parks
    it alone on the coldest shard, which is the best any RETA-granular
    steering can do.
    """
    rates = np.asarray(rates, np.float64)
    act = np.flatnonzero(np.asarray(active, bool))
    if act.size < 2 or rates.sum() <= 0:
        return {}
    n_shards = len(active)
    ind = np.array(indirection, np.int64, copy=True)
    loads = np.bincount(ind, weights=rates, minlength=n_shards)
    mean = loads[act].sum() / act.size
    moves: dict[int, int] = {}
    for _ in range(max_moves):
        h = int(act[np.argmax(loads[act])])
        c = int(act[np.argmin(loads[act])])
        gap = loads[h] - loads[c]
        if mean <= 0 or loads[h] / mean < trigger or gap <= 0:
            break
        owned = np.flatnonzero(ind == h)
        if owned.size == 0:
            break
        r = rates[owned]
        fit = r <= gap / 2.0
        if fit.any():
            b = int(owned[fit][np.argmax(r[fit])])
        else:
            b = int(owned[np.argmin(r)])
            if rates[b] >= gap:
                break  # any move would make things worse
        moves[b] = c
        loads[h] -= rates[b]
        loads[c] += rates[b]
        ind[b] = c
    return moves


def plan_retirement(
    rates: np.ndarray,
    indirection: np.ndarray,
    worker: int,
    active: list[bool],
) -> dict[int, int]:
    """Spread every bucket of a retiring worker over the remaining fleet.

    Greedy least-loaded placement, heaviest bucket first — the standard
    LPT heuristic, which keeps the post-retirement imbalance within a
    constant factor of optimal. Returns {bucket: destination shard}.
    """
    rates = np.asarray(rates, np.float64)
    targets = [i for i, a in enumerate(active) if a and i != worker]
    if not targets:
        raise ValueError("cannot retire the last active worker")
    ind = np.asarray(indirection, np.int64)
    n_shards = len(active)
    loads = np.bincount(ind, weights=rates, minlength=n_shards)
    owned = np.flatnonzero(ind == worker)
    moves: dict[int, int] = {}
    for b in owned[np.argsort(rates[owned])[::-1]]:
        t = targets[int(np.argmin(loads[targets]))]
        moves[int(b)] = t
        loads[t] += rates[b]
    return moves


@dataclasses.dataclass
class HeadroomPolicy:
    """Target-utilization worker sizing for elastic scale-out/in.

    `desired_workers` sizes the fleet so the offered load fits under
    `target_util` of aggregate worker capacity; `scale_in_util` adds
    hysteresis (only shrink when the smaller fleet would still sit below
    it), so the fleet does not flap at a utilization boundary.
    """

    target_util: float = 0.7
    scale_in_util: float = 0.5
    min_workers: int = 1
    max_workers: int = 8

    def desired_workers(
        self, offered_pps: float, per_worker_pps: float, current: int
    ) -> int:
        if per_worker_pps <= 0:
            return current
        need = math.ceil(offered_pps / (per_worker_pps * self.target_util))
        need = max(self.min_workers, min(self.max_workers, max(need, 1)))
        if need < current:
            # hysteresis: only shrink if the smaller fleet stays comfortable
            util_after = offered_pps / (need * per_worker_pps)
            if util_after > self.scale_in_util:
                need = current
        return need
