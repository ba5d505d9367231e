"""Shared memoized evaluation layer for every search algorithm.

CATO's cost claims are comparative — "CATO reaches a better front than
SIMANNEAL at the same measurement budget" — so every algorithm must pay
for measurements through *identical* code, and a configuration measured
once must cost nothing the second time, no matter which algorithm asks
(DESIGN.md §10.2). Historically `CatoOptimizer._evaluate` and
`baselines._evaluate` were parallel implementations of the same
profiler-result-to-`Observation` conversion; this module is the single
shared version, with two additions:

- **memoization** keyed on the canonical config key (`x.key()`), per
  fidelity: the underlying profiler runs at most once per distinct
  (config, fidelity) for the evaluator's lifetime, and repeat requests
  return the *same* cached result object bit-for-bit;
- **fidelity routing**: `profile` may be a single callable (the
  historical contract) or an ordered mapping of fidelity name ->
  backend callable, cheap first (see `repro_torch.traffic.backends` for the
  traffic suite). Per-fidelity call/hit/wall-clock accounting backs the
  multi-fidelity optimizer's budget and the tune-smoke CI gate.

Any object with a ``name`` and ``__call__(x) -> result`` works as a
backend (the `MeasurementBackend` protocol); results may be a
`ProfileResult`-shaped object (``.cost``/``.perf``/``.aux``), an
`Observation`, or a plain ``(cost, perf)`` tuple.

The port's own copy of `repro.core.evaluator` (numpy only), so that the
port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping, Protocol, runtime_checkable

from .optimizer import Observation

__all__ = ["MeasurementBackend", "MemoizedEvaluator"]


@runtime_checkable
class MeasurementBackend(Protocol):
    """One fidelity of the measure step: a named profiler callable."""

    name: str

    def __call__(self, x: Any) -> Any:
        ...


def canonical_key(x: Any):
    """The memoization key: `x.key()` when the config defines one."""
    return x.key() if hasattr(x, "key") else x


class MemoizedEvaluator:
    """Memoized `profile(x) -> Observation` shared across algorithms.

    `profile` is either one callable (single fidelity, named "") or an
    ordered mapping fidelity -> callable, **cheapest first** — the last
    entry is the expensive "measured" fidelity that default evaluations
    and budget accounting target.
    """

    def __init__(self, profile: Callable | Mapping[str, Callable]):
        if isinstance(profile, Mapping):
            self._backends = dict(profile)
            if not self._backends:
                raise ValueError("empty backend mapping")
        else:
            self._backends = {"": profile}
        self._cache: dict[tuple, Any] = {}
        self.n_calls = {f: 0 for f in self._backends}   # real measurements
        self.n_hits = {f: 0 for f in self._backends}    # memoized returns
        self.wall_s = {f: 0.0 for f in self._backends}  # measurement wall
        self.n_seeded = {f: 0 for f in self._backends}  # pre-loaded results

    # -- fidelity spectrum ---------------------------------------------------
    @property
    def fidelities(self) -> tuple[str, ...]:
        """Backend names, cheapest first."""
        return tuple(self._backends)

    @property
    def cheapest(self) -> str:
        return next(iter(self._backends))

    @property
    def measured(self) -> str:
        """The expensive fidelity: the last (rightmost) backend."""
        return next(reversed(self._backends))

    @property
    def multi_fidelity(self) -> bool:
        return len(self._backends) > 1

    # -- cache seeding (shadow-evaluation warm start) ------------------------
    def seed(self, x: Any, result: Any, fidelity: str | None = None) -> bool:
        """Pre-load the memo cache with a known (config, fidelity) result.

        The self-optimizing fleet's shadow re-tune seeds its evaluator
        from the deployed bundle's observations so already-paid
        measurements are never re-bought inside an episode. Seeding never
        overwrites: a result this evaluator measured itself wins over an
        imported one. Returns True when the seed was installed."""
        fid = self.measured if fidelity is None else fidelity
        if fid not in self._backends:
            raise KeyError(
                f"unknown fidelity {fid!r}; evaluator has {self.fidelities}")
        key = (canonical_key(x), fid)
        if key in self._cache:
            return False
        self._cache[key] = result
        self.n_seeded[fid] += 1
        return True

    def seed_from(self, observations, fidelity: str | None = None) -> int:
        """Seed the cache from prior `Observation`s (or anything with
        ``.x``/``.cost``/``.perf``). Every observation lands at `fidelity`
        (default: the expensive backend) regardless of the fidelity tag it
        carries — the caller asserts the old measurements are still valid
        at that level. Returns the number of fresh seeds installed."""
        n = 0
        for o in observations:
            if self.seed(o.x, o, fidelity):
                n += 1
        return n

    # -- evaluation ----------------------------------------------------------
    def profile(self, x: Any, fidelity: str | None = None) -> tuple[Any, float]:
        """Memoized raw profiler call -> (result, measurement_seconds).

        Repeat requests for the same (canonical key, fidelity) return the
        cached result object itself — bit-identical across algorithms —
        with zero measurement time charged.
        """
        fid = self.measured if fidelity is None else fidelity
        if fid not in self._backends:
            raise KeyError(
                f"unknown fidelity {fid!r}; evaluator has {self.fidelities}")
        key = (canonical_key(x), fid)
        if key in self._cache:
            self.n_hits[fid] += 1
            return self._cache[key], 0.0
        t0 = time.perf_counter()
        res = self._backends[fid](x)
        dt = time.perf_counter() - t0
        self.n_calls[fid] += 1
        self.wall_s[fid] += dt
        self._cache[key] = res
        return res, dt

    def evaluate(
        self, x: Any, iteration: int = -1, fidelity: str | None = None
    ) -> Observation:
        """Profile `x` and normalize the result into an `Observation`."""
        fid = self.measured if fidelity is None else fidelity
        res, dt = self.profile(x, fid)
        if isinstance(res, Observation):
            obs = dataclasses.replace(res, x=x, aux=dict(res.aux))
        elif hasattr(res, "cost") and hasattr(res, "perf"):
            obs = Observation(
                x, float(res.cost), float(res.perf),
                aux=dict(getattr(res, "aux", {})),
            )
        else:
            cost, perf = res
            obs = Observation(x, float(cost), float(perf))
        obs.iteration = iteration
        obs.elapsed_s = dt
        obs.fidelity = fid
        return obs

    # -- accounting ----------------------------------------------------------
    def budget_summary(self) -> dict:
        """Per-fidelity unique-measurement counts and wall-clock."""
        return {
            f: {
                "measurements": self.n_calls[f],
                "memo_hits": self.n_hits[f],
                "seeded": self.n_seeded[f],
                "wall_s": round(self.wall_s[f], 4),
            }
            for f in self._backends
        }
