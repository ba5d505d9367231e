"""Measurement backends: the profiler's fidelity spectrum, made pluggable.

Port of `repro.traffic.backends`, over the port's `TrafficProfiler`.

The paper's Profiler "measures, not models" — but a measurement has a
price, and the price spans three orders of magnitude (DESIGN.md §10.1):

  modeled           analytic op-DAG drain rate (~µs per config): the
                    deterministic cost model used for ground-truth
                    enumeration and as the *cheap* fidelity;
  replayed          zero-loss throughput measured by offered-load replay
                    through a single `StreamingRuntime` worker
                    (bracket + bisection, seconds per config);
  replayed_sharded  the same measurement against an RSS-steered
                    `ShardedRuntime` under the profiler's `scenario` —
                    the serving fleet the config would actually deploy
                    to, and the *measured* fidelity the optimizer's
                    reported front comes from.

Every backend is a view over ONE `TrafficProfiler` instance, so all
fidelities share its feature-matrix cache, trained-model cache
(`perf_f1` — one seeded training per config, reused by every fidelity
and later by `serve.deploy`), service-model calibration cache (replayed
and replayed_sharded share clock constants per config), and memoized
`ProfileResult`s. `backend_suite` returns them cheap-first, which is
exactly the ordering `repro_torch.core.MemoizedEvaluator` expects.

Each backend satisfies `repro_torch.core.MeasurementBackend` (a ``name`` plus
``__call__(x) -> ProfileResult``); anything else with that shape can be
slotted into the suite — e.g. a live-NIC measurement harness.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from .profiler import ProfileResult, TrafficProfiler

__all__ = ["FIDELITY_METRICS", "FIDELITY_ORDER", "ProfilerBackend",
           "backend_suite"]

# fidelity name -> profiler cost metric, cheap -> expensive. All three
# negate throughput for minimization, so objectives are commensurable
# across fidelities (the multi-fidelity surrogate pools them).
FIDELITY_METRICS = {
    "modeled": "throughput",
    "replayed": "throughput_replayed",
    "replayed_sharded": "throughput_replayed_sharded",
}
FIDELITY_ORDER = tuple(FIDELITY_METRICS)


@dataclasses.dataclass
class ProfilerBackend:
    """One fidelity of the measure step, bound to a shared profiler."""

    profiler: TrafficProfiler
    name: str
    metric: str

    def __call__(self, x) -> ProfileResult:
        return self.profiler(x, metric=self.metric)

    def __repr__(self) -> str:  # keep evaluator summaries readable
        return f"ProfilerBackend({self.name!r} -> {self.metric!r})"


def backend_suite(
    profiler: TrafficProfiler,
    fidelities: Iterable[str] = ("modeled", "replayed_sharded"),
) -> dict[str, ProfilerBackend]:
    """Ordered (cheap-first) fidelity -> backend mapping over `profiler`.

    The default pairing — analytic model as the cheap fidelity, sharded
    scenario replay as the measured one — is what `CatoOptimizer
    .run_multi_fidelity` consumes via `MemoizedEvaluator`. Shard count
    and traffic scenario come from the profiler's own configuration
    (`n_shards`, `scenario`), so the measured fidelity is the serving
    fleet the caller configured, not a backend-local guess.
    """
    names = list(fidelities)
    unknown = [f for f in names if f not in FIDELITY_METRICS]
    if unknown:
        raise ValueError(
            f"unknown fidelities {unknown}; pick from {FIDELITY_ORDER}")
    order = sorted(names, key=FIDELITY_ORDER.index)
    if order != names:
        raise ValueError(
            f"fidelities must be ordered cheap -> expensive {FIDELITY_ORDER}, "
            f"got {tuple(names)}")
    return {
        f: ProfilerBackend(profiler, f, FIDELITY_METRICS[f]) for f in names
    }
