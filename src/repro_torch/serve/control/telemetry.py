"""Per-RETA-bucket load telemetry (DESIGN.md §9.1).

Port of `repro.serve.control.telemetry`, unchanged but for its imports
(numpy only).

The rebalancing planner reasons at the steering granularity it can act
on: indirection-table buckets, not flows. `BucketTelemetry` keeps one
counter per bucket, windowed per control interval, and folds windows
into an EWMA so the planner sees sustained load rather than one block's
burst. Counters are plain `np.bincount` adds on arrays the ingest path
already materializes — telemetry costs one vector op per block.
"""
from __future__ import annotations

import numpy as np

from ..runtime.shard import INDIRECTION_SIZE

__all__ = ["BucketTelemetry"]


class BucketTelemetry:
    """EWMA of per-bucket packet counts, rolled once per control interval.

    `note` accumulates the current window; `roll` folds it into the EWMA
    and resets. Units are packets per interval — the planner only needs
    *relative* bucket weights, so no division by wall time happens here
    (which also makes the signal invariant under replay clock
    compression: the same trace rebalances the same way at every offered
    rate, keeping zero-loss bisection probes comparable).
    """

    def __init__(self, n_buckets: int = INDIRECTION_SIZE, alpha: float = 0.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.n_buckets = n_buckets
        self.alpha = alpha
        self.window = np.zeros(n_buckets, np.int64)
        self.ewma = np.zeros(n_buckets, np.float64)
        self.rolls = 0
        self.total_pkts = 0
        # published control signals (DESIGN.md §14.2): point-in-time
        # verdict values the plane pushes each step (SLO attainment/burn),
        # exported as gauges alongside the load statistics
        self.signals: dict[str, float] = {}

    def publish(self, name: str, value: float) -> None:
        """Publish one named control signal (latest value wins; the
        per-step history belongs to the exporter's JSONL series)."""
        self.signals[name] = float(value)

    def note(self, buckets: np.ndarray) -> None:
        """Account one ingest block's packets by bucket id."""
        self.window += np.bincount(
            np.asarray(buckets, np.int64), minlength=self.n_buckets
        )
        self.total_pkts += len(buckets)

    def roll(self) -> np.ndarray:
        """Fold the window into the EWMA; returns the updated rates.

        The first roll seeds the EWMA with the raw window (an empty prior
        would make every early plan chase a half-faded signal)."""
        w = self.window.astype(np.float64)
        if self.rolls == 0:
            self.ewma = w
        else:
            self.ewma = self.alpha * w + (1.0 - self.alpha) * self.ewma
        self.window[:] = 0
        self.rolls += 1
        return self.ewma

    def shard_loads(self, indirection: np.ndarray, n_shards: int) -> np.ndarray:
        """Project bucket EWMA onto shards under an indirection table."""
        return np.bincount(
            np.asarray(indirection, np.int64), weights=self.ewma,
            minlength=n_shards,
        )

    def to_registry(self, prefix: str = "control.telemetry.", registry=None):
        """Project the telemetry view into the unified metrics namespace
        (DESIGN.md §11.1): counters for rolls/packets, gauges for the
        EWMA balance statistics the planner acts on."""
        from ..obs.registry import MetricsRegistry

        reg = registry if registry is not None else MetricsRegistry()
        reg.set_counter(prefix + "total_pkts", self.total_pkts)
        reg.set_counter(prefix + "rolls", self.rolls)
        mean = float(self.ewma.mean())
        reg.set_gauge(prefix + "ewma_max", float(self.ewma.max()), reduce="max")
        reg.set_gauge(prefix + "ewma_mean", mean, reduce="mean")
        reg.set_gauge(
            prefix + "imbalance",
            float(self.ewma.max() / mean) if mean > 0 else 1.0,
            reduce="max",
        )
        for name, value in self.signals.items():
            reg.set_gauge(prefix + name, value, reduce="mean")
        return reg
