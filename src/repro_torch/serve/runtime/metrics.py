"""Observability for the streaming runtime (DESIGN.md §6).

Port of `repro.serve.runtime.metrics`,
unchanged but for its imports (numpy only).

Everything the replay and the dispatcher want to report lives here:

- `LatencyHistogram` — log-bucketed enqueue→prediction flow latencies with
  *bounded* memory: bucket counts are exact and updated incrementally, raw
  samples are capped by reservoir sampling, and percentiles are exact while
  every sample is still retained, falling back to bucket interpolation
  (error bounded by the bucket width) once the reservoir saturates.
- `RuntimeMetrics`  — drop/evict/recycle counters, batch-occupancy stats
  and the compile-count probe the shape-bucketing tests assert against.

The counters are deliberately plain ints mutated by the flow table and the
dispatcher: the hot ingest path must not pay for abstraction.
"""
from __future__ import annotations

import dataclasses
import math
import re

import numpy as np

__all__ = ["LatencyHistogram", "RuntimeMetrics", "METRIC_NAMESPACE"]

# un-shard-prefixed tenant-scoped counter names ("tenant2.dispatch....");
# anchored so the fleet aggregate never double-counts the `shardN.tenantM.`
# per-shard copies the prefixed merge also carries
_TENANT_RE = re.compile(r"^tenant(\d+)\.(.+)$")


class LatencyHistogram:
    """Latency distribution with exact log-bucket counts + capped raw samples.

    A serving runtime records one sample per predicted flow, forever; keeping
    every raw float (as this class originally did) grows without bound and
    `RuntimeMetrics.merged` used to concatenate the leak across shards. The
    storage contract is now:

    - **bucket counts are exact**: `_counts` is updated incrementally on
      every record, so `rows()` and bucket-based percentiles never degrade;
    - **raw samples are a reservoir**: at most `max_samples` floats are kept
      (Algorithm R with a deterministic generator, so replays reproduce);
    - **percentiles** are exact (`np.percentile` over the raw samples) while
      the reservoir still holds *every* sample, and interpolate within the
      exact bucket counts afterwards — the absolute error is bounded by the
      width of the bucket containing the requested rank;
    - min/max/sum stay exact running scalars regardless of the cap.

    Past the cap the bucket-width bound is coarse (at the default 8
    buckets per decade a bucket spans ~33% relative width), so a
    `LatencySketch` (serve/obs/latency.py, DESIGN.md §14.1) can be
    attached: `attach_sketch` creates one fed by every `record_many`,
    `link_sketch` points at an externally fed one recording the same
    sample population (the per-worker `LatencyRecorder`'s total sketch).
    When the attached sketch has seen every sample this histogram has,
    `percentile` reads it instead of interpolating — relative error
    <= the sketch's ``alpha`` (1% by default) at any stream length.
    """

    def __init__(
        self,
        lo_s: float = 1e-6,
        hi_s: float = 1e3,
        per_decade: int = 8,
        max_samples: int = 8192,
        seed: int = 0,
    ):
        self.lo_s = lo_s
        self.hi_s = hi_s
        n_dec = math.log10(hi_s / lo_s)
        self.edges = np.logspace(
            math.log10(lo_s), math.log10(hi_s), int(round(n_dec * per_decade)) + 1
        )
        self.max_samples = max_samples
        self._counts = np.zeros(len(self.edges) + 1, np.int64)
        self._reservoir = np.empty(max_samples, np.float64)
        self._n_res = 0
        self._n = 0
        self._min = math.inf
        self._max = 0.0
        self._sum = 0.0
        self._rng = np.random.default_rng(seed)
        self._sketch = None        # bounded-relative-error percentile source
        self._sketch_fed = False   # True: record_many feeds it (owned)

    def attach_sketch(self, alpha: float = 0.01):
        """Create and own a `LatencySketch` fed by every subsequent
        `record_many`, upgrading post-cap percentiles from the
        bucket-width bound to relative error <= `alpha`. Attach before
        recording: the sketch only covers samples recorded after it."""
        from ..obs.latency import LatencySketch  # avoid cycle

        self._sketch = LatencySketch(alpha=alpha)
        self._sketch_fed = True
        return self._sketch

    def link_sketch(self, sketch) -> None:
        """Read percentiles from an *externally fed* sketch covering the
        same sample population (e.g. a `LatencyRecorder`'s total sketch,
        written at the same charge site). Never fed by `record_many` —
        that would double-count."""
        self._sketch = sketch
        self._sketch_fed = False

    def record_many(self, seconds: np.ndarray) -> None:
        x = np.asarray(seconds, dtype=np.float64).ravel()
        if x.size == 0:
            return
        if self._sketch_fed:
            self._sketch.record_many(x)
        idx = np.searchsorted(self.edges, x, side="right")
        self._counts += np.bincount(idx, minlength=len(self._counts))
        self._min = min(self._min, float(x.min()))
        self._max = max(self._max, float(x.max()))
        self._sum += float(x.sum())
        # reservoir: fill to capacity, then Algorithm R over the overflow
        k = self.max_samples
        fill = min(x.size, k - self._n_res)
        if fill > 0:
            self._reservoir[self._n_res : self._n_res + fill] = x[:fill]
            self._n_res += fill
        if fill < x.size:
            tail = x[fill:]
            # global index (1-based stream position) of each overflow sample
            pos = self._n + fill + 1 + np.arange(tail.size)
            j = self._rng.integers(0, pos)  # uniform in [0, pos)
            hit = j < k
            self._reservoir[j[hit]] = tail[hit]
        self._n += x.size

    def counts(self) -> np.ndarray:
        """Exact log-bucket counts (len(edges)+1: underflow ... overflow)."""
        return self._counts.copy()

    def rows(self) -> list[tuple[float, float, int]]:
        """Occupied buckets as (lo_s, hi_s, count) — the display view."""
        c = self._counts
        lo = np.concatenate([[0.0], self.edges])
        hi = np.concatenate([self.edges, [np.inf]])
        return [(float(lo[i]), float(hi[i]), int(c[i]))
                for i in np.nonzero(c)[0]]

    @property
    def n(self) -> int:
        """Total samples recorded (not the retained reservoir size)."""
        return self._n

    def percentile(self, q: float) -> float:
        """The q-th percentile (q in [0, 100]).

        Accuracy contract, in order of preference:

        1. **exact** while the reservoir still holds every sample
           (`np.percentile` over the raw floats);
        2. **sketch-backed** past the cap when an attached/linked sketch
           has seen the same population: relative error <= its `alpha`;
        3. **bucket interpolation** over the exact counts otherwise: the
           true rank statistic lies in the same bucket as the returned
           value, so the absolute error is bounded by that bucket's
           width — at `per_decade` log buckets, a relative width of
           ``10**(1/per_decade) - 1`` (~33% at the default 8/decade).
           Deterministic, but coarse: attach a sketch for tail reads.
        """
        if self._n == 0:
            return 0.0
        if self._n == self._n_res:
            # reservoir still holds every sample: exact
            return float(np.percentile(self._reservoir[: self._n_res], q))
        if self._sketch is not None and self._sketch.n == self._n:
            # sketch covers the same population: relative error <= alpha
            return self._sketch.percentile(q)
        # bucket interpolation over the exact counts: rank the q-th sample,
        # find its bucket, interpolate linearly inside it. The true value is
        # somewhere in the same bucket, so the error <= bucket width — a
        # *deterministic* bound, which is why the saturated reservoir is
        # deliberately not consulted here (reservoir quantiles are tighter
        # on average but only statistically; the reservoir stays maintained
        # for the exact-merge path and raw-sample diagnostics).
        rank = min(max(int(math.ceil(q / 100.0 * self._n)), 1), self._n)
        cum = np.cumsum(self._counts)
        b = int(np.searchsorted(cum, rank, side="left"))
        lo = self._min if b == 0 else float(self.edges[b - 1])
        hi = float(self.edges[b]) if b < len(self.edges) else self._max
        prev = 0 if b == 0 else int(cum[b - 1])
        frac = (rank - prev) / max(int(self._counts[b]), 1)
        val = lo + frac * (max(hi, lo) - lo)
        return float(min(max(val, self._min), self._max))

    def merge_from(self, other: "LatencyHistogram") -> None:
        """Fold another histogram in (aggregate views over shards).

        Counts/min/max/sum merge exactly. Reservoirs concatenate while the
        union still fits (keeping percentiles exact for small fleets) and
        are re-sampled proportionally to each side's true population
        otherwise — consistent with the per-histogram error contract.
        """
        if other._n == 0:
            return
        if self._sketch_fed and other._sketch is not None:
            # owned sketches fold too (linked ones merge via the registry's
            # sketch kind — merging here would double-count them)
            self._sketch.merge_from(other._sketch)
        self._counts += other._counts
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        self._sum += other._sum
        mine = self._reservoir[: self._n_res]
        theirs = other._reservoir[: other._n_res]
        n_total = self._n + other._n
        exact = (self._n == self._n_res and other._n == other._n_res
                 and n_total <= self.max_samples)
        if exact:
            self._reservoir[self._n_res : self._n_res + other._n_res] = theirs
            self._n_res += other._n_res
        else:
            pool = np.concatenate([mine, theirs])
            w = np.concatenate([
                np.full(len(mine), self._n / max(len(mine), 1)),
                np.full(len(theirs), other._n / max(len(theirs), 1)),
            ])
            k = min(self.max_samples, len(pool))
            pick = self._rng.choice(len(pool), size=k, replace=False,
                                    p=w / w.sum())
            self._reservoir[:k] = pool[pick]
            self._n_res = k
        self._n = n_total

    def summary(self) -> dict:
        return {
            "n": self.n,
            "p50_s": self.percentile(50),
            "p90_s": self.percentile(90),
            "p99_s": self.percentile(99),
            "max_s": self._max if self._n else 0.0,
        }


# canonical registry names for the counter fields below (DESIGN.md §11.1).
# Fields added later without an entry here still aggregate — they fall
# back to ``runtime.<field>`` — but the curated names are the public
# namespace dashboards and tests key on.
METRIC_NAMESPACE = {
    "pkts_total": "ingest.pkts_total",
    "pkts_accumulated": "ingest.pkts_accumulated",
    "pkts_tracked": "ingest.pkts_tracked",
    "drops_ring": "ingest.drops_ring",
    "drops_table": "flow_table.drops",
    "flows_seen": "flow_table.flows_seen",
    "flows_evicted_idle": "flow_table.evictions",
    "slots_recycled": "flow_table.slots_recycled",
    "flows_migrated_out": "flow_table.migrated_out",
    "flows_migrated_in": "flow_table.migrated_in",
    "batches": "dispatch.batches",
    "flushes_full": "dispatch.flushes_full",
    "flushes_timeout": "dispatch.flushes_timeout",
    "flushes_drain": "dispatch.flushes_drain",
    "flushes_migrate": "dispatch.flushes_migrate",
    "flushes_swap": "dispatch.flushes_swap",
    "flows_predicted": "dispatch.flows_predicted",
    "duplicate_predictions": "dispatch.duplicates",
    "reuse_hits": "cache.reuse_hits",
    "refreshes": "cache.refreshes",
    "forced_reinfer": "cache.forced_reinfer",
    # latency-component sketches (serve/obs/latency.py, DESIGN.md §14.1) —
    # not counter fields, but registered here so the namespace test covers
    # them and `LatencyRecorder` can't invent registry names ad hoc
    "latency_queue_wait": "latency.queue_wait",
    "latency_batch": "latency.batch",
    "latency_service": "latency.service",
    "latency_total": "latency.total",
    # SLO tracker projections (serve/obs/slo.py, DESIGN.md §14.2)
    "slo_samples": "slo.samples",
    "slo_violations": "slo.violations",
    "slo_breaches": "slo.breaches",
    "slo_attainment": "slo.attainment",
    "slo_breached": "slo.breached",
}


@dataclasses.dataclass
class RuntimeMetrics:
    """Shared counter block for one runtime instance / one replay run."""

    # ingest-side
    pkts_total: int = 0
    pkts_accumulated: int = 0      # packets that updated the dense payload
    pkts_tracked: int = 0          # connection-tracking-only packets (past depth)
    drops_ring: int = 0            # offered load exceeded ingest capacity
    drops_table: int = 0           # flow table full, new flow rejected
    # flow-table lifecycle
    flows_seen: int = 0
    flows_evicted_idle: int = 0    # evicted before reaching depth (late flush)
    slots_recycled: int = 0
    # control plane (DESIGN.md §9)
    flows_migrated_out: int = 0    # slots exported to another shard's table
    flows_migrated_in: int = 0     # slots imported from another shard's table
    # dispatch-side
    batches: int = 0
    flushes_full: int = 0          # flushed because depth-n batch filled
    flushes_timeout: int = 0       # flushed because oldest flow waited too long
    flushes_drain: int = 0         # flushed at end-of-stream drain
    flushes_migrate: int = 0       # quiesce flush ahead of a RETA migration
    flushes_swap: int = 0          # quiesce flush ahead of a pipeline hot-swap
    flows_predicted: int = 0
    duplicate_predictions: int = 0  # re-tenancy fragments, first wins
    # prediction reuse (DESIGN.md §12)
    reuse_hits: int = 0            # refresh checks that kept the cached pred
    refreshes: int = 0             # drift-triggered re-inferences
    forced_reinfer: int = 0        # threshold-0 re-inferences (parity mode)
    # multi-tenant serving (DESIGN.md §15): per-tenant prediction counts,
    # keyed by tenant index — empty for single-tenant pipelines
    tenant_predictions: dict = dataclasses.field(default_factory=dict)
    batch_occupancy: list = dataclasses.field(default_factory=list)
    shapes_seen: set = dataclasses.field(default_factory=set)
    latency: LatencyHistogram = dataclasses.field(default_factory=LatencyHistogram)
    # per-component latency sketches (DESIGN.md §14.1), minted by
    # `Observability.attach_worker` when latency recording is on; None
    # keeps the disabled path at one attr load per charged batch
    latency_components: object = None

    @property
    def drops(self) -> int:
        """All loss sources combined — the zero-loss criterion counts both."""
        return self.drops_ring + self.drops_table

    @classmethod
    def counter_fields(cls) -> list[str]:
        """Every plain-int counter field, by introspection — counters
        added later are picked up by the registry bridge automatically."""
        return [f.name for f in dataclasses.fields(cls)
                if f.type in (int, "int")]

    def enable_latency_components(self, recorder) -> None:
        """Install a per-component `LatencyRecorder` and point the total
        histogram at its total sketch, so `latency.percentile` keeps its
        bounded relative error past the reservoir cap."""
        self.latency_components = recorder
        self.latency.link_sketch(recorder.sketches["total"])

    def to_registry(self, prefix: str = "", registry=None):
        """Project this block into a `MetricsRegistry` namespace
        (DESIGN.md §11.1): counters under their `METRIC_NAMESPACE` names
        (``runtime.<field>`` fallback for unmapped ones), occupancy as
        samples, the shape set as a set, and the latency histogram
        attached live (snapshots copy; `MetricsRegistry.merge` folds via
        `merge_from` into a fresh block, never aliasing this one)."""
        from ..obs.registry import MetricsRegistry

        reg = registry if registry is not None else MetricsRegistry()
        for name in self.counter_fields():
            canon = METRIC_NAMESPACE.get(name, f"runtime.{name}")
            reg.set_counter(prefix + canon, getattr(self, name))
        for t_i, v in self.tenant_predictions.items():
            # tenant-prefixed like the shard prefix: the exporter renders
            # both as labels, so per-model series never collide (§15.4)
            reg.set_counter(
                f"{prefix}tenant{int(t_i)}.dispatch.flows_predicted", v)
        reg.extend_samples(prefix + "dispatch.batch_occupancy",
                           self.batch_occupancy)
        reg.union(prefix + "dispatch.shapes_seen", self.shapes_seen)
        reg.attach_hist(prefix + "dispatch.latency", self.latency)
        if self.latency_components is not None:
            self.latency_components.to_registry(registry=reg, prefix=prefix)
        return reg

    @classmethod
    def from_registry(cls, reg) -> "RuntimeMetrics":
        """Rebuild a metrics block from an (unprefixed) registry view —
        the inverse of `to_registry`, used by the fleet aggregate so the
        operator API keeps returning `RuntimeMetrics`. Adopts the
        registry's histogram object: `MetricsRegistry.merge` constructs
        fresh blocks, so the adopted histogram never aliases a shard's."""
        m = cls()
        for name in cls.counter_fields():
            canon = METRIC_NAMESPACE.get(name, f"runtime.{name}")
            setattr(m, name, reg.counter(canon))
        for k, v in reg._counters.items():
            t = _TENANT_RE.match(k)
            if t and t.group(2) == "dispatch.flows_predicted":
                idx = int(t.group(1))
                m.tenant_predictions[idx] = (
                    m.tenant_predictions.get(idx, 0) + v)
        m.batch_occupancy = list(
            reg._samples.get("dispatch.batch_occupancy", []))
        m.shapes_seen = set(reg._sets.get("dispatch.shapes_seen", set()))
        if "dispatch.latency" in reg._hists:
            m.latency = reg.hist("dispatch.latency")
        if METRIC_NAMESPACE["latency_total"] in reg._sketches:
            from ..obs.latency import LatencyRecorder  # avoid cycle

            m.enable_latency_components(LatencyRecorder.from_registry(reg))
        return m

    def compile_count(self) -> int:
        """Distinct dispatch shapes (the reference's bound on jit compiles)."""
        return len(self.shapes_seen)

    def occupancy_stats(self) -> dict:
        if not self.batch_occupancy:
            return {"mean": 0.0, "min": 0.0, "max": 0.0}
        occ = np.asarray(self.batch_occupancy)
        return {
            "mean": float(occ.mean()),
            "min": float(occ.min()),
            "max": float(occ.max()),
        }

    def summary(self) -> dict:
        return {
            "pkts_total": self.pkts_total,
            "pkts_accumulated": self.pkts_accumulated,
            "pkts_tracked": self.pkts_tracked,
            "drops": self.drops,
            "drops_ring": self.drops_ring,
            "drops_table": self.drops_table,
            "flows_seen": self.flows_seen,
            "flows_predicted": self.flows_predicted,
            "duplicate_predictions": self.duplicate_predictions,
            "flows_evicted_idle": self.flows_evicted_idle,
            "slots_recycled": self.slots_recycled,
            "flows_migrated_out": self.flows_migrated_out,
            "flows_migrated_in": self.flows_migrated_in,
            "batches": self.batches,
            "flushes_full": self.flushes_full,
            "flushes_timeout": self.flushes_timeout,
            "flushes_drain": self.flushes_drain,
            "flushes_migrate": self.flushes_migrate,
            "flushes_swap": self.flushes_swap,
            "reuse_hits": self.reuse_hits,
            "refreshes": self.refreshes,
            "forced_reinfer": self.forced_reinfer,
            **({"tenant_predictions": dict(self.tenant_predictions)}
               if self.tenant_predictions else {}),
            "compile_count": self.compile_count(),
            "batch_occupancy": self.occupancy_stats(),
            "latency": self.latency.summary(),
            **({"latency_components": self.latency_components.summary()}
               if self.latency_components is not None else {}),
        }
