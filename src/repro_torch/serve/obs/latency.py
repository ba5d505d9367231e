"""Mergeable bounded-relative-error latency sketches (DESIGN.md §14.1).

Port of `repro.serve.obs.latency`,
unchanged but for its imports (numpy only).

`LatencyHistogram` answers "what is the latency distribution" with exact
log-bucket counts, but its *percentiles* degrade once the raw-sample
reservoir saturates: the bucket-interpolation fallback is only bounded
by the bucket width (coarse: 8 buckets per decade), and the reservoir
itself is order-sensitive, so it can never cross a shard merge. This
module is the tail-latency-grade replacement:

- `LatencySketch` — a DDSketch-style log-bucketed quantile sketch with a
  *relative* accuracy guarantee: every reported percentile is within
  ``alpha`` (default 1%) of the exact rank statistic, at any stream
  length. Buckets are preallocated (one int64 vector, no per-record
  allocation), recording is one vectorized bincount, and merging is an
  integer bucket add — **order-independent and bit-identical under shard
  permutation**, the same merge law `MetricsRegistry` counters obey. The
  running sum is kept in integer nanoseconds so even the mean survives a
  permuted merge bit-for-bit.
- `LatencyRecorder` — one sketch per latency *component*: the
  enqueue→prediction total that `_WorkerClock.charge` always recorded,
  decomposed into queue-wait (ready→flush), batch-residency
  (flush→service start, the inference lane's backlog) and service time
  (the batch's own execution). The per-sample identity
  ``total = queue_wait + batch + service`` holds exactly, so a p99
  regression is attributable to a stage, not just observed.
- `LatencyConfig` — the attachment knob carried by `Observability`: one
  recorder is minted per worker, so per-shard sketches merge through the
  fleet registry like every other metric.

Sketch math: with ``gamma = (1 + alpha) / (1 - alpha)``, bucket ``i``
covers ``(lo_s * gamma**(i-1), lo_s * gamma**i]`` and reports the value
``2 * lo_s * gamma**i / (gamma + 1)`` — the point whose worst-case
relative distance to both bucket edges is exactly ``alpha``. Values at
or below ``lo_s`` land in an underflow bucket reported as the exact
running min; values above ``hi_s`` land in an overflow bucket reported
as the exact running max (the relative bound holds on ``(lo_s, hi_s]``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..runtime.metrics import METRIC_NAMESPACE

__all__ = [
    "COMPONENTS",
    "LatencyConfig",
    "LatencyRecorder",
    "LatencySketch",
]

# the decomposition of one flow's enqueue->prediction latency, in causal
# order; "total" is the sum of the other three per sample, by identity
COMPONENTS = ("queue_wait", "batch", "service", "total")


class LatencySketch:
    """DDSketch-style streaming quantile sketch with relative error
    <= `alpha` on ``(lo_s, hi_s]`` and order-independent merge.

    Storage is one preallocated int64 count per log bucket (underflow +
    ``ceil(log(hi/lo) / log(gamma))`` buckets + overflow; ~1.5k buckets
    at the defaults) plus five exact scalars; recording a block is one
    vectorized log + bincount. All merge state is integers and
    commutative scalar folds, so `merge_from` across shards is
    bit-identical under any permutation — asserted by tests.
    """

    def __init__(self, alpha: float = 0.01, lo_s: float = 1e-9,
                 hi_s: float = 1e4):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        if not 0.0 < lo_s < hi_s:
            raise ValueError(f"need 0 < lo_s < hi_s, got {lo_s}, {hi_s}")
        self.alpha = alpha
        self.lo_s = lo_s
        self.hi_s = hi_s
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lng = math.log(self.gamma)
        self.n_buckets = int(math.ceil(math.log(hi_s / lo_s) / self._lng))
        # [underflow] + 1..n_buckets + [overflow]
        self._counts = np.zeros(self.n_buckets + 2, np.int64)
        self._n = 0
        self._min = math.inf
        self._max = 0.0
        # integer nanoseconds: merge-order-invariant, unlike a float sum
        self._sum_ns = 0

    # -- writes --------------------------------------------------------------

    def record_many(self, seconds: np.ndarray) -> None:
        x = np.asarray(seconds, np.float64).ravel()
        if x.size == 0:
            return
        self._min = min(self._min, float(x.min()))
        self._max = max(self._max, float(x.max()))
        self._sum_ns += int(round(float(x.sum()) * 1e9))
        self._n += x.size
        k = np.zeros(x.size, np.int64)  # default: underflow
        mid = x > self.lo_s
        over = x > self.hi_s
        k[over] = self.n_buckets + 1
        body = mid & ~over
        if body.any():
            k[body] = np.clip(
                np.ceil(np.log(x[body] / self.lo_s) / self._lng),
                1, self.n_buckets,
            ).astype(np.int64)
        self._counts += np.bincount(k, minlength=len(self._counts))

    def record(self, value: float, count: int = 1) -> None:
        """Record `count` identical samples (the per-batch scalar path:
        batch-residency and service time are one value per batch shared
        by every flow in it — one bucket add, not an n-vector)."""
        if count <= 0:
            return
        v = float(value)
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        self._sum_ns += int(round(v * count * 1e9))
        self._n += count
        if v <= self.lo_s:
            b = 0
        elif v > self.hi_s:
            b = self.n_buckets + 1
        else:
            b = min(max(int(math.ceil(math.log(v / self.lo_s) / self._lng)),
                        1), self.n_buckets)
        self._counts[b] += count

    def merge_from(self, other: "LatencySketch") -> None:
        """Integer bucket add + commutative scalar folds: exact,
        order-independent, never aliases `other`."""
        if (other.alpha, other.lo_s, other.hi_s) != (
                self.alpha, self.lo_s, self.hi_s):
            raise ValueError(
                "sketch layout mismatch: "
                f"(alpha={other.alpha}, lo={other.lo_s}, hi={other.hi_s}) "
                f"vs (alpha={self.alpha}, lo={self.lo_s}, hi={self.hi_s})")
        if other._n == 0:
            return
        self._counts += other._counts
        self._n += other._n
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        self._sum_ns += other._sum_ns

    # -- reads ---------------------------------------------------------------

    @property
    def n(self) -> int:
        return self._n

    @property
    def sum_s(self) -> float:
        return self._sum_ns * 1e-9

    @property
    def mean_s(self) -> float:
        return self._sum_ns * 1e-9 / self._n if self._n else 0.0

    def _bucket_value(self, b: int) -> float:
        if b <= 0:
            return self._min
        if b > self.n_buckets:
            return self._max
        return 2.0 * self.lo_s * self.gamma ** b / (self.gamma + 1.0)

    def percentile(self, q: float) -> float:
        """The q-th percentile (q in [0, 100]), within relative error
        `alpha` of the exact rank statistic ``sorted(x)[ceil(q/100*n)-1]``
        whenever that value lies in ``(lo_s, hi_s]`` (under/overflow
        report the exact running min/max instead). 0.0 when empty."""
        if self._n == 0:
            return 0.0
        rank = min(max(int(math.ceil(q / 100.0 * self._n)), 1), self._n)
        cum = np.cumsum(self._counts)
        b = int(np.searchsorted(cum, rank, side="left"))
        val = self._bucket_value(b)
        return float(min(max(val, self._min), self._max))

    def counts(self) -> np.ndarray:
        return self._counts.copy()

    def summary(self) -> dict:
        return {
            "n": self._n,
            "p50_s": self.percentile(50),
            "p90_s": self.percentile(90),
            "p99_s": self.percentile(99),
            "mean_s": self.mean_s,
            "max_s": self._max if self._n else 0.0,
        }

    # -- snapshot ------------------------------------------------------------

    def to_doc(self) -> dict:
        """JSON-able frozen view. Counts are sparse sorted [index, count]
        pairs and the sum is integer ns, so two docs of identically
        merged sketches compare equal regardless of merge order."""
        nz = np.nonzero(self._counts)[0]
        return {
            "alpha": self.alpha,
            "lo_s": self.lo_s,
            "hi_s": self.hi_s,
            "n": int(self._n),
            "min_s": float(self._min) if self._n else 0.0,
            "max_s": float(self._max),
            "sum_ns": int(self._sum_ns),
            "counts": [[int(i), int(self._counts[i])] for i in nz],
        }

    @classmethod
    def from_doc(cls, d: dict) -> "LatencySketch":
        sk = cls(alpha=d["alpha"], lo_s=d["lo_s"], hi_s=d["hi_s"])
        for i, c in d["counts"]:
            sk._counts[i] = c
        sk._n = int(d["n"])
        sk._min = d["min_s"] if sk._n else math.inf
        sk._max = d["max_s"]
        sk._sum_ns = int(d["sum_ns"])
        return sk


class LatencyRecorder:
    """Per-component latency sketches for one worker.

    `_WorkerClock.charge` calls `record_batch` once per resolved batch
    with the clock's own decomposition points; each flow in the batch
    contributes one sample to every component, and the per-sample
    identity ``total = queue_wait + batch + service`` is exact (the
    integer-ns sums agree to rounding — asserted by tests). Registry
    names come from `METRIC_NAMESPACE` (``latency.queue_wait`` …), so
    the namespace test covers them like any counter.
    """

    def __init__(self, alpha: float = 0.01, lo_s: float = 1e-9,
                 hi_s: float = 1e4):
        self.alpha, self.lo_s, self.hi_s = alpha, lo_s, hi_s
        self.sketches = {
            c: LatencySketch(alpha=alpha, lo_s=lo_s, hi_s=hi_s)
            for c in COMPONENTS
        }

    def fresh(self) -> "LatencyRecorder":
        """An empty recorder with this one's sketch layout (elastic
        scale-out mints one per late worker)."""
        return LatencyRecorder(alpha=self.alpha, lo_s=self.lo_s,
                               hi_s=self.hi_s)

    def record_batch(self, ready_ts: np.ndarray, flush_ts: float,
                     start: float, done: float) -> None:
        """One resolved batch on the inference lane: per-flow queue-wait
        (ready→flush), shared batch-residency (flush→start) and service
        (start→done) weighted by the batch size, per-flow totals."""
        ready = np.asarray(ready_ts, np.float64)
        n = ready.size
        if n == 0:
            return
        s = self.sketches
        s["queue_wait"].record_many(flush_ts - ready)
        s["batch"].record(start - flush_ts, count=n)
        s["service"].record(done - start, count=n)
        s["total"].record_many(done - ready)

    def merge_from(self, other: "LatencyRecorder") -> None:
        for c in COMPONENTS:
            self.sketches[c].merge_from(other.sketches[c])

    @property
    def n(self) -> int:
        return self.sketches["total"].n

    def to_registry(self, registry=None, prefix: str = ""):
        from .registry import MetricsRegistry

        reg = registry if registry is not None else MetricsRegistry()
        for c in COMPONENTS:
            reg.attach_sketch(prefix + METRIC_NAMESPACE[f"latency_{c}"],
                              self.sketches[c])
        return reg

    @classmethod
    def from_registry(cls, reg, prefix: str = "") -> "LatencyRecorder":
        """Adopt a registry's latency sketches (`MetricsRegistry.merge`
        constructs fresh ones, so adoption never aliases a shard's)."""
        total = reg.sketch(prefix + METRIC_NAMESPACE["latency_total"])
        rec = cls(alpha=total.alpha, lo_s=total.lo_s, hi_s=total.hi_s)
        for c in COMPONENTS:
            rec.sketches[c] = reg.sketch(
                prefix + METRIC_NAMESPACE[f"latency_{c}"])
        return rec

    def summary(self) -> dict:
        return {c: self.sketches[c].summary() for c in COMPONENTS}


@dataclasses.dataclass
class LatencyConfig:
    """`Observability` attachment knob: per-component latency recording.

    One `LatencyRecorder` is minted *per worker* at attach time (sketch
    merges across shards are exact, so per-worker recording costs
    nothing in fidelity) and linked onto the worker's metrics block;
    the worker's `LatencyHistogram` reads the total sketch for
    exact-bound percentiles past its reservoir cap."""

    alpha: float = 0.01
    lo_s: float = 1e-9
    hi_s: float = 1e4

    def make(self) -> LatencyRecorder:
        return LatencyRecorder(alpha=self.alpha, lo_s=self.lo_s,
                               hi_s=self.hi_s)
