"""Fleet-wide metrics registry (DESIGN.md §11.1).

Port of `repro.serve.obs.registry`,
unchanged but for its imports (numpy only).

One namespace over everything the serving stack counts. The hot paths keep
mutating plain ints (`RuntimeMetrics`) and numpy arrays (`BucketTelemetry`)
— the registry is the *reporting* layer built from them on demand, never
the mutation layer, so instrumenting costs the hot path nothing.

Metric kinds:

- **counters** — monotone ints. Snapshot/delta are exact integer
  arithmetic; merge is a sum, so it is order-independent by construction.
- **gauges** — point-in-time floats with a declared merge reduction
  (``sum`` | ``max`` | ``min`` | ``mean``). A gauge merged under ``mean``
  carries its weight so the merge stays order-independent.
- **histograms** — `LatencyHistogram` blocks. Merge folds via
  `merge_from`, the single histogram-merge primitive: bucket counts,
  min/max/sum merge exactly (commutative integer/scalar ops); only the
  capped raw-sample reservoir is order-sensitive, and snapshots therefore
  expose counts + exact scalars, never the reservoir.
- **sketches** — `LatencySketch` quantile sketches (DESIGN.md §14.1).
  Like histograms but with a bounded-relative-error percentile read and
  *no* order-sensitive state at all: counts, n and the integer-ns sum
  merge by integer addition, so merged snapshots are bit-identical under
  shard permutation.
- **sets** — e.g. dispatch shapes seen; merge is set union.
- **samples** — bounded append-only observations (batch occupancy);
  merge concatenates, and every derived statistic is permutation-
  invariant.

Names are dotted paths: ``flow_table.evictions``, ``dispatch.batches``,
``control.telemetry.rolls`` … A per-shard view prefixes ``shard3.``; the
fleet merge strips nothing — parts are merged *positionally* on equal
names, which is why `ShardedRuntime` and `controlled_replay` can report
through one path instead of three hand-rolled aggregations.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from .latency import LatencySketch
from ..runtime.metrics import LatencyHistogram

__all__ = ["MetricsRegistry"]

_GAUGE_REDUCES = ("sum", "max", "min", "mean")


class MetricsRegistry:
    """Named counters/gauges/histograms/sets/samples with exact
    snapshot/delta semantics and order-independent cross-shard merge."""

    def __init__(self) -> None:
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, tuple[float, str, float]] = {}  # (v, reduce, w)
        self._hists: dict[str, LatencyHistogram] = {}
        self._sketches: dict[str, LatencySketch] = {}
        self._sets: dict[str, set] = {}
        self._samples: dict[str, list] = {}

    # -- writes --------------------------------------------------------------

    def inc(self, name: str, by: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + int(by)

    def set_counter(self, name: str, value: int) -> None:
        self._counters[name] = int(value)

    def set_gauge(self, name: str, value: float, *, reduce: str = "sum",
                  weight: float = 1.0) -> None:
        if reduce not in _GAUGE_REDUCES:
            raise ValueError(f"unknown gauge reduce {reduce!r}")
        self._gauges[name] = (float(value), reduce, float(weight))

    def attach_hist(self, name: str, hist: LatencyHistogram) -> None:
        """Register a live histogram block (not copied: snapshots copy)."""
        self._hists[name] = hist

    def attach_sketch(self, name: str, sketch: LatencySketch) -> None:
        """Register a live quantile sketch (not copied: snapshots copy)."""
        self._sketches[name] = sketch

    def union(self, name: str, items: Iterable) -> None:
        self._sets.setdefault(name, set()).update(items)

    def extend_samples(self, name: str, values: Sequence) -> None:
        self._samples.setdefault(name, []).extend(values)

    # -- reads ---------------------------------------------------------------

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def gauge(self, name: str) -> float:
        return self._gauges[name][0]

    def hist(self, name: str) -> LatencyHistogram:
        return self._hists[name]

    def sketch(self, name: str) -> LatencySketch:
        return self._sketches[name]

    def sketch_names(self) -> list[str]:
        return sorted(self._sketches)

    def names(self) -> list[str]:
        return sorted(
            set(self._counters) | set(self._gauges) | set(self._hists)
            | set(self._sketches) | set(self._sets) | set(self._samples)
        )

    # -- snapshot / delta ----------------------------------------------------

    def snapshot(self) -> dict:
        """Frozen, JSON-friendly view: exact ints, gauge floats, histogram
        counts + exact scalars (never the reservoir), sorted set members,
        copied sample lists. Two snapshots of an untouched registry are
        equal; `delta` between snapshots is exact."""
        hists = {}
        for name, h in self._hists.items():
            hists[name] = {
                "n": int(h.n),
                "counts": h.counts().tolist(),
                "min_s": float(h._min) if h.n else 0.0,
                "max_s": float(h._max),
                "sum_s": float(h._sum),
            }
        return {
            "counters": dict(self._counters),
            "gauges": {k: {"value": v, "reduce": r, "weight": w}
                       for k, (v, r, w) in self._gauges.items()},
            "hists": hists,
            "sketches": {k: sk.to_doc() for k, sk in self._sketches.items()},
            "sets": {k: sorted(map(_set_key, v)) for k, v in self._sets.items()},
            "samples": {k: list(v) for k, v in self._samples.items()},
        }

    @staticmethod
    def delta(cur: dict, prev: dict) -> dict:
        """Exact difference between two snapshots of the same registry.

        Counters and histogram counts subtract (ints, so the delta over an
        interval is exactly the interval's activity); samples return the
        appended tail; sets return the new members; gauges report
        (cur - prev) of the value. ``delta(snap, snap)`` is all-zero."""
        out = {
            "counters": {
                k: v - prev.get("counters", {}).get(k, 0)
                for k, v in cur.get("counters", {}).items()
            },
            "gauges": {
                k: g["value"] - prev.get("gauges", {}).get(k, {}).get("value", 0.0)
                for k, g in cur.get("gauges", {}).items()
            },
            "hists": {},
            "sketches": {},
            "sets": {},
            "samples": {},
        }
        for k, h in cur.get("hists", {}).items():
            p = prev.get("hists", {}).get(k)
            if p is None:
                out["hists"][k] = dict(h)
            else:
                out["hists"][k] = {
                    "n": h["n"] - p["n"],
                    "counts": (np.asarray(h["counts"])
                               - np.asarray(p["counts"])).tolist(),
                    "sum_s": h["sum_s"] - p["sum_s"],
                    # min/max are lifetime extrema, not interval ones
                    "min_s": h["min_s"],
                    "max_s": h["max_s"],
                }
        for k, s in cur.get("sketches", {}).items():
            p = prev.get("sketches", {}).get(k)
            if p is None:
                out["sketches"][k] = dict(s)
            else:
                diff = dict(s.get("counts", []))
                for i, c in p.get("counts", []):
                    diff[i] = diff.get(i, 0) - c
                out["sketches"][k] = {
                    **{f: s[f] for f in ("alpha", "lo_s", "hi_s")},
                    "n": s["n"] - p["n"],
                    "sum_ns": s["sum_ns"] - p["sum_ns"],
                    # min/max are lifetime extrema, not interval ones
                    "min_s": s["min_s"],
                    "max_s": s["max_s"],
                    "counts": [[i, c] for i, c in sorted(diff.items()) if c],
                }
        for k, s in cur.get("sets", {}).items():
            before = set(map(tuple_or_id, prev.get("sets", {}).get(k, [])))
            out["sets"][k] = [x for x in s if tuple_or_id(x) not in before]
        for k, v in cur.get("samples", {}).items():
            n_prev = len(prev.get("samples", {}).get(k, []))
            out["samples"][k] = list(v[n_prev:])
        return out

    # -- merge ---------------------------------------------------------------

    @classmethod
    def merge(cls, parts: "Sequence[MetricsRegistry]",
              prefixes: Optional[Sequence[str]] = None) -> "MetricsRegistry":
        """Order-independent cross-shard merge.

        Counters sum, gauges fold under their declared reduction, sets
        union, samples concatenate (statistics over them are permutation-
        invariant), histograms fold into a *fresh* block via `merge_from`
        — the parts are never aliased or mutated, so merging is a pure
        read. With `prefixes` (one per part), each part's metrics are
        *additionally* kept under ``{prefix}{name}`` so the merged
        registry carries both the fleet totals and the per-shard columns
        (``shard3.ingest.drops_ring`` …) in one namespace."""
        if prefixes is not None and len(prefixes) != len(parts):
            raise ValueError("prefixes must match parts 1:1")
        agg = cls()
        for idx, part in enumerate(parts):
            for k, v in part._counters.items():
                agg._counters[k] = agg._counters.get(k, 0) + v
            for k, (v, r, w) in part._gauges.items():
                agg._gauges[k] = _fold_gauge(agg._gauges.get(k), v, r, w)
            for k, h in part._hists.items():
                if k not in agg._hists:
                    agg._hists[k] = LatencyHistogram(
                        lo_s=h.lo_s, hi_s=h.hi_s, max_samples=h.max_samples)
                agg._hists[k].merge_from(h)
            for k, sk in part._sketches.items():
                if k not in agg._sketches:
                    agg._sketches[k] = LatencySketch(
                        alpha=sk.alpha, lo_s=sk.lo_s, hi_s=sk.hi_s)
                agg._sketches[k].merge_from(sk)
            for k, s in part._sets.items():
                agg._sets.setdefault(k, set()).update(s)
            for k, v in part._samples.items():
                agg._samples.setdefault(k, []).extend(v)
            if prefixes is not None:
                p = prefixes[idx]
                for k, v in part._counters.items():
                    agg._counters[p + k] = agg._counters.get(p + k, 0) + v
                for k, (v, r, w) in part._gauges.items():
                    agg._gauges[p + k] = _fold_gauge(
                        agg._gauges.get(p + k), v, r, w)
        return agg


def _fold_gauge(cur: Optional[tuple], v: float, r: str, w: float) -> tuple:
    if cur is None:
        return (v, r, w)
    cv, cr, cw = cur
    if cr != r:
        raise ValueError(f"gauge reduce mismatch: {cr!r} vs {r!r}")
    if r == "sum":
        return (cv + v, r, cw + w)
    if r == "max":
        return (max(cv, v), r, cw + w)
    if r == "min":
        return (min(cv, v), r, cw + w)
    # weighted mean: commutative + associative, so order-independent
    return ((cv * cw + v * w) / max(cw + w, 1e-300), r, cw + w)


def _set_key(x):
    """Sortable JSON-friendly form of a set member (tuples -> lists)."""
    return list(x) if isinstance(x, tuple) else x


def tuple_or_id(x):
    """Hashable identity for snapshot set members (lists -> tuples)."""
    return tuple(x) if isinstance(x, list) else x
