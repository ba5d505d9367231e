"""Unified serving observability (DESIGN.md §11).

Port of `repro.serve.obs`, unchanged but for its imports (numpy only).

One subsystem spanning the serving stack, four pieces:

- `registry` — the fleet-wide `MetricsRegistry`: every ad-hoc counter,
  histogram, and telemetry view behind one dotted namespace with exact
  snapshot/delta semantics and order-independent cross-shard merge.
- `trace` — the bounded ring-buffer `Tracer`: per-flow lifecycle spans
  and per-worker stage spans on the replay packet clock, sampled,
  off by default, exported as Chrome trace-event JSON.
- `audit` — the control-plane `AuditLog`: every rebalance / retire /
  scale / hot-swap decision as a structured event with before/after
  EWMA snapshots and the planner's rationale.
- `drift` — the online `DriftMonitor`: class-mix and confidence EWMAs
  plus streaming feature moments from dispatch outputs — the signal the
  ROADMAP's self-optimizing fleet will threshold.
- `latency` — per-component `LatencySketch` recording (queue-wait /
  batch-residency / service / total) with bounded relative error and
  order-independent merges (DESIGN.md §14.1).
- `slo` — windowed attainment + multi-window burn-rate tracking on the
  packet clock, audited as kind ``"slo"`` (DESIGN.md §14.2).
- `export` — Prometheus text exposition + JSONL time series over any
  registry view, at control-step cadence (DESIGN.md §14.3).

`Observability` bundles the live hooks and knows how to attach them to
a runtime (single or sharded): attachment is attribute injection on the
dispatchers and metrics blocks, so a runtime with no bundle attached
pays exactly one ``is not None`` test per hook site.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .audit import AuditEvent, AuditLog
from .drift import DriftMonitor, DriftVerdict, StreamingMoments
from .export import MetricsExporter, check_prometheus, render_prometheus
from .latency import COMPONENTS, LatencyConfig, LatencyRecorder, LatencySketch
from .registry import MetricsRegistry
from .slo import SLOConfig, SLOTracker, SLOVerdict
from .trace import TID_CONTROL, TID_INFER, TID_INGEST, TID_TENANT0, Tracer

__all__ = [
    "AuditEvent",
    "AuditLog",
    "COMPONENTS",
    "DriftMonitor",
    "DriftVerdict",
    "LatencyConfig",
    "LatencyRecorder",
    "LatencySketch",
    "MetricsExporter",
    "MetricsRegistry",
    "Observability",
    "SLOConfig",
    "SLOTracker",
    "SLOVerdict",
    "StreamingMoments",
    "Tracer",
    "TID_CONTROL",
    "TID_INFER",
    "TID_INGEST",
    "TID_TENANT0",
    "check_prometheus",
    "fleet_registry",
    "render_prometheus",
]


def fleet_registry(runtime, per_shard: bool = True) -> MetricsRegistry:
    """The runtime's metrics as one registry — `ShardedRuntime` merges
    its shards (with ``shard{i}.`` columns), a single `StreamingRuntime`
    projects its one block — plus the live flow-table occupancy gauges
    (point-in-time state the cumulative counters cannot carry)."""
    agg = runtime.metrics
    if hasattr(agg, "registry"):  # AggregateMetrics
        reg = agg.registry(per_shard=per_shard)
    else:
        reg = agg.to_registry()
    workers = getattr(runtime, "shards", [runtime])
    occs = [w.table.occupancy() for w in workers]
    reg.set_gauge("flow_table.n_active",
                  float(sum(o["n_active"] for o in occs)), reduce="sum")
    reg.set_gauge("flow_table.load_factor",
                  max(o["load_factor"] for o in occs), reduce="max")
    reg.set_gauge("flow_table.tombstones",
                  float(sum(o["tombstones"] for o in occs)), reduce="sum")
    if per_shard and len(workers) > 1:
        for i, o in enumerate(occs):
            reg.set_gauge(f"shard{i}.flow_table.load_factor",
                          o["load_factor"], reduce="max")
    return reg


@dataclasses.dataclass
class Observability:
    """The attachable observability bundle for one runtime/replay.

    Any piece may be None (and the tracer defaults to None — tracing is
    opt-in); the audit log always exists because recording a decision is
    cheap and losing one is not.
    """

    tracer: Optional[Tracer] = None
    drift: Optional[DriftMonitor] = None
    audit: AuditLog = dataclasses.field(default_factory=AuditLog)
    # latency-component sketches: a config, not a recorder — one fresh
    # `LatencyRecorder` is minted per worker so sketches merge per shard
    latency: Optional[LatencyConfig] = None
    # a single shared tracker: window counts are integer adds, so every
    # shard's `_WorkerClock` can feed the same one
    slo: Optional[SLOTracker] = None
    exporter: Optional[MetricsExporter] = None

    def attach(self, runtime) -> "Observability":
        """Inject the hooks into every worker's dispatcher. Idempotent;
        returns self so ``Observability(...).attach(rt)`` chains."""
        workers = getattr(runtime, "shards", [runtime])
        for i, w in enumerate(workers):
            self.attach_worker(w, i)
        return self

    def attach_worker(self, worker, shard_id: int) -> None:
        """Hook one `StreamingRuntime` (elastic scale-out attaches late
        workers through here so their spans carry the right shard pid)."""
        disp = worker.dispatcher
        disp.tracer = self.tracer
        disp.drift = self.drift
        disp.trace_pid = shard_id
        if self.latency is not None and worker.metrics.latency_components is None:
            worker.metrics.enable_latency_components(self.latency.make())

    def snapshot(self, runtime, control=None) -> dict:
        """One frozen document for the whole run: the merged fleet
        registry snapshot plus whatever else is live (control summary,
        drift signal, audit and trace summaries)."""
        out = {"registry": fleet_registry(runtime).snapshot()}
        if control is not None:
            out["control"] = control.summary()
            out["control_registry"] = control.telemetry.to_registry().snapshot()
        if self.drift is not None:
            out["drift"] = self.drift.signal()
        if self.slo is not None:
            out["slo"] = self.slo.signal()
        if self.audit is not None and len(self.audit):
            out["audit"] = self.audit.summary()
        if self.tracer is not None:
            out["trace"] = self.tracer.summary()
        return out
