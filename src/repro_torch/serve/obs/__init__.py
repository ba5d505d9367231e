"""Serving observability (DESIGN.md §11, §14), the parts the runtime uses.

Ported so far: `latency` (`LatencySketch`, `LatencyRecorder`, `LatencyConfig`), `registry`
(`MetricsRegistry`, the one merge path of the fleet's counters) and
`trace` (`Tracer` and its lanes, off by default). The `Observability`
bundle, the drift monitor, the SLO tracker, the exporter and the audit
log wait for ROADMAP A10.
"""
from .latency import LatencyConfig, LatencyRecorder, LatencySketch
from .registry import MetricsRegistry
from .trace import TID_CONTROL, TID_INFER, TID_INGEST, TID_TENANT0, Tracer

__all__ = [
    "LatencyConfig",
    "LatencyRecorder",
    "LatencySketch",
    "MetricsRegistry",
    "TID_CONTROL",
    "TID_INFER",
    "TID_INGEST",
    "TID_TENANT0",
    "Tracer",
]
