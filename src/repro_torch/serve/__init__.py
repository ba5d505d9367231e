"""Serving substrate of the port: the streaming traffic runtime.

Port of `repro.serve`, the parts ported so far: the runtime (`runtime/`:
online flow table with vectorized block ingest, micro-batched
shape-bucketed dispatch staged in pinned arenas, drift-gated prediction
reuse, offered-load replay with zero-loss throughput measurement, RSS-style
sharding — DESIGN.md §6–§8, §12), the multi-tenant pipeline it serves
(`MultiTenantPipeline`, `build_multi_tenant_pipeline`, DESIGN.md §15), the
metrics registry, latency sketches and tracer of `obs/`, and
`ServeSession`, whose attachments wait for ROADMAP A10 (the control plane,
the rest of `obs/`, deploy), and the LM serving steps (`serve_step.py`:
`make_prefill`, `make_serve_step`) for the dense and hybrid families.

This module is the public serving namespace of the port: everything a
serving consumer needs is re-exported here.
"""
from .obs import LatencyConfig, LatencyRecorder, LatencySketch, MetricsRegistry, Tracer
from .runtime import (
    BatchRecord,
    FlowStatus,
    FlowTable,
    LatencyHistogram,
    MicroBatchDispatcher,
    MultiTenantPipeline,
    PacketStream,
    ReplayStats,
    ReuseConfig,
    RuntimeMetrics,
    ServiceModel,
    ShardedRuntime,
    StreamingRuntime,
    build_multi_tenant_pipeline,
    find_zero_loss_rate,
    replay,
    tuple_hash64,
)
from .serve_step import make_prefill, make_serve_step
from .session import ServeSession

__all__ = sorted([
    "BatchRecord",
    "FlowStatus",
    "FlowTable",
    "LatencyConfig",
    "LatencyHistogram",
    "LatencyRecorder",
    "LatencySketch",
    "MetricsRegistry",
    "MicroBatchDispatcher",
    "MultiTenantPipeline",
    "PacketStream",
    "ReplayStats",
    "ReuseConfig",
    "RuntimeMetrics",
    "ServeSession",
    "ServiceModel",
    "ShardedRuntime",
    "StreamingRuntime",
    "Tracer",
    "build_multi_tenant_pipeline",
    "find_zero_loss_rate",
    "make_prefill",
    "make_serve_step",
    "replay",
    "tuple_hash64",
])
