"""Streaming serving runtime: online flow table, micro-batched dispatch,
offered-load replay, and zero-loss throughput measurement (DESIGN.md §6).

Port of `repro.serve.runtime`. Turns the batch `ServingPipeline` into a
continuous online service:

    packet blocks -> FlowTable.observe_batch -> MicroBatchDispatcher
                  -> pinned staging arenas -> fused CUDA kernel -> labels

Ingest is vectorized on the host (`StreamingRuntime.ingest_packets`,
bit-equivalent to the scalar cadence — DESIGN.md §7), dispatch stages
batches in preallocated per-bucket arenas whose copies to the card run
asynchronously, and `replay` / `find_zero_loss_rate` measure the paper's
Fig. 5c zero-loss throughput over live packet streams. Drift-gated
prediction reuse (`ReuseConfig`, DESIGN.md §12) refreshes frozen flows
from their aggregate rows through the kernel B3.

Horizontal scale is `ShardedRuntime` (DESIGN.md §8): n independent host
workers behind RSS-style symmetric 5-tuple steering, sharing one pipeline
on one card.
"""
from .dispatch import (
    BatchRecord,
    MicroBatchDispatcher,
    ReuseConfig,
    StreamingRuntime,
    next_bucket,
)
from .flow_table import (
    FlowStatus,
    FlowTable,
    move_slot,
    symmetric_tuple_hash64,
    tuple_hash64,
)
from .metrics import LatencyHistogram, RuntimeMetrics
from .replay import (
    PacketStream,
    ReplayStats,
    ServiceModel,
    find_zero_loss_rate,
    replay,
)
from .shard import AggregateMetrics, ShardedRuntime, steer_flows, stream_buckets

# multi-tenant white-box serving (DESIGN.md §15): the shared pipeline is
# built by the traffic layer but served by this runtime, so the runtime
# namespace re-exports it alongside the single-tenant machinery
from ...traffic.multi_tenant import (  # noqa: E402
    MultiTenantPipeline,
    build_multi_tenant_pipeline,
)

__all__ = [
    "AggregateMetrics",
    "BatchRecord",
    "FlowStatus",
    "FlowTable",
    "LatencyHistogram",
    "MicroBatchDispatcher",
    "MultiTenantPipeline",
    "PacketStream",
    "ReplayStats",
    "ReuseConfig",
    "RuntimeMetrics",
    "ServiceModel",
    "ShardedRuntime",
    "StreamingRuntime",
    "build_multi_tenant_pipeline",
    "find_zero_loss_rate",
    "move_slot",
    "next_bucket",
    "replay",
    "steer_flows",
    "stream_buckets",
    "symmetric_tuple_hash64",
    "tuple_hash64",
]
