"""Offered-load replay + zero-loss throughput measurement (DESIGN.md §6).

Port of `repro.serve.runtime.replay`. The clock, the stream, the search and
the attachments of a `ServeSession` (control plane, observability bundle,
reoptimizer) are the reference's; the pipeline the replay drives runs on
the card.

The paper's Fig. 5c metric — *zero-loss throughput*, the highest offered
load the pipeline sustains without dropping a single packet — is an
RFC-2544-style measurement, not a model. This module measures it:

1. `PacketStream.from_dataset` flattens a `TrafficDataset` into a packet
   event stream: flows start along a Poisson arrival process (overlapping
   `avg_active_flows` deep), packets follow their flow-relative trace
   timing. Offered load is scaled tcpreplay-style: one clock-compression
   factor on *delivery* times. The payload timestamps the feature path
   consumes stay the trace's own (they are what the original capture
   recorded), so predictions are rate-invariant — which is also what makes
   probing rates without re-running inference sound.
2. `replay` drives the event stream through a `StreamingRuntime` under a
   deterministic two-lane clock model whose constants come from a
   `ServiceModel`:
     - the *ingest lane* is a single server with a bounded ring
       (NIC-style): packets arriving while `ring_capacity` packets are
       already waiting are lost — plus flow-table overflow, these are the
       only loss sources;
     - the *inference lane* runs micro-batches; because dispatch is
       double-buffered, it overlaps ingest and only its own backlog delays
       predictions.
   Real extraction + inference still execute (`execute=True`) so the run
   yields actual predictions; `execute=False` replays timing only, which
   is what the bisection uses (predictions are rate-invariant).
3. `ServiceModel.measure` calibrates the clock constants from wall-clock
   timings of the *actual* ingest loop and of the pipeline on its device
   (the copies in, the kernel, the copy back), once per bucket; `ServiceModel.modeled` derives them from the
   feature registry's op DAG (Table-2 magnitudes) for deterministic
   cross-machine runs.
4. `find_zero_loss_rate` brackets and bisects the offered rate to the
   highest zero-drop point, then re-verifies it with a full executing
   replay.

Calibrated-constant clocking keeps the measurement honest (the constants
are measured) while making the search reproducible (the simulation is
exact), which is what lets tests assert "zero drops below the reported
rate" without flaking on scheduler noise.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from ...traffic.extraction import emit_agg_features, stats_plan
from ...traffic.features import FEATURES, per_flow_ops_ns, per_packet_ops
from ...traffic.synth import FLAG_NAMES, TrafficDataset, scenario_flow_starts
from ..obs.trace import TID_INFER, TID_INGEST, TID_TENANT0
from ..session import ServeSession
from .dispatch import BatchRecord, MicroBatchDispatcher, StreamingRuntime
from .flow_table import FlowTable, tuple_hash64
from .metrics import RuntimeMetrics
from .shard import ShardedRuntime

__all__ = [
    "PacketStream",
    "ServiceModel",
    "ReplayStats",
    "replay",
    "find_zero_loss_rate",
]


# ---------------------------------------------------------------------------
# packet event stream
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PacketStream:
    """Flattened per-packet event arrays (delivery-time order) + metadata.

    `base_t` is the float64 delivery time at the stream's base rate
    (`base_pps`); replaying at `offered_pps` multiplies it by
    `base_pps / offered_pps`. `rel_ts32` is the exact float32 payload value
    the flow table stores, so streaming extraction sees bit-identical
    inputs to the batch path.
    """

    fid: np.ndarray        # (E,) int32 flow id (dataset row)
    pidx: np.ndarray       # (E,) int32 packet index within flow
    base_t: np.ndarray     # (E,) float64 delivery time at base rate (sorted)
    rel_ts32: np.ndarray   # (E,) float32 flow-relative payload timestamp
    size: np.ndarray       # (E,) float32
    direction: np.ndarray  # (E,) uint8
    ttl: np.ndarray        # (E,) float32
    winsize: np.ndarray    # (E,) float32
    flags_byte: np.ndarray # (E,) uint8 packed TCP flags
    fin: np.ndarray        # (E,) bool
    # per-flow
    key: np.ndarray        # (n_flows,) uint64 5-tuple hash
    proto: np.ndarray
    s_port: np.ndarray
    d_port: np.ndarray
    label: np.ndarray
    base_pps: float = 0.0  # offered packet rate of the unscaled stream
    class_names: tuple = ()
    # raw 5-tuple endpoints (per flow): what RSS-style symmetric steering
    # hashes over. Optional for streams built before sharding existed.
    s_ip: Optional[np.ndarray] = None   # (n_flows,) int64
    d_ip: Optional[np.ndarray] = None   # (n_flows,) int64

    @property
    def n_events(self) -> int:
        return len(self.fid)

    @property
    def n_flows(self) -> int:
        return len(self.key)

    @property
    def mean_pkts_per_flow(self) -> float:
        return self.n_events / self.n_flows

    @property
    def total_bytes(self) -> float:
        return float(self.size.sum())

    @classmethod
    def from_dataset(
        cls,
        ds: TrafficDataset,
        seed: int = 0,
        avg_active_flows: int = 64,
        scenario: str = "uniform",
    ) -> "PacketStream":
        """Flatten `ds` into a delivery-ordered packet stream.

        `scenario` selects the flow *arrival process* (see
        `repro_torch.traffic.synth.scenario_flow_starts`): "uniform" is the
        historical Poisson process, "burst" modulates it with MMPP on/off
        phases. Dataset-level scenario structure (Zipf flow-mass skew,
        drifting class mix) is applied earlier, by
        `make_scenario_dataset`."""
        rows, cols = np.nonzero(ds.valid_mask())
        flags = ds.flags[rows, cols]  # (E, 8)
        flags_byte = (flags.astype(np.uint16) << np.arange(8)).sum(1).astype(np.uint8)
        fin = flags[:, FLAG_NAMES.index("fin")] > 0
        rng = np.random.default_rng(seed)
        # synthetic 5-tuples: unique src ip/port per flow, shared dst per class
        s_ip = 0x0A000000 + np.arange(ds.n_flows, dtype=np.int64)
        d_ip = 0xC0A80000 + ds.label.astype(np.int64)
        key = np.array(
            [
                tuple_hash64(
                    int(s_ip[i]), int(d_ip[i]), int(ds.s_port[i]),
                    int(ds.d_port[i]), int(ds.proto[i]),
                )
                for i in range(ds.n_flows)
            ],
            dtype=np.uint64,
        )
        # Poisson flow arrivals spaced so ~avg_active_flows overlap; the
        # overlap *structure* is fixed, clock compression scales the speed
        rel64 = ds.ts[rows, cols].astype(np.float64)
        last = np.minimum(ds.flow_len, ds.max_pkts) - 1
        mean_dur = float(ds.ts[np.arange(ds.n_flows), last].mean())
        spacing = max(mean_dur, 1e-3) / max(avg_active_flows, 1)
        starts = scenario_flow_starts(rng, ds.n_flows, spacing, scenario)
        base_t = starts[rows] + rel64
        order = np.argsort(base_t, kind="stable")
        span = float(base_t[order[-1]] - base_t[order[0]])
        return cls(
            fid=rows[order].astype(np.int32),
            pidx=cols[order].astype(np.int32),
            base_t=base_t[order],
            rel_ts32=ds.ts[rows, cols].astype(np.float32)[order],
            size=ds.size[rows, cols].astype(np.float32)[order],
            direction=ds.direction[rows, cols][order],
            ttl=ds.ttl[rows, cols].astype(np.float32)[order],
            winsize=ds.winsize[rows, cols].astype(np.float32)[order],
            flags_byte=flags_byte[order],
            fin=fin[order],
            key=key,
            proto=ds.proto.astype(np.float32),
            s_port=ds.s_port.astype(np.float32),
            d_port=ds.d_port.astype(np.float32),
            label=ds.label.copy(),
            base_pps=len(rows) / max(span, 1e-9),
            class_names=ds.class_names,
            s_ip=s_ip,
            d_ip=d_ip,
        )


# ---------------------------------------------------------------------------
# service models (the replay clock's constants)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServiceModel:
    """Per-operation service times (ns) driving the virtual clock."""

    pkt_accum_ns: float                 # ingest: packet into the dense payload
    pkt_track_ns: float                 # ingest: connection tracking only
    bucket_ns: dict[int, float]         # inference lane: per padded batch
    gather_ns_per_flow: float = 200.0   # ingest lane: row gather at flush
    # prediction reuse (DESIGN.md §12): frozen-path packet cost (aggregate
    # update only; falls back to pkt_track_ns when uncalibrated), per-flow
    # drift-check cost at a refresh, and per-flow anchor snap cost
    pkt_frozen_ns: Optional[float] = None
    reuse_check_ns: float = 0.0
    anchor_ns_per_flow: float = 0.0
    # multi-tenant serving (DESIGN.md §15): tenant t's fraction of each
    # inference-lane span — attribution only, the clock charges the fused
    # batch once; None for single-tenant models
    tenant_fracs: Optional[tuple] = None
    source: str = "modeled"

    def packet_ns(self, accumulated: bool, frozen: bool = False) -> float:
        if frozen:
            return self.frozen_ns
        return self.pkt_accum_ns if accumulated else self.pkt_track_ns

    @property
    def frozen_ns(self) -> float:
        return (self.pkt_frozen_ns if self.pkt_frozen_ns is not None
                else self.pkt_track_ns)

    def batch_ns(self, bucket: int) -> float:
        if bucket in self.bucket_ns:
            return self.bucket_ns[bucket]
        # extrapolate linearly from the largest calibrated bucket
        b_max = max(self.bucket_ns)
        return self.bucket_ns[b_max] * bucket / b_max

    def submit_ns(self, n_real: int) -> float:
        return self.gather_ns_per_flow * n_real

    # -- constructors --------------------------------------------------------

    @classmethod
    def modeled(cls, rep, forest, *, overhead_ns: float = 500.0,
                reuse_discount: float = 1.0) -> "ServiceModel":
        """Derive constants from the feature-op DAG (Table-2 magnitudes).

        `reuse_discount` < 1 models drift-gated prediction reuse: frozen
        packets are charged that fraction of the tracked cost (the caller
        supplies the ratio — `TrafficProfiler.reuse_discount` learns it
        from measured calibrations when any exist), and the drift check
        is one feature emission from the aggregate block per flow."""
        per_pkt = per_packet_ops(rep.features)
        per_flow = per_flow_ops_ns(rep.features)
        n_sort = sum(1 for f in rep.features if FEATURES[f].sorting)
        sort_ns = n_sort * 0.8 * rep.depth * np.log2(max(rep.depth, 2.0))
        infer_ns = forest.n_trees * forest.depth * 1.2 + 2.0 * forest.n_out
        flow_ns = per_flow + sort_ns + infer_ns
        buckets = {b: overhead_ns + flow_ns * b for b in (8, 16, 32, 64, 128, 256, 512)}
        track_ns = 2.0  # capture + tracker touch, past depth n
        frozen_ns = None
        check_ns = 0.0
        if reuse_discount < 1.0:
            frozen_ns = track_ns * reuse_discount
            check_ns = 50.0 + 5.0 * len(rep.features)
        return cls(
            pkt_accum_ns=per_pkt,
            pkt_track_ns=track_ns,
            bucket_ns=buckets,
            pkt_frozen_ns=frozen_ns,
            reuse_check_ns=check_ns,
            anchor_ns_per_flow=check_ns,
            source="modeled",
        )

    @classmethod
    def modeled_multi_tenant(
        cls, reps, forests, *, overhead_ns: float = 500.0
    ) -> "ServiceModel":
        """Constants for a shared multi-tenant fleet (DESIGN.md §15).

        The white-box sharing shows up as the cost asymmetry: ingest and
        extraction are charged ONCE over the *union* feature plan (shared
        ops deduped across tenants), while inference sums every tenant's
        forest — exactly what the merged `FlowTable` + fused multi-forest
        kernel execute. `tenant_fracs` carries each tenant's share of the
        inference term so the tracer can attribute the fused span."""
        feats = sorted({f for r in reps for f in r.features})
        depth = max(int(r.depth) for r in reps)
        per_pkt = per_packet_ops(feats)
        per_flow = per_flow_ops_ns(feats)
        n_sort = sum(1 for f in feats if FEATURES[f].sorting)
        sort_ns = n_sort * 0.8 * depth * np.log2(max(depth, 2.0))
        infer = [f.n_trees * f.depth * 1.2 + 2.0 * f.n_out for f in forests]
        flow_ns = per_flow + sort_ns + sum(infer)
        buckets = {b: overhead_ns + flow_ns * b
                   for b in (8, 16, 32, 64, 128, 256, 512)}
        total_inf = max(sum(infer), 1e-9)
        return cls(
            pkt_accum_ns=per_pkt,
            pkt_track_ns=2.0,
            bucket_ns=buckets,
            tenant_fracs=tuple(v / total_inf for v in infer),
            source="modeled",
        )

    @classmethod
    def measure(
        cls,
        runtime: StreamingRuntime,
        stream: PacketStream,
        *,
        n_pkt_sample: int = 8000,
        reps: int = 3,
        ingest_chunk: int = 128,
        calibrate_warm: bool = False,
    ) -> "ServiceModel":
        """Calibrate from wall-clock timings of the real code paths.

        `calibrate_warm=True` additionally measures the steady-state
        per-packet classes on a *populated* table — the tracking touch of
        a flow past its window and the frozen aggregate-only touch of a
        PREDICTED flow under reuse — plus the per-flow drift-check cost.
        Without it the legacy estimate (`pkt_track_ns = 0.25 ×` the cold
        per-packet cost) is kept, so existing calibrations reproduce."""
        # a sharded fleet is homogeneous: calibrate on its first worker
        runtime = getattr(runtime, "shards", [runtime])[0]
        # -- ingest cost: run the actual vectorized observe_batch path
        # (the path the replay drives) on a scratch table, block by block.
        # The default block matches the flush-bounded sub-blocks
        # (~max_batch) the runtime actually feeds it at measured rates.
        # Mirrors the runtime table's reuse layout so aggregate-update
        # work is part of the charged per-packet cost when reuse is on.
        rtab = runtime.table
        tab_kw = dict(
            metrics=None, track_agg=rtab.track_agg, reuse=rtab.reuse,
            refresh_every=rtab.refresh_every, anchor_dim=rtab.anchor_dim,
            agg_buffer=rtab._ab_cap or 1024,
        )

        def fresh_table():
            kw = dict(tab_kw)
            kw["metrics"] = RuntimeMetrics()
            return FlowTable(rtab.capacity, rtab.pkt_depth, **kw)

        table = fresh_table()
        n = min(n_pkt_sample, stream.n_events)
        fid = stream.fid[:n]
        keys = stream.key[fid]
        proto, s_port, d_port = (
            stream.proto[fid], stream.s_port[fid], stream.d_port[fid])

        def feed(tbl, fin):
            for c0 in range(0, n, ingest_chunk):
                c1 = min(c0 + ingest_chunk, n)
                tbl.observe_batch(
                    keys[c0:c1], stream.base_t[c0:c1], stream.rel_ts32[c0:c1],
                    stream.size[c0:c1], stream.direction[c0:c1],
                    stream.ttl[c0:c1], stream.winsize[c0:c1],
                    stream.flags_byte[c0:c1], proto[c0:c1], s_port[c0:c1],
                    d_port[c0:c1], fid[c0:c1], fin[c0:c1],
                )
        # best-of-reps: a single timing pass is at the mercy of scheduler
        # noise on shared machines, and this one constant dominates the
        # ingest lane — jitter here scatters whole benchmark rows
        pkt_ns = np.inf
        for _ in range(reps):
            scratch = fresh_table()
            t0 = time.perf_counter()
            feed(scratch, stream.fin)
            pkt_ns = min(pkt_ns, (time.perf_counter() - t0) / n * 1e9)
            table = scratch

        pkt_track_ns = pkt_ns * 0.25  # legacy guess: tracker skips payload
        pkt_frozen_ns = None
        reuse_check_ns = 0.0
        anchor_ns = 0.0
        if calibrate_warm:
            # steady-state tracking: re-feed the same packets into the
            # populated table — every flow is past its window, every
            # packet takes the tracked path (fin suppressed so no flow
            # closes mid-measurement)
            no_fin = np.zeros(n, bool)
            best = np.inf
            for _ in range(reps):
                t0 = time.perf_counter()
                feed(table, no_fin)
                best = min(best, (time.perf_counter() - t0) / n * 1e9)
            pkt_track_ns = best
            if table.reuse:
                # frozen fast path: mark every live flow PREDICTED, so the
                # re-fed packets all take the aggregate-only carve-out
                live = table.ctrl["state"] != 0
                table.ctrl["state"][live] = 3
                best = np.inf
                for _ in range(reps):
                    t0 = time.perf_counter()
                    feed(table, no_fin)
                    best = min(best, (time.perf_counter() - t0) / n * 1e9)
                pkt_frozen_ns = best
                # drift check / anchor snap: one feature emission from the
                # aggregate block per flow (the compare itself is noise)
                plan = stats_plan(runtime.pipeline.rep.features)
                slots = np.nonzero(live)[0][:256]
                if slots.size:
                    best = np.inf
                    for _ in range(max(reps, 3)):
                        t0 = time.perf_counter()
                        cols = emit_agg_features(
                            plan, table.agg[slots],
                            proto=table.proto[slots],
                            s_port=table.s_port[slots],
                            d_port=table.d_port[slots])
                        np.stack(cols, axis=1)
                        best = min(
                            best,
                            (time.perf_counter() - t0) / slots.size * 1e9)
                    reuse_check_ns = best
                    anchor_ns = best
                table.ctrl["state"][live] = 2  # restore READY for gather

        # -- inference lane: time the pipeline once per bucket on the host
        # clock; `finalize` waits for the device, so a time covers the
        # copies in, the kernel and the copy back (a scratch dispatcher
        # bound to the populated scratch table, so the gathered batches
        # hold real flow rows)
        disp = runtime.dispatcher
        disp_s = MicroBatchDispatcher(
            table, runtime.pipeline, max_batch=disp.max_batch,
            min_bucket=disp.min_bucket, execute=False, metrics=table.metrics,
        )
        buckets, b = [], disp.min_bucket
        while b <= disp.max_batch:
            buckets.append(b)
            b *= 2
        slots = np.nonzero(table.ctrl["state"] != 0)[0]
        bucket_ns = {}
        gather_ns = []
        for b in buckets:
            sl = slots[: min(len(slots), b)]
            disp_s.gather(sl, b)  # warm: allocates this bucket's arena
            t0 = time.perf_counter()
            ds = disp_s.gather(sl, b)
            gather_ns.append((time.perf_counter() - t0) / max(len(sl), 1) * 1e9)
            # warm-up: the first call loads the kernel library and makes
            # this bucket's device allocations
            runtime.pipeline.finalize(runtime.pipeline.predict_async(ds))
            best = np.inf
            for _ in range(reps):
                t0 = time.perf_counter()
                runtime.pipeline.finalize(runtime.pipeline.predict_async(ds))
                best = min(best, time.perf_counter() - t0)
            bucket_ns[b] = best * 1e9
        return cls(
            pkt_accum_ns=pkt_ns,
            pkt_track_ns=pkt_track_ns,
            bucket_ns=bucket_ns,
            gather_ns_per_flow=float(np.median(gather_ns)),
            pkt_frozen_ns=pkt_frozen_ns,
            reuse_check_ns=reuse_check_ns,
            anchor_ns_per_flow=anchor_ns,
            source="measured",
        )


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplayStats:
    offered_pps: float
    offered_gbps: float
    duration_s: float
    drops: int
    drops_ring: int
    drops_table: int
    metrics: RuntimeMetrics
    predictions: dict
    latency_p50_s: float
    latency_p99_s: float
    # sharded replay: worker count, steering balance, per-worker rollups
    n_shards: int = 1
    load_imbalance: float = 1.0
    per_shard: list = dataclasses.field(default_factory=list)
    # control-plane replay: rebalance/swap/elastic activity summary
    control: dict = dataclasses.field(default_factory=dict)
    # virtual service seconds per stage, summed over workers (ingest =
    # packet accumulation/tracking, infer = batched extract+inference,
    # flush = gather/submit) — where a packet's time goes (DESIGN.md §11)
    stage_seconds: dict = dataclasses.field(default_factory=dict)

    def stage_shares(self) -> dict:
        """Each stage's share of total charged service time (sums to 1
        whenever any service was charged)."""
        total = sum(self.stage_seconds.values())
        if total <= 0:
            return {k: 0.0 for k in self.stage_seconds}
        return {k: v / total for k, v in self.stage_seconds.items()}

    def summary(self) -> dict:
        out = {
            "offered_pps": self.offered_pps,
            "offered_gbps": self.offered_gbps,
            "duration_s": self.duration_s,
            "drops": self.drops,
            "latency_p50_s": self.latency_p50_s,
            "latency_p99_s": self.latency_p99_s,
            **{f"rt_{k}": v for k, v in self.metrics.summary().items()
               if not isinstance(v, dict)},
        }
        if self.stage_seconds:
            out["stage_seconds"] = dict(self.stage_seconds)
            out["stage_shares"] = self.stage_shares()
        if self.n_shards > 1:
            out["n_shards"] = self.n_shards
            out["load_imbalance"] = self.load_imbalance
            out["per_shard"] = self.per_shard
        if self.control:
            out["control"] = self.control
        return out


def _lindley(t: np.ndarray, s: np.ndarray, busy: float) -> np.ndarray:
    """Vectorized single-server queue recurrence b_i = max(t_i, b_{i-1}) + s_i.

    Standard Lindley unrolling: with S_i = cumsum(s) inclusive,
    b_i = S_i + max(busy, max_{j<=i}(t_j - S_{j-1})).
    """
    cs = np.cumsum(s)
    return cs + np.maximum(np.maximum.accumulate(t - (cs - s)), busy)


@dataclasses.dataclass
class _Events:
    """Per-packet event columns for one worker, in delivery order.

    Per-flow attributes (key, 5-tuple floats) are pre-gathered to
    per-packet columns so the drive loop and the per-shard splitter are
    plain slices/fancy-indexing with no indirection left."""

    t: np.ndarray          # scaled delivery times (float64, sorted)
    fid: np.ndarray
    key: np.ndarray
    rel32: np.ndarray
    size: np.ndarray
    direction: np.ndarray
    ttl: np.ndarray
    winsize: np.ndarray
    flags_byte: np.ndarray
    fin: np.ndarray
    proto: np.ndarray
    s_port: np.ndarray
    d_port: np.ndarray


def _gather_events(
    stream: PacketStream, t_e: np.ndarray, sel: Optional[np.ndarray] = None
) -> _Events:
    """Flatten `stream` (optionally the `sel` event subset) to `_Events`."""
    if sel is None:
        fid = stream.fid
        t, rel32 = t_e, stream.rel_ts32
        size, direction, ttl = stream.size, stream.direction, stream.ttl
        winsize, flags_byte, fin = stream.winsize, stream.flags_byte, stream.fin
    else:
        fid = stream.fid[sel]
        t, rel32 = t_e[sel], stream.rel_ts32[sel]
        size, direction, ttl = (
            stream.size[sel], stream.direction[sel], stream.ttl[sel])
        winsize, flags_byte, fin = (
            stream.winsize[sel], stream.flags_byte[sel], stream.fin[sel])
    return _Events(
        t=t, fid=fid, key=stream.key[fid], rel32=rel32, size=size,
        direction=direction, ttl=ttl, winsize=winsize,
        flags_byte=flags_byte, fin=fin, proto=stream.proto[fid],
        s_port=stream.s_port[fid], d_port=stream.d_port[fid],
    )


class _WorkerClock:
    """Persistent two-lane virtual clock for one worker (one NIC queue).

    Holds the lane state (`busy_ingest`, `busy_infer`, the bounded ring of
    outstanding ingest completions) *across* `feed` calls, so a worker can
    be driven incrementally: the static replay feeds the whole steered
    sub-stream in one call, while the control plane interleaves all
    shards block by block, pausing between blocks for telemetry/rebalance
    steps (DESIGN.md §9). The clock semantics per feed are unchanged from
    the original drive loop: vectorized blocks whenever a conservative
    admission bound proves the ring cannot overflow (service charged at
    the worst per-packet rate plus the whole block's possible flush-submit
    cost), an order-exact per-packet fallback otherwise — DESIGN.md
    §6.3/§7.

    `service` is a plain attribute: a pipeline hot-swap retargets the
    worker's constants mid-run by assigning it.
    """

    def __init__(
        self,
        rt: StreamingRuntime,
        service: ServiceModel,
        ring_capacity: int,
        evict_every: int,
        *,
        pid: int = 0,
        tracer=None,
        slo=None,
    ):
        self.rt = rt
        self.service = service
        self.ring_capacity = ring_capacity
        self.evict_every = evict_every
        self.busy_ingest = 0.0
        self.busy_infer = 0.0
        self.ring = np.empty(0, np.float64)  # outstanding completions (sorted)
        self._since_poll = 0
        self.t = 0.0
        # observability (serve/obs): shard pid for trace grouping,
        # optional span tracer, the always-on per-stage service-time
        # rollup (three float adds per block/batch — DESIGN.md §11), and
        # the optional shared SLO tracker (DESIGN.md §14.2) — window
        # counts are integer adds, so all shards feed one tracker
        self.pid = pid
        self.tracer = tracer
        self.slo = slo
        self.stage_s = {"ingest": 0.0, "infer": 0.0, "flush": 0.0}

    def charge(self, recs: list[BatchRecord], charge_submit: bool = True) -> None:
        """Inference-lane accounting; optionally charge the ingest-lane
        submit cost (the vectorized path charges it inside the recurrence
        at the triggering packet instead). Public so the control plane can
        charge quiesce/swap flushes to the worker that fired them."""
        service = self.service
        m = self.rt.metrics
        tr = self.tracer
        for rec in recs:
            if rec.reason == "refresh":
                # reuse refresh (DESIGN.md §12): the drift check is charged
                # per frozen flow examined, the padded re-inference batch
                # only when drift actually sent flows back through the
                # forest, the anchor re-snap per re-anchored flow. No
                # latency sample — a refresh never produces a flow's first
                # prediction (first-prediction-wins keeps `results`
                # bit-identical to the non-reuse path).
                svc = (service.reuse_check_ns * rec.n_checked
                       + service.anchor_ns_per_flow * rec.n_anchor) * 1e-9
                if rec.n_real:
                    svc += service.batch_ns(rec.bucket) * 1e-9
                start = max(rec.flush_ts, self.busy_infer)
                self.busy_infer = start + svc
                self.stage_s["infer"] += svc
                if tr is not None and tr.enabled:
                    tr.span("infer.refresh", start, svc,
                            pid=self.pid, tid=TID_INFER)
                continue
            if charge_submit:
                sub = service.submit_ns(rec.n_real) * 1e-9
                self.busy_ingest += sub
                self.stage_s["flush"] += sub
            svc = (service.batch_ns(rec.bucket)
                   + service.anchor_ns_per_flow * rec.n_anchor) * 1e-9
            start = max(rec.flush_ts, self.busy_infer)
            done = start + svc
            self.busy_infer = done
            self.stage_s["infer"] += svc
            total = done - rec.ready_ts
            m.latency.record_many(total)
            # latency decomposition + SLO accounting (DESIGN.md §14): the
            # enqueue→prediction total splits exactly into queue-wait
            # (ready→flush, per flow), batch-residency (flush→start, the
            # inference lane's backlog) and service (start→done)
            lat = m.latency_components
            if lat is not None:
                lat.record_batch(rec.ready_ts, rec.flush_ts, start, done)
            if self.slo is not None:
                self.slo.note(done, total)
            if tr is not None and tr.enabled:
                # one X span per batch on the inference lane; sampled flow
                # lifecycles close at the same service-completion edge
                tr.span(f"infer.{rec.reason}", start, svc,
                        pid=self.pid, tid=TID_INFER)
                if service.tenant_fracs:
                    # multi-tenant attribution (DESIGN.md §15): partition
                    # the fused span across per-tenant sub-lanes so one
                    # traced replay shows which tenant dominates the
                    # kernel budget; the clock still charges it once
                    t0 = start
                    for t_i, frac in enumerate(service.tenant_fracs):
                        d = svc * frac
                        tr.span(f"infer.tenant{t_i}", t0, d,
                                pid=self.pid, tid=TID_TENANT0 + t_i)
                        t0 += d
                if rec.trace_ids is not None:
                    tr.flow_end(rec.trace_ids,
                                np.full(len(rec.trace_ids), done),
                                pid=self.pid)

    def charge_ingest(self, seconds: float) -> None:
        """Serialize extra work into the ingest lane (e.g. the per-flow
        state-copy cost of a RETA migration)."""
        self.busy_ingest += seconds
        self.stage_s["ingest"] += seconds

    def feed(self, ev: _Events) -> None:
        """Drive one delivery-ordered event block through the worker."""
        rt = self.rt
        service = self.service
        m = rt.metrics
        E = len(ev.t)

        s_acc = service.pkt_accum_ns * 1e-9
        s_trk = service.pkt_track_ns * 1e-9
        s_frz = service.frozen_ns * 1e-9
        s_max = max(s_acc, s_trk, s_frz)
        sub_flow = service.gather_ns_per_flow * 1e-9
        evict_every = self.evict_every

        tr = self.tracer
        pos = 0
        while pos < E:
            hi = min(pos + evict_every, E)
            tc = ev.t[pos:hi]
            n = hi - pos
            busy_at_entry = self.busy_ingest
            # retire completed service (the scalar loop's per-arrival popleft)
            ring = self.ring[np.searchsorted(self.ring, tc[0], side="right"):]

            # conservative no-drop proof for this block: every packet at the
            # slowest service class, all possible flush submits front-loaded
            b_w = _lindley(tc, np.full(n, s_max), self.busy_ingest) \
                + sub_flow * (len(rt.dispatcher._queue) + n)
            carry = ring.size - np.searchsorted(ring, tc, side="right")
            own = np.arange(n) - np.searchsorted(b_w, tc, side="right")
            if int((carry + own).max()) < self.ring_capacity:
                # -- vectorized block: admission proven, ingest in one call
                _, accumulated, recs = rt.ingest_packets(
                    ev.key[pos:hi], tc, ev.rel32[pos:hi], ev.size[pos:hi],
                    ev.direction[pos:hi], ev.ttl[pos:hi], ev.winsize[pos:hi],
                    ev.flags_byte[pos:hi], ev.proto[pos:hi], ev.s_port[pos:hi],
                    ev.d_port[pos:hi], ev.fid[pos:hi], ev.fin[pos:hi],
                )
                s_i = np.where(accumulated, s_acc, s_trk)
                fz = getattr(rt, "last_frozen_mask", None)
                if fz is not None:
                    # frozen PREDICTED flows bypass the 3-phase path: their
                    # packets cost an aggregate-only touch
                    s_i = np.where(fz, s_frz, s_i)
                self.stage_s["ingest"] += float(s_i.sum())
                # exact lane recurrence, segmented at flush submits
                b = np.empty(n)
                seg_lo = 0
                for rec in recs:
                    if rec.reason == "refresh":
                        continue  # infer-lane only (charged below)
                    k = rec.flush_idx
                    if k >= seg_lo:
                        b[seg_lo:k + 1] = _lindley(
                            tc[seg_lo:k + 1], s_i[seg_lo:k + 1],
                            self.busy_ingest)
                        self.busy_ingest = b[k]
                        seg_lo = k + 1
                    sub = service.submit_ns(rec.n_real) * 1e-9
                    self.busy_ingest += sub
                    self.stage_s["flush"] += sub
                if seg_lo < n:
                    b[seg_lo:] = _lindley(tc[seg_lo:], s_i[seg_lo:],
                                          self.busy_ingest)
                    self.busy_ingest = b[n - 1]
                self.ring = np.concatenate([ring, b])
                self.charge(recs, charge_submit=False)
                self.t = tc[-1]
                self._since_poll += n
                if self._since_poll >= evict_every:
                    self.charge(rt.poll(self.t))
                    self._since_poll = 0
            else:
                # -- fallback: per-packet loop, order-exact admission
                rq: deque[float] = deque(ring.tolist())
                ingest = rt.ingest_packet
                ing_s = 0.0
                for i in range(pos, hi):
                    t = self.t = ev.t[i]
                    while rq and rq[0] <= t:
                        rq.popleft()
                    self._since_poll += 1
                    poll_due = self._since_poll >= evict_every
                    if poll_due:
                        self._since_poll = 0
                    if len(rq) >= self.ring_capacity:
                        # drop; a poll boundary landing here is skipped,
                        # matching the scalar cadence (`continue` first)
                        m.pkts_total += 1
                        m.drops_ring += 1
                        continue
                    acc0 = m.pkts_accumulated
                    _, recs = ingest(
                        int(ev.key[i]), t, float(ev.rel32[i]),
                        float(ev.size[i]), int(ev.direction[i]),
                        float(ev.ttl[i]), float(ev.winsize[i]),
                        int(ev.flags_byte[i]), float(ev.proto[i]),
                        float(ev.s_port[i]), float(ev.d_port[i]),
                        int(ev.fid[i]), bool(ev.fin[i]),
                    )
                    start_srv = max(t, self.busy_ingest)
                    svc = service.packet_ns(
                        m.pkts_accumulated > acc0,
                        bool(getattr(rt.table, "last1_frozen", False)),
                    ) * 1e-9
                    ing_s += svc
                    self.busy_ingest = start_srv + svc
                    rq.append(self.busy_ingest)
                    if recs:
                        self.charge(recs)
                    if poll_due:
                        self.charge(rt.poll(t))
                self.ring = np.asarray(rq, np.float64)
                self.stage_s["ingest"] += ing_s
            if tr is not None and tr.enabled and self.busy_ingest > busy_at_entry:
                # ingest-lane busy envelope for this block: one X span from
                # the lane's first possible service instant to its new busy
                # edge (an envelope, not per-packet slices — block cost
                # discipline; idle gaps inside a block are subsumed)
                start = max(busy_at_entry, float(tc[0]))
                tr.span("ingest.block", start, self.busy_ingest - start,
                        pid=self.pid, tid=TID_INGEST)
            pos = hi

    def finish(self, t_end: float) -> None:
        """End of stream: drain the worker at the global clock edge."""
        self.charge(self.rt.drain(t_end))


def _drive(
    rt: StreamingRuntime,
    ev: _Events,
    service: ServiceModel,
    ring_capacity: int,
    evict_every: int,
    t_end: float,
    *,
    pid: int = 0,
    tracer=None,
    slo=None,
) -> _WorkerClock:
    """Drive one worker's whole event stream: feed + drain (the static
    single-owner path; the control plane drives `_WorkerClock` directly).

    Each worker is one core with one NIC queue: its own ingest lane,
    bounded ring of `ring_capacity`, and inference lane. Under a static
    `ShardedRuntime` this runs once per shard over the steered sub-stream;
    lanes never interact across shards (DESIGN.md §8). All effects
    accumulate in `rt` and its metrics; the final drain is clocked at the
    caller's `t_end` so every shard of a fleet stops on the same global
    clock edge. Returns the clock (its stage rollup outlives the drive).
    """
    clock = _WorkerClock(rt, service, ring_capacity, evict_every,
                         pid=pid, tracer=tracer, slo=slo)
    clock.feed(ev)
    clock.finish(t_end)
    return clock


def replay(
    stream: PacketStream,
    make_runtime: Callable[[], "StreamingRuntime | ShardedRuntime"],
    offered_pps: float,
    service: ServiceModel,
    *,
    ring_capacity: int = 4096,
    evict_every: int = 512,
    control=None,
    obs=None,
    session=None,
) -> ReplayStats:
    """Replay `stream` at `offered_pps` through a fresh runtime.

    `make_runtime` may build either a single `StreamingRuntime` or a
    `ShardedRuntime`; the sharded case steers the offered load across
    workers by the symmetric 5-tuple hash and replays each shard's
    sub-stream under its own two-lane clock (per-shard ingest lane, NIC
    ring of `ring_capacity` *per queue*, and inference lane — RSS
    semantics). Shards are causally independent, so replaying them in
    sequence is exactly the concurrent execution. Aggregate drops sum
    over shards: a drop on *any* shard breaks the zero-loss property.

    The clock semantics per worker are `_drive`'s (vectorized
    admission-proven blocks with an order-exact per-packet fallback —
    DESIGN.md §6.3/§7).

    `session` (a `ServeSession`) carries every attachment in
    one object: the observability bundle, the control-loop config, and
    the reoptimizer policy. With a control config (and a sharded
    runtime) the replay runs under the adaptive control plane instead:
    shards are driven interleaved in global time, and telemetry-driven
    RETA rebalancing / hot-swap / elastic / re-optimization actions fire
    between blocks (DESIGN.md §9, §13). Steering is then dynamic, so
    that path delegates to `serve.control.replay.controlled_replay`.

    `control` (a `serve.control.ControlConfig`) and `obs` (a
    `serve.obs.Observability`) are the pre-session spellings of
    the same attachments — still accepted, deprecated (they fold into a
    session via `ServeSession.coerce`).
    """
    session = ServeSession.coerce(session, control=control, obs=obs)
    if session.control is not None:
        from ..control.replay import controlled_replay

        return controlled_replay(
            stream, make_runtime, offered_pps, service,
            ring_capacity=ring_capacity, evict_every=evict_every,
            session=session,
        )
    if session.reopt is not None:
        raise TypeError(
            "a ReoptimizerPolicy needs the control plane (episodes run on "
            "control-step cadence): add a ControlConfig to the session")
    obs = session.obs
    rt = make_runtime()
    tracer = slo = None
    if obs is not None:
        obs.attach(rt)
        tracer = obs.tracer
        slo = obs.slo
        if obs.exporter is not None:
            from ..obs import fleet_registry

            obs.exporter.bind(lambda: fleet_registry(rt), slo=slo)
    # tcpreplay-style clock compression: one factor scales delivery times
    t_e = stream.base_t * (stream.base_pps / offered_pps)
    # stop the clock one flush-timeout after the last packet: flows still
    # queued would have flushed by then anyway, flows short of depth n get
    # their late (end-of-capture) classification. Sharded fleets stop on
    # the same global edge regardless of where their last packet landed.
    t_end = float(t_e[-1]) + rt.flush_timeout_s if len(t_e) else 0.0
    duration = float(t_e[-1] - t_e[0]) if stream.n_events > 1 else 1.0
    gbps = stream.total_bytes * 8.0 / max(duration, 1e-9) / 1e9

    stage_seconds = {"ingest": 0.0, "infer": 0.0, "flush": 0.0}

    def fold_stages(clock: _WorkerClock) -> dict:
        for k, v in clock.stage_s.items():
            stage_seconds[k] += v
        return dict(clock.stage_s)

    if isinstance(rt, ShardedRuntime):
        shard_of_pkt = rt.steer_stream(stream)[stream.fid]
        shard_stages: dict[int, dict] = {}
        for i, srt in enumerate(rt.shards):
            sel = np.flatnonzero(shard_of_pkt == i)
            if sel.size:
                shard_stages[i] = fold_stages(_drive(
                    srt, _gather_events(stream, t_e, sel), service,
                    ring_capacity, evict_every, t_end,
                    pid=i, tracer=tracer, slo=slo))
            else:
                srt.drain(t_end)
        agg = rt.metrics
        m = agg.merged()
        per_shard = [
            {
                "shard": i,
                "offered_pps": offered_pps * p.pkts_total / max(m.pkts_total, 1),
                "pkts_total": p.pkts_total,
                "drops_ring": p.drops_ring,
                "drops_table": p.drops_table,
                "flows_predicted": p.flows_predicted,
                "batches": p.batches,
                "occupancy_mean": p.occupancy_stats()["mean"],
                "latency_p50_s": p.latency.percentile(50),
                "latency_p99_s": p.latency.percentile(99),
                "stage_seconds": shard_stages.get(i, {}),
            }
            for i, p in enumerate(agg.parts)
        ]
        n_shards, imbalance = rt.n_shards, agg.load_imbalance()
    else:
        fold_stages(_drive(rt, _gather_events(stream, t_e), service,
                           ring_capacity, evict_every, t_end, tracer=tracer,
                           slo=slo))
        m = rt.metrics
        per_shard, n_shards, imbalance = [], 1, 1.0

    if obs is not None and obs.exporter is not None:
        # no control plane to pace it: one end-of-run export record
        obs.exporter.step(t_end)

    return ReplayStats(
        offered_pps=offered_pps,
        offered_gbps=gbps,
        duration_s=duration,
        drops=m.drops,
        drops_ring=m.drops_ring,
        drops_table=m.drops_table,
        metrics=m,
        predictions=dict(rt.results),
        latency_p50_s=m.latency.percentile(50),
        latency_p99_s=m.latency.percentile(99),
        n_shards=n_shards,
        load_imbalance=imbalance,
        per_shard=per_shard,
        stage_seconds=stage_seconds,
    )


def find_zero_loss_rate(
    stream: PacketStream,
    make_runtime: Callable[[bool], StreamingRuntime],
    service: ServiceModel,
    *,
    lo_pps: Optional[float] = None,
    hi_pps: Optional[float] = None,
    iters: int = 12,
    ring_capacity: int = 4096,
    verbose: bool = False,
    control=None,
    obs=None,
    session=None,
) -> tuple[float, ReplayStats]:
    """Bisect the highest offered rate with zero drops (Fig. 5c protocol).

    `make_runtime(execute)` builds a fresh runtime — a `StreamingRuntime`
    or a `ShardedRuntime` (the bisection is over the *aggregate* offered
    load either way, and `ReplayStats.drops` sums every shard, so one
    dropping shard fails the trial); bisection probes run with
    `execute=False` (timing only — predictions are rate-invariant), and
    the returned stats come from a final *executing* verification replay
    at the found rate. `ring_capacity` is per worker queue.

    `session` (or the deprecated `control=`) measures the *adaptive*
    fleet: every probe replays under the control plane (fresh runtime,
    fresh telemetry), so the reported rate is the zero-loss throughput
    of the closed-loop system — rebalancing transients included.

    The session's observability bundle attaches only to the final
    *executing* verification replay — the bisection probes stay untraced
    (tracing a probe would record thousands of spans for runs whose only
    output is a drop count). The reoptimizer policy likewise rides only
    the final replay: probes run `execute=False`, which produces no
    predictions to drift on.
    """
    session = ServeSession.coerce(session, control=control, obs=obs)
    # probes: control plane yes, observability/reoptimizer no
    probe_session = ServeSession(control=session.control)
    def ring_guard(events_bound: int, scope: str) -> None:
        """The ring is per worker queue: the (sub-)trace offered to a
        queue must exceed it, or that queue can absorb its whole offered
        load and the measurement never saturates."""
        if ring_capacity >= events_bound:
            raise ValueError(
                f"ring_capacity ({ring_capacity}) >= {scope} events "
                f"({events_bound}): the ring can absorb the whole trace, so "
                "no offered rate can ever drop. Shrink ring_capacity (it is "
                "the DUT's per-queue buffer, and must be small relative to "
                "the trace)."
            )

    # static pre-check (no probe needed): the whole trace upper-bounds
    # any shard's sub-trace, so this catches the single-runtime case —
    # and the grossest sharded misconfigurations — before any work
    ring_guard(stream.n_events, "stream")

    def probe(r):
        return replay(
            stream, lambda: make_runtime(False), r, service,
            ring_capacity=ring_capacity, session=probe_session,
        )

    # bracket from the stream's own base rate unless told otherwise: every
    # probe is a full-trace replay, so starting orders of magnitude below
    # the interesting region wastes real work
    lo = lo_pps if lo_pps is not None else stream.base_pps
    first = probe(lo)
    if first.n_shards > 1:
        # exact per-queue bound: the first probe's per-shard packet
        # totals are the steered sub-trace sizes (every offered packet
        # is counted, dropped or not)
        ring_guard(max(p["pkts_total"] for p in first.per_shard),
                   f"hottest of {first.n_shards} shards")
    for _ in range(24):
        if first.drops == 0:
            break
        lo /= 4.0
        first = probe(lo)
    else:
        raise RuntimeError("no zero-loss rate found: lower bound keeps dropping")
    # bracket: grow hi until it drops
    hi = hi_pps or lo * 2
    for _ in range(30):
        if probe(hi).drops > 0:
            break
        lo, hi = hi, hi * 2
    else:
        raise RuntimeError("offered load never saturated the pipeline")
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        d = probe(mid).drops
        if verbose:
            print(f"  bisect {mid:12.0f} pps -> drops={d}")
        if d == 0:
            lo = mid
        else:
            hi = mid
    final = replay(
        stream, lambda: make_runtime(True), lo, service,
        ring_capacity=ring_capacity, session=session,
    )
    return lo, final
