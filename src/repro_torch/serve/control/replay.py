"""Controlled offered-load replay: the adaptive fleet under the virtual
clock (DESIGN.md §9.4).

Port of `repro.serve.control.replay`, unchanged but for its imports (numpy
only).

The static sharded replay precomputes steering once and drives each shard
sequentially — valid because shards never interact. Under the control
plane, steering *changes mid-run*, so this replay interleaves: the global
event stream advances in delivery-ordered blocks, each block is steered
by the RETA as it stands, and between blocks the control plane may
rebalance, swap, or resize. Each worker keeps a persistent `_WorkerClock`
(its two serving lanes and bounded ring survive across blocks), so the
clock semantics per worker are identical to the static replay; the only
new costs are the ones the control plane explicitly charges (quiesce
flushes and per-flow migration copies).

Control cadence counts packets, so a zero-loss bisection over this
replay probes the same adaptation trajectory at every offered rate —
the reported rate is the closed-loop system's, transients included.
"""
from __future__ import annotations

import numpy as np

from ..runtime.replay import (
    ReplayStats,
    ServiceModel,
    PacketStream,
    _gather_events,
    _WorkerClock,
)
from ..runtime.shard import ShardedRuntime, stream_buckets

from .plane import ControlConfig, ControlPlane

__all__ = ["controlled_replay"]


def controlled_replay(
    stream: PacketStream,
    make_runtime,
    offered_pps: float,
    service: ServiceModel,
    *,
    control: ControlConfig = None,
    ring_capacity: int = 4096,
    evict_every: int = 512,
    obs=None,
    session=None,
) -> ReplayStats:
    """Replay `stream` at `offered_pps` through a control-plane-managed
    sharded fleet. Same contract as `repro_torch.serve.runtime.replay` (drops
    aggregate across shards; predictions bit-identical to an oracle
    single-worker run for every flow that completes under one pipeline
    configuration), plus a `control` activity summary on the stats.

    `session` (a `repro_torch.serve.ServeSession`) carries the attachments: a
    `ControlConfig` (required here — the control plane is this replay's
    point), an `Observability` bundle to trace flow lifecycles and worker
    stage spans on the same virtual clock, feed the drift monitor from
    dispatch outputs, and collect the control plane's audit log in one
    stream (DESIGN.md §11), and optionally a `ReoptimizerPolicy` for
    drift-triggered background re-optimization (DESIGN.md §13). The
    bare `control=` / `obs=` keywords are the deprecated pre-session
    spellings of the same thing.
    """
    from ..session import ServeSession

    session = ServeSession.coerce(session, control=control, obs=obs)
    if session.control is None:
        raise TypeError(
            "controlled_replay needs a ControlConfig on the session: "
            "without one, use repro_torch.serve.replay")
    obs = session.obs
    rt = make_runtime()
    if not isinstance(rt, ShardedRuntime):
        raise TypeError(
            "controlled_replay needs a ShardedRuntime: the control plane "
            "actuates RETA entries and per-shard state, which a single "
            "worker does not have"
        )
    tracer = slo = None
    if obs is not None:
        obs.attach(rt)
        tracer = obs.tracer
        slo = obs.slo
    plane = ControlPlane(rt, session.control, service, session=session)
    t_e = stream.base_t * (stream.base_pps / offered_pps)
    t_end = float(t_e[-1]) + rt.flush_timeout_s if len(t_e) else 0.0
    duration = float(t_e[-1] - t_e[0]) if stream.n_events > 1 else 1.0
    gbps = stream.total_bytes * 8.0 / max(duration, 1e-9) / 1e9

    # a flow's bucket is fixed for life; only the entry above it moves
    ev_bucket = stream_buckets(stream)[stream.fid]
    ev_key = stream.key[stream.fid]

    clocks = [
        _WorkerClock(srt, service, ring_capacity, evict_every,
                     pid=i, tracer=tracer, slo=slo)
        for i, srt in enumerate(rt.shards)
    ]
    E = stream.n_events
    pos = 0
    while pos < E:
        hi = min(pos + evict_every, E)
        bk = ev_bucket[pos:hi]
        plane.note(ev_key[pos:hi], bk)
        shard = rt.indirection[bk]
        for i in np.unique(shard):
            sel = np.flatnonzero(shard == i) + pos
            clocks[int(i)].feed(_gather_events(stream, t_e, sel))
        step = plane.maybe_step(float(t_e[hi - 1]))
        if step is not None:
            # elastic scale-out: every new worker gets its own lanes
            while len(clocks) < len(rt.shards):
                clocks.append(_WorkerClock(
                    rt.shards[len(clocks)], plane.service,
                    ring_capacity, evict_every,
                    pid=len(clocks), tracer=tracer, slo=slo))
            # quiesce/swap flushes ran on the configuration that produced
            # them: charge before retargeting service constants
            for i, recs in step.records.items():
                clocks[i].charge(recs)
            for i, sec in step.ingest_charge_s.items():
                clocks[i].charge_ingest(sec)
            for i, svc in step.service_switch.items():
                clocks[i].service = svc
        pos = hi

    for clock in clocks:
        clock.finish(t_end)

    stage_seconds: dict[str, float] = {}
    shard_stages: dict[int, dict[str, float]] = {}
    for i, clock in enumerate(clocks):
        shard_stages[i] = dict(clock.stage_s)
        for k, v in clock.stage_s.items():
            stage_seconds[k] = stage_seconds.get(k, 0.0) + v

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
            "flows_migrated_in": p.flows_migrated_in,
            "flows_migrated_out": p.flows_migrated_out,
            "batches": p.batches,
            "occupancy_mean": p.occupancy_stats()["mean"],
            "latency_p50_s": p.latency.percentile(50),
            "latency_p99_s": p.latency.percentile(99),
            "active": bool(rt.active[i]),
            "stage_seconds": shard_stages.get(i, {}),
        }
        for i, p in enumerate(agg.parts)
    ]
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
        n_shards=rt.n_shards,
        load_imbalance=agg.load_imbalance(),
        per_shard=per_shard,
        control=plane.summary(),
        stage_seconds=stage_seconds,
    )
