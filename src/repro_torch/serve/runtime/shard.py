"""Sharded multi-worker runtime: RSS-style flow steering (DESIGN.md §8).

Port of `repro.serve.runtime.shard`, unchanged but for its imports.

Real deployments do not scale a traffic pipeline by making one core
faster — they replicate the per-core pipeline and let NIC receive-side
scaling (RSS) spread flows across queues. This module is that layer:

- `symmetric_tuple_hash64` (flow_table) gives the steering key: both
  directions of a connection hash identically, so a flow's entire packet
  history lands on exactly one worker;
- a 128-entry **indirection table** maps hash -> shard, exactly like the
  NIC's RETA: steering policy is a table rewrite, not a rehash;
- `ShardedRuntime` owns `n_shards` fully independent `StreamingRuntime`
  workers — per-shard `FlowTable`, dispatcher, staging arenas, and
  metrics block — behind the same block-ingest facade, with per-shard
  table sizing (`capacity` is the *aggregate* budget unless
  `capacity_per_shard` overrides it);
- `AggregateMetrics` is the operator view: summed drop/evict counters,
  per-shard occupancy, and the load-imbalance factor (max shard packet
  share over the mean — 1.0 is a perfectly balanced hash).

Sharding only permutes *which* worker serves a flow, never what it
predicts: flows are independent in extraction and inference, so the
sharded runtime is bit-identical to a single worker fed the same
packets (asserted by tests/test_shard.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...traffic.pipeline import ServingPipeline

from .dispatch import BatchRecord, StreamingRuntime
from .flow_table import move_slot, symmetric_tuple_hash64
from .metrics import RuntimeMetrics

__all__ = [
    "AggregateMetrics",
    "ShardedRuntime",
    "INDIRECTION_SIZE",
    "steer_flows",
    "stream_buckets",
]


# RETA size: NICs commonly expose 128 indirection entries. Steering is
# `table[sym_hash & 127]`, so rebalancing = rewriting table entries.
INDIRECTION_SIZE = 128


def steer_flows(stream, n_shards: int, indirection=None) -> np.ndarray:
    """Per-flow shard assignment for a `PacketStream` — the pure steering
    function (no runtime needed; callers sizing per-queue buffers use it
    to find the hottest shard before building anything).

    Uses the stream's recorded 5-tuple endpoints when present; streams
    predating the endpoint fields fall back to steering on the
    flow-identity hash (stable, but not direction-symmetric).
    """
    if indirection is None:
        indirection = np.arange(INDIRECTION_SIZE, dtype=np.int64) % n_shards
    return indirection[stream_buckets(stream)]


def stream_buckets(stream) -> np.ndarray:
    """Per-flow RETA bucket ids for a `PacketStream` — the steering stage
    *before* the indirection lookup. Buckets are a pure function of the
    flow's 5-tuple, so they are fixed for a flow's lifetime no matter how
    the control plane rewrites the table entries above them."""
    if getattr(stream, "s_ip", None) is not None:
        sym = symmetric_tuple_hash64(
            stream.s_ip,
            stream.d_ip,
            stream.s_port.astype(np.int64),
            stream.d_port.astype(np.int64),
            stream.proto.astype(np.int64),
        )
    else:
        sym = np.asarray(stream.key, np.uint64)
    return (sym & np.uint64(INDIRECTION_SIZE - 1)).astype(np.int64)


class AggregateMetrics:
    """Cross-shard metrics view: per-shard blocks + merged aggregate.

    The per-shard `RuntimeMetrics` stay the single source of truth (the
    hot paths keep mutating plain ints); this object derives the summed
    aggregate and the balance statistics on demand.
    """

    def __init__(self, parts: list[RuntimeMetrics], active: list[bool] | None = None):
        self.parts = parts
        self.active = active if active is not None else [True] * len(parts)

    def registry(self, per_shard: bool = True):
        """The fleet `MetricsRegistry` (DESIGN.md §11.1): every shard's
        block merged order-independently into one namespace, with
        ``shard{i}.``-prefixed per-shard columns alongside the fleet
        totals unless `per_shard=False`."""
        from ..obs.registry import MetricsRegistry

        return MetricsRegistry.merge(
            [p.to_registry() for p in self.parts],
            prefixes=[f"shard{i}." for i in range(len(self.parts))]
            if per_shard else None,
        )

    def merged(self) -> RuntimeMetrics:
        """Summed fleet block, derived through the one merge path: the
        per-shard registries fold via `MetricsRegistry.merge` and project
        back to a `RuntimeMetrics` (bit-identical to per-field sums —
        asserted by tests/test_obs.py)."""
        return RuntimeMetrics.from_registry(self.registry(per_shard=False))

    @property
    def drops(self) -> int:
        return sum(p.drops for p in self.parts)

    @property
    def drops_ring(self) -> int:
        return sum(p.drops_ring for p in self.parts)

    @property
    def drops_table(self) -> int:
        return sum(p.drops_table for p in self.parts)

    @property
    def flows_evicted_idle(self) -> int:
        return sum(p.flows_evicted_idle for p in self.parts)

    def per_shard_occupancy(self) -> list[dict]:
        return [p.occupancy_stats() for p in self.parts]

    def load_imbalance(self) -> float:
        """Max shard packet share over the mean share (>= 1.0).

        1.0 means the steering split the offered load perfectly; the
        aggregate zero-loss rate degrades by roughly this factor because
        the hottest shard saturates first. Only *active* workers count:
        a retired worker's small historical total (or a late-added
        worker's near-zero one) would drag the mean down and overstate
        the imbalance of the serving fleet.
        """
        pkts = np.array(
            [p.pkts_total for p, a in zip(self.parts, self.active) if a],
            np.float64,
        )
        if pkts.size == 0 or pkts.sum() == 0:
            return 1.0
        return float(pkts.max() / pkts.mean())

    def summary(self) -> dict:
        return {
            "n_shards": len(self.parts),
            "load_imbalance": self.load_imbalance(),
            "aggregate": self.merged().summary(),
            "per_shard": [
                {
                    "pkts_total": p.pkts_total,
                    "drops_ring": p.drops_ring,
                    "drops_table": p.drops_table,
                    "flows_seen": p.flows_seen,
                    "flows_predicted": p.flows_predicted,
                    "flows_evicted_idle": p.flows_evicted_idle,
                    "batches": p.batches,
                    "occupancy": p.occupancy_stats(),
                }
                for p in self.parts
            ],
        }


class ShardedRuntime:
    """`n_shards` independent streaming workers behind one ingest facade.

    Steering is the only coupling between shards: a packet's shard is a
    pure function of its symmetric 5-tuple hash, so per-shard state
    (flow table, ready queue, staging arenas, pending window) never
    synchronizes. The pipeline object is shared — one set of device
    tables and kernels serves the whole fleet, and per-shard arenas keep
    the asynchronous-copy lifecycle private to each worker. The workers
    are host-side: four shards are four ingest workers feeding one card.
    """

    def __init__(
        self,
        pipeline: ServingPipeline,
        *,
        n_shards: int,
        capacity: int = 2048,
        capacity_per_shard: Optional[int] = None,
        max_batch: int = 256,
        min_bucket: int = 8,
        flush_timeout_s: float = 0.05,
        idle_timeout_s: float = 60.0,
        max_pending: int = 2,
        execute: bool = True,
        pkt_depth: Optional[int] = None,
        load_factor: float = 0.5,
        rebuild_tombstone_frac: float = 0.25,
        reuse=None,
    ):
        if n_shards < 1:
            raise ValueError(
                f"n_shards must be >= 1, got {n_shards}: a sharded runtime "
                "needs at least one worker to steer to"
            )
        if n_shards > INDIRECTION_SIZE:
            raise ValueError(
                f"n_shards ({n_shards}) exceeds the {INDIRECTION_SIZE}-entry "
                "RETA: steering is indirection-table entries -> shards, so "
                "any shard past the entry count could never receive a "
                "packet (silent dead workers). Grow INDIRECTION_SIZE or "
                "shard less."
            )
        self.n_shards = n_shards
        self.pipeline = pipeline
        # aggregate table budget split evenly unless sized explicitly
        per_shard = (
            capacity_per_shard
            if capacity_per_shard is not None
            else -(-capacity // n_shards)
        )
        if per_shard < 1:
            raise ValueError(
                f"per-shard flow-table capacity must be >= 1, got {per_shard} "
                f"(capacity={capacity}, capacity_per_shard={capacity_per_shard}, "
                f"n_shards={n_shards})"
            )
        self.capacity_per_shard = per_shard
        self.flush_timeout_s = flush_timeout_s
        # one worker's construction recipe — elastic scale-out
        # (`add_worker`) must mint bit-compatible replicas
        self._worker_kwargs = dict(
            capacity=per_shard,
            max_batch=max_batch,
            min_bucket=min_bucket,
            flush_timeout_s=flush_timeout_s,
            idle_timeout_s=idle_timeout_s,
            max_pending=max_pending,
            execute=execute,
            pkt_depth=pkt_depth,
            load_factor=load_factor,
            rebuild_tombstone_frac=rebuild_tombstone_frac,
            reuse=reuse,
        )
        self.shards = [
            StreamingRuntime(pipeline, **self._worker_kwargs)
            for _ in range(n_shards)
        ]
        # workers stay list-stable for their lifetime (records carry shard
        # ids); scale-in marks a worker inactive instead of deleting it
        self.active = [True] * n_shards
        # RSS indirection table (RETA): round-robin fill spreads the
        # hash space evenly; rebalancing rewrites entries, not the hash
        self.indirection = np.arange(INDIRECTION_SIZE, dtype=np.int64) % n_shards
        # steering ledger for migration: 5-tuple key -> RETA bucket, fed by
        # `note_steering` (the control-plane ingest path), pruned to live
        # flows on every migration. The table itself cannot recover the
        # bucket (it stores the asymmetric identity hash, and the raw
        # endpoints needed for the symmetric hash are not payload).
        self._bucket_of_key: dict[int, int] = {}
        # frozen-fast-path mask of the last facade `ingest_packets` block
        # (scattered from the per-worker masks; None when reuse is off)
        self.last_frozen_mask: Optional[np.ndarray] = None

    # -- steering ------------------------------------------------------------

    def steer_hash(self, sym_key) -> np.ndarray:
        """Symmetric hash -> shard id via the indirection table."""
        sym_key = np.asarray(sym_key, np.uint64)
        return self.indirection[sym_key & np.uint64(INDIRECTION_SIZE - 1)]

    def steer(self, s_ip, d_ip, s_port, d_port, proto) -> np.ndarray:
        """5-tuple -> shard id; invariant under direction reversal."""
        return self.steer_hash(
            symmetric_tuple_hash64(s_ip, d_ip, s_port, d_port, proto)
        )

    def steer_stream(self, stream) -> np.ndarray:
        """Per-flow shard assignment for a `PacketStream` under this
        fleet's indirection table (see module-level `steer_flows`)."""
        return steer_flows(stream, self.n_shards, self.indirection)

    def note_steering(self, key: np.ndarray, bucket: np.ndarray) -> None:
        """Record which RETA bucket each 5-tuple key steered through.

        The migration protocol needs slot -> bucket to find the flows a
        rewritten entry strands; the ingest arrays carry exactly that
        pairing, so the control path ledgers it here (one dict write per
        *new* flow per block, vectorized dedup). The ledger is pruned to
        live flows whenever it outgrows a multiple of the fleet's table
        budget — migration also prunes, but a balanced run that never
        migrates must not accumulate an entry per flow ever seen."""
        uk, first = np.unique(np.asarray(key, np.uint64), return_index=True)
        bk = np.asarray(bucket)[first]
        ledger = self._bucket_of_key
        for k, b in zip(uk.tolist(), bk.tolist()):
            ledger[k] = b
        cap = max(4096, 4 * self.capacity_per_shard * len(self.shards))
        if len(ledger) > cap:
            self._prune_ledger()

    def _prune_ledger(self) -> None:
        """Drop ledger entries for flows no longer live in any table."""
        live_keys: set[int] = set()
        for rt in self.shards:
            state = rt.table.ctrl["state"]
            live_keys.update(
                int(k) for k in rt.table.ctrl["key"][state != 0].tolist()
            )
        self._bucket_of_key = {
            k: v for k, v in self._bucket_of_key.items() if k in live_keys
        }

    # -- control plane: RETA rewrite + flow migration (DESIGN.md §9) ---------

    def add_worker(self) -> int:
        """Elastic scale-out: mint one more worker replica.

        The new worker owns no RETA entries until the planner migrates
        buckets onto it, so adding is instantaneous and invisible to the
        data path. Returns the new shard id."""
        if self.n_shards >= INDIRECTION_SIZE:
            # same bound the constructor enforces: a worker past the RETA
            # entry count could never be steered to
            raise ValueError(
                f"cannot grow past {INDIRECTION_SIZE} workers: the RETA "
                "has one entry per steering quantum, so extra workers "
                "would be silently dead"
            )
        self.shards.append(StreamingRuntime(self.pipeline, **self._worker_kwargs))
        self.active.append(True)
        self.n_shards += 1
        # late workers inherit the fleet's observability hooks (their
        # spans must carry their own shard pid)
        d0, dn = self.shards[0].dispatcher, self.shards[-1].dispatcher
        dn.tracer = d0.tracer
        dn.drift = d0.drift
        dn.trace_pid = self.n_shards - 1
        # ... including latency-component recording (DESIGN.md §14.1):
        # an empty recorder with shard 0's sketch layout, so the fleet
        # merge keeps folding identically-configured sketches
        rec0 = self.shards[0].metrics.latency_components
        if rec0 is not None:
            self.shards[-1].metrics.enable_latency_components(rec0.fresh())
        return self.n_shards - 1

    def migrate_buckets(self, moves: dict, now: float) -> dict:
        """Rewrite RETA entries and move the stranded flow state with them.

        `moves` maps bucket id -> destination shard. Per source shard the
        protocol is: (1) **quiesce** — flush its ready queue ("migrate"
        flushes through its own pipeline: every READY flow is classified
        by the worker that accumulated it, so batching geometry changes
        but predictions cannot); afterwards the table holds only ACTIVE
        and PREDICTED slots, none referenced by any queue; (2) **move** —
        each live slot whose ledgered bucket is migrating relocates via
        `move_slot` (bit-exact payload, no lifecycle double-counting);
        (3) **rewrite** — only then does the indirection entry flip, so a
        packet that would arrive "next" finds its flow already resident
        on the destination. A bucket whose destination table cannot hold
        the incoming flows is skipped entirely (entry unchanged) — a
        misrouted continuation would re-tenant the 5-tuple and classify
        the flow twice, which is the one unacceptable outcome.

        Returns a report dict: buckets moved/skipped, flows migrated, and
        the per-shard quiesce flush records (the replay clock charges
        them to the right worker's lanes).
        """
        moves = {
            int(b): int(d)
            for b, d in moves.items()
            if int(self.indirection[int(b)]) != int(d)
        }
        records: dict[int, list[BatchRecord]] = {}
        report = {
            "buckets_moved": 0,
            "buckets_skipped": 0,
            "flows_migrated": 0,
            "flows_out": {},   # shard -> slots exported (clock charging)
            "flows_in": {},    # shard -> slots imported
            "records": records,
        }
        if not moves:
            return report
        by_src: dict[int, list[int]] = {}
        for b, d in moves.items():
            by_src.setdefault(int(self.indirection[b]), []).append(b)
        # prune the steering ledger to flows still alive anywhere: dead
        # keys can never migrate (note_steering also prunes on a size cap
        # for runs that never reach this path)
        self._prune_ledger()
        for src, buckets in by_src.items():
            src_rt = self.shards[src]
            table = src_rt.table

            def live_buckets():
                live = np.nonzero(table.ctrl["state"] != 0)[0]
                slot_bucket = np.array(
                    [
                        self._bucket_of_key.get(int(k), -1)
                        for k in table.ctrl["key"][live].tolist()
                    ],
                    dtype=np.int64,
                )
                return live, slot_bucket

            live, slot_bucket = live_buckets()
            # quiesce only when needed: the flush exists to empty the ready
            # queue of slots that are about to move; if no migrating flow
            # is READY, the queue holds no stake in this migration
            moving = np.isin(slot_bucket, np.asarray(buckets, np.int64))
            if (table.ctrl["state"][live[moving]] == 2).any():
                recs = src_rt.dispatcher.flush_queue(now, "migrate")
                for rec in recs:
                    rec.shard = src
                if recs:
                    records.setdefault(src, []).extend(recs)
                # the flush recycles fully-closed READY flows
                # (`mark_predicted`), so the pre-flush snapshot may list
                # freed slots — migrating one would double-free it and
                # index key 0 on the destination; re-snapshot
                live, slot_bucket = live_buckets()
            for b in buckets:
                dst = moves[b]
                slots = live[slot_bucket == b]
                dst_table = self.shards[dst].table
                # both of move_slot's vetoes are prechecked for the whole
                # bucket, so a bucket moves atomically or not at all — a
                # half-moved bucket would strand flows on whichever side
                # the RETA entry does not point to
                if len(dst_table._free) < slots.size:
                    report["buckets_skipped"] += 1
                    continue
                if slots.size and (
                    dst_table._probe_many(
                        table.ctrl["key"][slots].astype(np.uint64)
                    ) >= 0
                ).any():
                    # identity-hash collision with a live destination flow
                    # (~2^-64): refuse the bucket rather than double-track
                    report["buckets_skipped"] += 1
                    continue
                for s in slots:
                    if move_slot(table, dst_table, int(s)) < 0:
                        # unreachable: both vetoes prechecked above
                        raise RuntimeError(
                            "bucket migration veto raced the precheck")
                report["flows_migrated"] += int(slots.size)
                if slots.size:
                    report["flows_out"][src] = (
                        report["flows_out"].get(src, 0) + int(slots.size))
                    report["flows_in"][dst] = (
                        report["flows_in"].get(dst, 0) + int(slots.size))
                self.indirection[b] = dst
                report["buckets_moved"] += 1
        return report

    def hot_swap(self, pipeline: ServingPipeline, now: float) -> dict:
        """Zero-downtime pipeline replacement across the fleet.

        Swaps shard by shard (each worker quiesces and swaps on its own —
        a real fleet staggers this so capacity never halves); the shared
        pipeline handle flips last. Returns {shard: quiesce/ready flush
        records} for the replay clock."""
        out: dict[int, list[BatchRecord]] = {}
        for i, rt in enumerate(self.shards):
            recs = rt.hot_swap(pipeline, now)
            for rec in recs:
                rec.shard = i
            if recs:
                out[i] = recs
        self.pipeline = pipeline
        return out

    # -- facade --------------------------------------------------------------

    @property
    def results(self) -> dict:
        """Merged flow_id -> prediction map. Shards partition the flow
        space, so the union is collision-free by construction."""
        out: dict = {}
        for rt in self.shards:
            out.update(rt.results)
        return out

    @property
    def metrics(self) -> AggregateMetrics:
        return AggregateMetrics([rt.metrics for rt in self.shards],
                                active=list(self.active))

    def ingest_packets(
        self,
        key,
        now,
        rel_ts,
        size,
        direction,
        ttl,
        winsize,
        flags_byte,
        proto,
        s_port,
        d_port,
        flow_id,
        fin,
        *,
        shard: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, list[BatchRecord]]:
        """Steered block ingest: split a delivery-ordered packet block by
        `shard` (per-packet shard ids, e.g. `steer_stream(...)[fid]`) and
        drive each sub-block through its worker.

        Within a shard, delivery order is preserved (stable partition),
        which is all correctness needs — packets of one flow never cross
        shards. Returned records carry `shard` and block-global
        `flush_idx`; records are grouped by shard, not interleaved in
        global time (the shards are independent clocks).
        """
        shard = np.asarray(shard)
        now = np.asarray(now, np.float64)
        B = len(now)
        statuses = np.zeros(B, np.uint8)
        accumulated = np.zeros(B, bool)
        frozen: Optional[np.ndarray] = None
        recs: list[BatchRecord] = []
        for i, rt in enumerate(self.shards):
            idx = np.flatnonzero(shard == i)
            if not idx.size:
                continue
            st, acc, sub = rt.ingest_packets(
                np.asarray(key)[idx],
                now[idx],
                np.asarray(rel_ts)[idx],
                np.asarray(size)[idx],
                np.asarray(direction)[idx],
                np.asarray(ttl)[idx],
                np.asarray(winsize)[idx],
                np.asarray(flags_byte)[idx],
                np.asarray(proto)[idx],
                np.asarray(s_port)[idx],
                np.asarray(d_port)[idx],
                np.asarray(flow_id)[idx],
                np.asarray(fin)[idx],
            )
            statuses[idx] = st
            accumulated[idx] = acc
            if rt.last_frozen_mask is not None:
                if frozen is None:
                    frozen = np.zeros(B, bool)
                frozen[idx] = rt.last_frozen_mask
            for rec in sub:
                rec.shard = i
                if rec.flush_idx >= 0:
                    rec.flush_idx = int(idx[rec.flush_idx])
                recs.append(rec)
        self.last_frozen_mask = frozen
        return statuses, accumulated, recs

    def ingest_steered(
        self,
        key,
        now,
        rel_ts,
        size,
        direction,
        ttl,
        winsize,
        flags_byte,
        proto,
        s_port,
        d_port,
        flow_id,
        fin,
        *,
        bucket: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, list[BatchRecord]]:
        """Block ingest steered by RETA bucket rather than final shard id.

        This is the control-plane data path: the caller supplies each
        packet's *bucket* (`sym_hash & (INDIRECTION_SIZE - 1)`), the
        current indirection table resolves the shard, and the key->bucket
        ledger is updated so a later migration can find the flows a
        rewritten entry strands. Callers that steer with a frozen table
        can keep using `ingest_packets(shard=...)`; dynamic rebalancing
        requires this entry point (or an equivalent `note_steering`
        call), since buckets are otherwise unrecoverable."""
        bucket = np.asarray(bucket, np.int64)
        self.note_steering(np.asarray(key), bucket)
        return self.ingest_packets(
            key, now, rel_ts, size, direction, ttl, winsize, flags_byte,
            proto, s_port, d_port, flow_id, fin,
            shard=self.indirection[bucket],
        )

    def poll(self, now: float) -> list[BatchRecord]:
        """Periodic maintenance on every shard (idle eviction, timeouts)."""
        recs: list[BatchRecord] = []
        for i, rt in enumerate(self.shards):
            for rec in rt.poll(now):
                rec.shard = i
                recs.append(rec)
        return recs

    def drain(self, now: float) -> list[BatchRecord]:
        """End of stream: drain every shard's table and pending window."""
        recs: list[BatchRecord] = []
        for i, rt in enumerate(self.shards):
            for rec in rt.drain(now):
                rec.shard = i
                recs.append(rec)
        return recs
