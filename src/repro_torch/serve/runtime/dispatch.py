"""Micro-batched dispatch: shape-bucketed, double-buffered (DESIGN.md §6).

Port of `repro.serve.runtime.dispatch`. Between the flow table and the
serving pipeline sits a queueing/batching layer with explicit policies
(InferLine's lesson applies unchanged to traffic pipelines):

- **Shape bucketing.** Batches are padded up to power-of-two buckets in
  ``[min_bucket, max_batch]``, so at most ``log2(max_batch / min_bucket)
  + 1`` batch shapes exist over any run. The reference needs this to bound
  jit compiles; here no kernel is compiled per shape, but the bucket is
  still what the replay clock charges (`ServiceModel.bucket_ns` is
  calibrated per bucket) and what the staging arenas are sized by, so the
  port keeps the policy exactly. Padding rows have ``flow_len == 0``, so
  every masked reduction sees an empty flow; their predictions are
  discarded.

- **Double-buffered async submit.** ``predict_async`` queues the batch's
  copies and kernels on the card and returns the unresolved probabilities
  tensor; the dispatcher keeps up to ``max_pending`` batches in flight and
  only blocks (``finalize``) when the window is full.

Staging (DESIGN.md §7): the ready queue is an array-backed FIFO drained by
slicing, and each shape bucket owns ``max_pending + 1`` preallocated
**staging arenas**, `TrafficDataset`s reused round-robin across flushes,
with flags staged as the uint8 the kernels take. When the pipeline runs on
a CUDA device the arenas are numpy views of pinned host memory, so the
batch's host-to-device copies run asynchronously on the stream; each
arena then carries a CUDA event recorded after its batch was submitted,
and `_arena` waits on it before handing the arena out again. The rotation
alone implies that the copies ran (an arena comes back only after
`max_pending` further submissions, each of which retired an older batch);
the event makes it explicit. On the CPU the arenas are plain numpy arrays.

Flushes trigger on depth (``max_batch`` flows ready), on timeout (oldest
ready flow waited ``flush_timeout_s``), or on drain.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from ...traffic.extraction import (
    AGG_WIDTH,
    emit_agg_features,
    plan_is_incremental,
    stats_plan,
)
from ...traffic.pipeline import ServingPipeline
from ...traffic.synth import TrafficDataset
from .flow_table import FlowStatus, FlowTable, move_slot
from .metrics import RuntimeMetrics

__all__ = [
    "BatchRecord",
    "MicroBatchDispatcher",
    "ReuseConfig",
    "StreamingRuntime",
    "next_bucket",
]


@dataclasses.dataclass(frozen=True)
class ReuseConfig:
    """Drift-gated prediction reuse for long-lived flows (DESIGN.md §12).

    A PREDICTED flow that keeps receiving packets is *frozen*: ingest
    updates only its incremental aggregates, and every ``refresh_every``
    packets the dispatcher re-emits its feature vector from those
    aggregates and compares it against the anchor snapped at
    classification time. The flow is re-inferred only when the relative
    drift of any feature exceeds ``drift_threshold``; otherwise the cached
    prediction is reused. ``drift_threshold == 0`` forces re-inference at
    every refresh — predictions stay bit-identical to the non-reuse path
    (first prediction wins either way; refreshes land in
    ``live_predictions``, never in ``results``).
    """

    enabled: bool = True
    drift_threshold: float = 0.05
    refresh_every: int = 64


def next_bucket(n: int, min_bucket: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, clamped to [min_bucket, max_batch]."""
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_batch)


def _timeout_boundary(t: np.ndarray, lo: int, hi: int, ref: float,
                      timeout: float) -> int:
    """First index k in [lo, hi) where the scalar flush predicate
    ``t[k] - ref >= timeout`` holds, or hi if none.

    searchsorted locates ~the threshold, then two nudges land on the exact
    float boundary of the *subtraction* form the per-packet cadence
    evaluates (which can differ from ``t >= ref + timeout`` by one ulp).
    The single source of this boundary: both the flush scan and the
    sub-block bound must agree on it or block ingest loses bit-exactness.
    """
    k = lo + int(np.searchsorted(t[lo:hi], ref + timeout, side="left"))
    while k > lo and t[k - 1] - ref >= timeout:
        k -= 1
    while k < hi and t[k] - ref < timeout:
        k += 1
    return k


class _ReadyQueue:
    """Array-backed FIFO of (slot, ready_ts): bulk push, sliced drain.

    Replaces the deque of tuples: a flush drains n entries with two slice
    copies instead of n poplefts, and enqueue accepts whole blocks. The
    backing arrays grow geometrically and compact in place when the live
    span has drifted to the tail.
    """

    __slots__ = ("_slot", "_ready", "_head", "_tail")

    def __init__(self, cap: int = 1024):
        self._slot = np.empty(cap, np.int64)
        self._ready = np.empty(cap, np.float64)
        self._head = 0
        self._tail = 0

    def __len__(self) -> int:
        return self._tail - self._head

    def head_ready(self) -> float:
        return float(self._ready[self._head])

    def _reserve(self, k: int) -> None:
        cap = self._slot.size
        n = self._tail - self._head
        if self._tail + k <= cap:
            return
        if n + k <= cap // 2:  # plenty of room once compacted
            new_cap = cap
        else:
            new_cap = cap
            while new_cap < 2 * (n + k):
                new_cap *= 2
        slot = np.empty(new_cap, np.int64)
        ready = np.empty(new_cap, np.float64)
        slot[:n] = self._slot[self._head:self._tail]
        ready[:n] = self._ready[self._head:self._tail]
        self._slot, self._ready = slot, ready
        self._head, self._tail = 0, n

    def push(self, slot: int, ready_ts: float) -> None:
        self._reserve(1)
        self._slot[self._tail] = slot
        self._ready[self._tail] = ready_ts
        self._tail += 1

    def push_many(self, slots: np.ndarray, ready_ts: np.ndarray) -> None:
        k = len(slots)
        self._reserve(k)
        self._slot[self._tail:self._tail + k] = slots
        self._ready[self._tail:self._tail + k] = ready_ts
        self._tail += k

    def pop_many(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        h = self._head
        slots = self._slot[h:h + k].copy()
        ready = self._ready[h:h + k].copy()
        self._head = h + k
        if self._head == self._tail:
            self._head = self._tail = 0
        return slots, ready


@dataclasses.dataclass
class _Arena:
    """One staging batch of a bucket. With `copied` set, the arrays of `ds`
    are views of the pinned tensors in `pinned` (held here so the memory
    lives as long as the views), and `copied` is recorded on the stream
    after each submission that reads them."""

    ds: TrafficDataset
    pinned: tuple = ()
    copied: Optional[torch.cuda.Event] = None


def _new_arena(bucket: int, P: int, device: torch.device) -> _Arena:
    """Zero-filled staging arrays for `bucket` flows of `P` packets; in
    pinned host memory when `device` is a CUDA device."""
    shapes = {
        "ts": ((bucket, P), torch.float32),
        "size": ((bucket, P), torch.float32),
        "direction": ((bucket, P), torch.uint8),
        "ttl": ((bucket, P), torch.float32),
        "winsize": ((bucket, P), torch.float32),
        "flags": ((bucket, P, 8), torch.uint8),
        "flow_len": ((bucket,), torch.int32),
        "proto": ((bucket,), torch.float32),
        "s_port": ((bucket,), torch.float32),
        "d_port": ((bucket,), torch.float32),
        "label": ((bucket,), torch.int32),
    }
    pin = device.type == "cuda"
    tensors = {k: torch.zeros(shape, dtype=dt, pin_memory=pin)
               for k, (shape, dt) in shapes.items()}
    ds = TrafficDataset(**{k: t.numpy() for k, t in tensors.items()},
                        name="stream-arena")
    if not pin:
        return _Arena(ds)
    return _Arena(ds, tuple(tensors.values()), torch.cuda.Event())


@dataclasses.dataclass
class BatchRecord:
    """One flushed micro-batch; `preds` is filled when the batch resolves."""

    flow_ids: np.ndarray       # (n_real,) external flow ids
    ready_ts: np.ndarray       # (n_real,) when each flow became dispatchable
    flush_ts: float            # when the batch left the queue
    bucket: int                # padded batch size actually submitted
    n_real: int
    reason: str                # "full" | "timeout" | "drain" | "migrate" | "swap" | "refresh"
    flush_idx: int = -1        # triggering packet index within an ingest block
    shard: int = 0             # owning worker under a ShardedRuntime
    n_checked: int = 0         # reuse: frozen flows whose drift was evaluated
    n_anchor: int = 0          # reuse: anchors snapped/re-snapped by this batch
    probs: Optional[torch.Tensor] = None   # in-flight (N, K) probabilities
    preds: Optional[np.ndarray] = None
    # flow ids sampled into the trace (the replay clock closes their
    # lifecycle spans at this batch's service-completion edge); None when
    # tracing is off or no flow in the batch was sampled
    trace_ids: Optional[np.ndarray] = None


class MicroBatchDispatcher:
    def __init__(
        self,
        table: FlowTable,
        pipeline: ServingPipeline,
        *,
        max_batch: int = 256,
        min_bucket: int = 8,
        flush_timeout_s: float = 0.05,
        max_pending: int = 2,
        execute: bool = True,
        metrics: RuntimeMetrics | None = None,
        reuse: ReuseConfig | None = None,
    ):
        if max_batch & (max_batch - 1) or min_bucket & (min_bucket - 1):
            raise ValueError("max_batch and min_bucket must be powers of two")
        self.table = table
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self.flush_timeout_s = flush_timeout_s
        self.max_pending = max_pending
        self.execute = execute
        self.metrics = metrics if metrics is not None else table.metrics
        self.reuse = reuse  # active (already plan-gated) config, or None
        self._agg_plan = (
            stats_plan(pipeline.rep.features) if reuse is not None else None)
        self._agg_arenas: dict[int, tuple] = {}
        self._queue = _ReadyQueue()
        self._pending: deque[BatchRecord] = deque()
        self._arenas: dict[int, list[_Arena]] = {}
        self._arena_turn: dict[int, int] = {}
        self.results: dict[int, object] = {}  # flow_id -> predicted class
        # refreshed predictions for still-live frozen flows: `results` keeps
        # first-prediction-wins semantics (bit-identical to non-reuse runs),
        # so drift-triggered re-inferences land here instead
        self.live_predictions: dict[int, object] = {}
        self.records: list[BatchRecord] = []
        # observability hooks (serve/obs): attribute injection, off
        # by default — the untraced hot path pays one `is not None` test
        self.tracer = None          # obs.Tracer
        self.drift = None           # obs.DriftMonitor
        self.trace_pid = 0          # shard id for trace process grouping

    # -- queue ---------------------------------------------------------------

    def enqueue(self, slot: int, ready_ts: float) -> None:
        self._queue.push(slot, ready_ts)

    def maybe_flush(self, now: float) -> list[BatchRecord]:
        """Flush every full batch, then at most one timeout batch."""
        out = []
        while len(self._queue) >= self.max_batch:
            out.append(self._flush(now, "full"))
        if len(self._queue) and now - self._queue.head_ready() >= self.flush_timeout_s:
            out.append(self._flush(now, "timeout"))
        return out

    def ingest_ready(
        self, statuses: np.ndarray, slots: np.ndarray, t: np.ndarray
    ) -> list[BatchRecord]:
        """Bulk equivalent of per-packet enqueue + `maybe_flush` over an
        ingest block: enqueues READY flows at their packet times and fires
        exactly the flushes (same order, reasons, and `now` values) the
        scalar cadence would. `t` must be nondecreasing (delivery order);
        each record carries `flush_idx`, the in-block index of the packet
        whose arrival triggered it (the replay clock charges the submit
        there)."""
        recs: list[BatchRecord] = []
        ready = (statuses == int(FlowStatus.READY)) | (
            statuses == int(FlowStatus.READY_EOF))
        lo = 0
        for j in np.flatnonzero(ready):
            j = int(j)
            self._timeout_scan(t, lo, j, recs)
            self._queue.push(int(slots[j]), float(t[j]))
            tj = float(t[j])
            while len(self._queue) >= self.max_batch:
                recs.append(self._flush(tj, "full", flush_idx=j))
            if len(self._queue) and tj - self._queue.head_ready() >= self.flush_timeout_s:
                recs.append(self._flush(tj, "timeout", flush_idx=j))
            lo = j + 1
        self._timeout_scan(t, lo, len(t), recs)
        return recs

    def _timeout_scan(self, t, lo: int, hi: int, recs: list) -> None:
        """Fire the timeout flushes that packets [lo, hi) would trigger:
        per packet, at most one flush of the oldest-ready batch."""
        while lo < hi and len(self._queue):
            k = _timeout_boundary(t, lo, hi, self._queue.head_ready(),
                                  self.flush_timeout_s)
            if k >= hi:
                return
            recs.append(self._flush(float(t[k]), "timeout", flush_idx=k))
            lo = k + 1

    def drain(self, now: float) -> list[BatchRecord]:
        out = []
        while len(self._queue):
            out.append(self._flush(now, "drain"))
        while self._pending:
            self._resolve(self._pending.popleft())
        return out

    def flush_queue(self, now: float, reason: str) -> list[BatchRecord]:
        """Quiesce the ready queue: flush everything queued, keep running.

        The control plane calls this before a RETA migration ("migrate")
        or a pipeline hot-swap ("swap"): afterwards no table slot is
        referenced by the queue, so flow state can move between tables
        without dangling slot ids. Unlike `drain` the pending window stays
        open — in-flight batches hold no table references (flow ids are
        copied at flush) and resolve on their own schedule.
        """
        out = []
        while len(self._queue):
            out.append(self._flush(now, reason))
        return out

    def resolve_pending(self) -> None:
        """Block until every in-flight batch has resolved (hot-swap: the
        old pipeline must finish its submitted work before it is dropped,
        or its staging arenas could be retired while a queued copy still
        reads them)."""
        while self._pending:
            self._resolve(self._pending.popleft())

    # -- flush mechanics -----------------------------------------------------

    def _flush(self, now: float, reason: str, flush_idx: int = -1) -> BatchRecord:
        n = min(len(self._queue), self.max_batch)
        slots, ready = self._queue.pop_many(n)
        bucket = next_bucket(n, self.min_bucket, self.max_batch)

        m = self.metrics
        m.batches += 1
        m.batch_occupancy.append(n / bucket)
        m.shapes_seen.add((bucket, self.table.pkt_depth))
        m.flows_predicted += n
        tn = getattr(self.pipeline, "n_tenants", 0)
        if tn:
            # one fused batch answers every tenant: each tenant's series
            # advances by the full batch (per-model attribution, §15.4)
            for t_i in range(tn):
                m.tenant_predictions[t_i] = (
                    m.tenant_predictions.get(t_i, 0) + n)
        if reason == "full":
            m.flushes_full += 1
        elif reason == "timeout":
            m.flushes_timeout += 1
        elif reason == "migrate":
            m.flushes_migrate += 1
        elif reason == "swap":
            m.flushes_swap += 1
        else:
            m.flushes_drain += 1

        rec = BatchRecord(
            flow_ids=self.table.ctrl["flow_id"][slots].copy(),
            ready_ts=ready,
            flush_ts=now,
            bucket=bucket,
            n_real=n,
            reason=reason,
            flush_idx=flush_idx,
        )
        tr = self.tracer
        if tr is not None and tr.enabled:
            # sampled flow lifecycles: begin at first packet, milestones at
            # ready and flush (vectorized per batch; slots still hold their
            # ctrl rows — mark_predicted below may recycle them). The
            # replay clock closes these spans at the batch's service edge.
            keep = tr.sample_mask(rec.flow_ids)
            if keep.any():
                ids = rec.flow_ids[keep]
                pid = self.trace_pid
                tr.flow_begin(ids, self.table.ctrl["first_ts"][slots[keep]],
                              pid=pid)
                tr.flow_mark("ready", ids, ready[keep], pid=pid)
                tr.flow_mark(f"flush.{reason}", ids,
                             np.full(len(ids), now), pid=pid)
                rec.trace_ids = ids
        if self.execute:
            arena = self._arena(bucket)
            ds = self._fill(arena.ds, slots)
            if self.drift is not None:
                # covariate-shift sketch: three cheap per-flow summaries
                # reduced batch-at-once from the staged arena (obs.drift)
                L = np.asarray(ds.flow_len[:n], np.float64)
                Lc = np.maximum(L, 1.0)
                self.drift.note_features(np.stack([
                    L,
                    ds.size[:n].sum(axis=1, dtype=np.float64) / Lc,
                    ds.ts[:n].max(axis=1).astype(np.float64),
                ], axis=1))
            # retire the oldest in-flight batch before submitting a new one:
            # at most `max_pending` batches overlap ingest at any time
            while len(self._pending) >= self.max_pending:
                self._resolve(self._pending.popleft())
            rec.probs = self.pipeline.predict_async(ds)
            if arena.copied is not None:
                arena.copied.record(
                    torch.cuda.current_stream(self.pipeline.device))
            self._pending.append(rec)
        if self.reuse is not None and n:
            # snap the drift anchor at classification time, before
            # mark_predicted: slots that recycle (FIN already seen) get the
            # anchor cleared again by `_clear_slot`, so only flows that
            # actually stay resident carry one
            self._snap_anchors(slots)
            rec.n_anchor = n
        # slots are safe to reuse once gathered (or immediately in timing-only
        # mode): finished flows recycle now, the rest become PREDICTED
        self.table.mark_predicted(slots)
        self.records.append(rec)
        return rec

    # -- drift-gated prediction reuse (DESIGN.md §12) ------------------------

    def _agg_features(self, slots: np.ndarray) -> np.ndarray:
        """Feature matrix (n, F) float32 emitted from the incremental
        aggregates — same `stats_plan` columns the window path computes."""
        t = self.table
        if t._abuf_n and t._ab_has[slots].any():
            # packets of these slots may still be staged in the fold arena
            # (every packet of a reuse table defers): their aggregates must
            # be current before anchoring or drift-checking against them
            t.flush_agg()
        cols = emit_agg_features(
            self._agg_plan, t.agg[slots],
            proto=t.proto[slots], s_port=t.s_port[slots],
            d_port=t.d_port[slots],
        )
        return np.stack([np.asarray(c, np.float32) for c in cols], axis=1)

    def _snap_anchors(self, slots: np.ndarray) -> np.ndarray:
        feats = self._agg_features(slots)
        t = self.table
        t.anchor[slots] = feats
        t.anchor_valid[slots] = True
        return feats

    def _agg_arena(self, bucket: int) -> tuple:
        """Padded staging block for `predict_agg`, float64 on the host as
        the table keeps it (`predict_agg` rounds it to float32 and copies
        it synchronously). Pad rows stay all-zero: a zero aggregate row has
        every count at 0, so the emitter's masked reductions produce a
        well-defined all-zero feature row (discarded after finalize). No
        rotation: refresh batches resolve synchronously."""
        ar = self._agg_arenas.get(bucket)
        if ar is None:
            ar = (
                np.zeros((bucket, AGG_WIDTH), np.float64),
                np.zeros(bucket, np.float32),
                np.zeros(bucket, np.float32),
                np.zeros(bucket, np.float32),
            )
            self._agg_arenas[bucket] = ar
        return ar

    def flush_refresh_all(
        self, slots: np.ndarray, now: float
    ) -> list[BatchRecord]:
        """Chunk a refresh backlog to `max_batch`-sized batches. The drift
        decision is per-slot, so splitting never changes which flows
        re-infer — it only keeps each batch inside the arena/bucket bound
        (a cadence burst can make more flows due than one batch holds)."""
        return [
            self.flush_refresh(slots[i:i + self.max_batch], now)
            for i in range(0, len(slots), self.max_batch)
        ]

    def flush_refresh(self, slots: np.ndarray, now: float) -> BatchRecord:
        """Evaluate drift for frozen flows whose refresh cadence fired and
        re-infer only the ones past the threshold (threshold 0 ⇒ all).

        Refreshed predictions go to `live_predictions` — `results` keeps
        first-prediction-wins, so predictions are bit-identical to the
        non-reuse path at any threshold. Anchors re-snap for every
        re-inferred flow in both execute modes, keeping the drift decision
        sequence execute-invariant (the replay's timing-only admission
        probe must walk the same refresh schedule as the executing run)."""
        cfg = self.reuse
        t = self.table
        k = len(slots)
        feats = self._agg_features(slots)
        anc = t.anchor[slots]
        valid = t.anchor_valid[slots]
        denom = np.maximum(np.abs(anc, dtype=np.float64), 1e-6)
        drift = (np.abs(feats.astype(np.float64) - anc) / denom).max(axis=1)
        re_inf = (~valid) | (drift >= cfg.drift_threshold)
        n_re = int(re_inf.sum())

        m = self.metrics
        m.reuse_hits += k - n_re
        if cfg.drift_threshold <= 0.0:
            m.forced_reinfer += n_re
        else:
            m.refreshes += n_re

        fids = t.ctrl["flow_id"][slots].copy()
        tr = self.tracer
        if tr is not None and tr.enabled:
            keep = tr.sample_mask(fids)
            pid = self.trace_pid
            for name, mask in (("reuse", keep & ~re_inf), ("refresh", keep & re_inf)):
                if mask.any():
                    tr.flow_mark(name, fids[mask],
                                 np.full(int(mask.sum()), now), pid=pid)

        bucket = next_bucket(n_re, self.min_bucket, self.max_batch) if n_re else 0
        rec = BatchRecord(
            flow_ids=fids[re_inf],
            ready_ts=np.full(n_re, now),
            flush_ts=now,
            bucket=bucket,
            n_real=n_re,
            reason="refresh",
            n_checked=k,
            n_anchor=n_re,
        )
        if n_re:
            sl_re = slots[re_inf]
            if self.execute and self.pipeline.supports_agg:
                agg, proto, sp, dp = self._agg_arena(bucket)
                agg[:n_re] = t.agg[sl_re]
                agg[n_re:] = 0.0
                proto[:n_re] = t.proto[sl_re]
                proto[n_re:] = 0.0
                sp[:n_re] = t.s_port[sl_re]
                sp[n_re:] = 0.0
                dp[:n_re] = t.d_port[sl_re]
                dp[n_re:] = 0.0
                probs = self.pipeline.predict_agg(agg, proto, sp, dp)
                preds = self.pipeline.finalize(probs)[:n_re]
                rec.preds = preds
                for fid, p in zip(rec.flow_ids, preds):
                    self.live_predictions[int(fid)] = p
            # re-anchor at the refreshed state so the next drift comparison
            # is against what was (or would have been) classified now
            self._snap_anchors(sl_re)
        self.records.append(rec)
        return rec

    def _arena(self, bucket: int) -> _Arena:
        """The next preallocated staging batch of this shape bucket, reused
        across flushes; pinned when the pipeline runs on a CUDA device.

        ``max_pending + 1`` arenas rotate per bucket, so an arena comes up
        for reuse only after `max_pending` further submissions, by which
        point its batch has left the pending window. A pinned arena's
        copies run on the stream after `predict_async` returns, so before
        handing one out this waits on the event recorded after its last
        submission: no queued copy can still read what the caller is about
        to overwrite."""
        ring = self._arenas.get(bucket)
        if ring is None:
            ring = [_new_arena(bucket, self.table.pkt_depth,
                               self.pipeline.device)
                    for _ in range(self.max_pending + 1)]
            self._arenas[bucket] = ring
            self._arena_turn[bucket] = 0
        turn = self._arena_turn[bucket]
        self._arena_turn[bucket] = (turn + 1) % len(ring)
        arena = ring[turn]
        if arena.copied is not None:
            arena.copied.synchronize()
        return arena

    def gather(self, slots: np.ndarray, bucket: int) -> TrafficDataset:
        """Fill this bucket's next staging arena from table rows and return
        it (allocation-free: every destination is preallocated per
        bucket). The caller submits it before the bucket's arenas come
        round again."""
        return self._fill(self._arena(bucket).ds, slots)

    def _fill(self, ds: TrafficDataset, slots: np.ndarray) -> TrafficDataset:
        t = self.table
        n = len(slots)
        for dst, src in (
            (ds.ts, t.ts), (ds.size, t.size), (ds.direction, t.direction),
            (ds.ttl, t.ttl), (ds.winsize, t.winsize), (ds.flags, t.flags),
        ):
            np.take(src, slots, axis=0, out=dst[:n])
            dst[n:] = 0
        ds.flow_len[:n] = t.ctrl["count"][slots]
        ds.flow_len[n:] = 0
        for dst, src in (
            (ds.proto, t.proto), (ds.s_port, t.s_port), (ds.d_port, t.d_port),
        ):
            np.take(src, slots, out=dst[:n])
            dst[n:] = 0
        return ds

    def _resolve(self, rec: BatchRecord) -> None:
        dm = self.drift
        conf = None
        if dm is not None:
            # top-class vote share = prediction confidence; materialized
            # here (one host copy per batch) only when drift is attached
            pnp = rec.probs[: rec.n_real].cpu().numpy()
            sl = getattr(self.pipeline, "drift_prob_slice", None)
            if sl is not None:
                # multi-tenant lanes: confidence over tenant 0's lane only
                # — mixing per-tenant class spaces in one histogram would
                # make the drift signal meaningless (DESIGN.md §15.4)
                pnp = pnp[:, sl]
            conf = pnp.max(axis=1) / np.maximum(
                pnp.sum(axis=1), 1e-12)
        preds = self.pipeline.finalize(rec.probs)[: rec.n_real]
        rec.preds = preds
        rec.probs = None
        if dm is not None:
            dm.note_predictions(
                preds[:, 0] if preds.ndim == 2 else preds, conf)
        for fid, p in zip(rec.flow_ids, preds):
            # first prediction wins: a re-tenancy of the same 5-tuple (e.g.
            # a stray final ACK after close) must not overwrite the real
            # classification with a tail-fragment one
            if int(fid) in self.results:
                self.metrics.duplicate_predictions += 1
            else:
                self.results[int(fid)] = p


class StreamingRuntime:
    """Facade: flow table + dispatcher behind block and per-packet ingest.

    `ingest_packets` is the primary API: it feeds a delivery-ordered packet
    block through `FlowTable.observe_batch` and fires exactly the flushes
    the per-packet cadence would. `ingest_packet` is the scalar
    compatibility wrapper over the same queue/flush machinery.

    Owns no clock — callers pass `now` (wall time in live use, virtual time
    under the replay), which is what makes zero-loss search
    deterministic and replayable.
    """

    def __init__(
        self,
        pipeline: ServingPipeline,
        *,
        capacity: int = 2048,
        max_batch: int = 256,
        min_bucket: int = 8,
        flush_timeout_s: float = 0.05,
        idle_timeout_s: float = 60.0,
        max_pending: int = 2,
        execute: bool = True,
        pkt_depth: Optional[int] = None,
        load_factor: float = 0.5,
        rebuild_tombstone_frac: float = 0.25,
        reuse: ReuseConfig | None = None,
    ):
        self.pipeline = pipeline
        depth = pkt_depth if pkt_depth is not None else pipeline.rep.depth
        self.metrics = RuntimeMetrics()
        # the requested config is kept verbatim (hot_swap re-gates it on the
        # new plan); the *active* config additionally requires every feature
        # to be incrementally maintainable (no median-style stats)
        self.reuse_cfg = reuse
        active = self._gate_reuse(pipeline, reuse)
        self.table = FlowTable(
            capacity, depth, idle_timeout_s=idle_timeout_s,
            load_factor=load_factor,
            rebuild_tombstone_frac=rebuild_tombstone_frac,
            metrics=self.metrics,
            track_agg=active is not None,
            reuse=active is not None,
            refresh_every=active.refresh_every if active is not None else 0,
            anchor_dim=len(pipeline.rep.features) if active is not None else 0,
        )
        self.dispatcher = MicroBatchDispatcher(
            self.table,
            pipeline,
            max_batch=max_batch,
            min_bucket=min_bucket,
            flush_timeout_s=flush_timeout_s,
            max_pending=max_pending,
            execute=execute,
            metrics=self.metrics,
            reuse=active,
        )
        # per-packet frozen-fast-path mask of the last `ingest_packets`
        # block (None when reuse is off): the replay clock reads it to
        # charge frozen packets their cheaper aggregate-update cost
        self.last_frozen_mask: Optional[np.ndarray] = None

    @staticmethod
    def _gate_reuse(pipeline: ServingPipeline,
                    reuse: ReuseConfig | None) -> ReuseConfig | None:
        if reuse is None or not reuse.enabled:
            return None
        if not plan_is_incremental(stats_plan(pipeline.rep.features)):
            return None
        return reuse

    @property
    def results(self) -> dict:
        return self.dispatcher.results

    @property
    def flush_timeout_s(self) -> float:
        return self.dispatcher.flush_timeout_s

    def _sub_block_end(self, now: np.ndarray, lo: int) -> int:
        """Largest `hi` such that no flush can trigger before packet hi-1.

        A full flush needs the ready queue to reach `max_batch`, which takes
        at least (max_batch - len(queue)) READY packets; a timeout flush
        needs an arrival past head_ready + flush_timeout_s (head cannot get
        older mid-block, and a flow enqueued at t[p] >= t[lo] cannot time
        out before t[lo] + timeout does). Bounding sub-blocks this way pins
        every flush — and its table side effects (`mark_predicted`
        recycling) — to a sub-block's final packet, which is exactly where
        the per-packet cadence applies them."""
        disp = self.dispatcher
        B = len(now)
        hi = min(B, lo + (disp.max_batch - len(disp._queue)))
        ref = disp._queue.head_ready() if len(disp._queue) else float(now[lo])
        k = _timeout_boundary(now, lo, B, ref, disp.flush_timeout_s)
        return max(lo + 1, min(hi, k + 1))

    def ingest_packets(
        self, key, now, rel_ts, size, direction, ttl, winsize, flags_byte,
        proto, s_port, d_port, flow_id, fin,
    ) -> tuple[np.ndarray, np.ndarray, list[BatchRecord]]:
        """Ingest a delivery-ordered packet block (arrays of equal length).

        The block is processed in sub-blocks bounded so that a flush can
        only fire at a sub-block's final packet (`_sub_block_end`): flush
        side effects — PREDICTED marking and the slot recycling of closed
        flows — are therefore applied before any later packet is observed,
        keeping block ingest exact-equivalent to the per-packet cadence
        even under table pressure and same-block re-tenancy.

        Returns ``(statuses, accumulated, records)``: per-packet
        `FlowStatus` values, the per-packet payload/tracker cost class, and
        the micro-batches flushed while the block streamed in (each stamped
        with the triggering in-block packet index)."""
        now = np.asarray(now, np.float64)
        B = len(now)
        statuses = np.full(B, int(FlowStatus.TRACKED), np.uint8)
        accumulated = np.zeros(B, bool)
        frozen = np.zeros(B, bool) if self.table.reuse else None
        recs: list[BatchRecord] = []
        lo = 0
        while lo < B:
            hi = self._sub_block_end(now, lo)
            st, slots, acc = self.table.observe_batch(
                key[lo:hi], now[lo:hi], rel_ts[lo:hi], size[lo:hi],
                direction[lo:hi], ttl[lo:hi], winsize[lo:hi],
                flags_byte[lo:hi], proto[lo:hi], s_port[lo:hi],
                d_port[lo:hi], flow_id[lo:hi], fin[lo:hi],
            )
            statuses[lo:hi] = st
            accumulated[lo:hi] = acc
            if frozen is not None and self.table.last_frozen is not None:
                frozen[lo:hi] = self.table.last_frozen
            for rec in self.dispatcher.ingest_ready(st, slots, now[lo:hi]):
                rec.flush_idx += lo
                recs.append(rec)
            lo = hi
        self.last_frozen_mask = frozen
        if self.table.reuse and B:
            due = self.table.take_refresh_due()
            if due:
                for rec in self.dispatcher.flush_refresh_all(
                        np.asarray(due, np.int64), float(now[B - 1])):
                    rec.flush_idx = B - 1
                    recs.append(rec)
        return statuses, accumulated, recs

    def ingest_packet(
        self, key, now, rel_ts, size, direction, ttl, winsize, flags_byte,
        proto, s_port, d_port, flow_id, fin,
    ) -> tuple[FlowStatus, list[BatchRecord]]:
        status, slot = self.table.observe(
            key, now, rel_ts, size, direction, ttl, winsize, flags_byte,
            proto, s_port, d_port, flow_id, fin,
        )
        if status in (FlowStatus.READY, FlowStatus.READY_EOF):
            self.dispatcher.enqueue(slot, now)
        recs = self.dispatcher.maybe_flush(now)
        if self.table.reuse and self.table._refresh_due:
            due = self.table.take_refresh_due()
            if due:
                recs.extend(self.dispatcher.flush_refresh_all(
                    np.asarray(due, np.int64), now))
        return status, recs

    def poll(self, now: float) -> list[BatchRecord]:
        """Periodic maintenance: idle eviction + timeout flushes."""
        for slot in self.table.evict_idle(now):
            self.dispatcher.enqueue(slot, now)
        return self.dispatcher.maybe_flush(now)

    def hot_swap(self, pipeline: ServingPipeline, now: float) -> list[BatchRecord]:
        """Drain-and-swap to a new pipeline without dropping a packet
        (DESIGN.md §9.3).

        Protocol: (1) quiesce — every READY flow flushes through the *old*
        pipeline (it completed under the old configuration, so that is the
        configuration that classifies it) and the pending window resolves,
        so no computation still references the old table or arenas; (2) a
        fresh `FlowTable` + dispatcher are built at the new connection
        depth, sharing this runtime's metrics block so counters and
        latency history continue across the swap; (3) every live flow
        migrates via `move_slot` — ACTIVE flows keep accumulating into the
        new table (a flow whose accumulated prefix already meets the new
        depth becomes READY immediately), PREDICTED flows keep their
        close-tracking state so re-tenancy accounting survives the swap.

        The caller warms `pipeline` beforehand (`ServingPipeline.warm`);
        this method is pure state motion plus at most one round of quiesce
        flushes.
        """
        disp = self.dispatcher
        recs = disp.flush_queue(now, "swap")
        disp.resolve_pending()
        old = self.table
        depth = pipeline.rep.depth
        # reuse re-gates on the *new* plan: a swap onto a median-bearing
        # feature set silently degrades to full recomputation
        active = self._gate_reuse(pipeline, self.reuse_cfg)
        table = FlowTable(
            old.capacity, depth, idle_timeout_s=old.idle_timeout_s,
            load_factor=old.load_factor,
            rebuild_tombstone_frac=old.rebuild_tombstone_frac,
            metrics=self.metrics,
            track_agg=active is not None,
            reuse=active is not None,
            refresh_every=active.refresh_every if active is not None else 0,
            anchor_dim=len(pipeline.rep.features) if active is not None else 0,
        )
        new_disp = MicroBatchDispatcher(
            table, pipeline, max_batch=disp.max_batch,
            min_bucket=disp.min_bucket, flush_timeout_s=disp.flush_timeout_s,
            max_pending=disp.max_pending, execute=disp.execute,
            metrics=self.metrics, reuse=active,
        )
        # predictions, the flush log, and the observability hooks are
        # runtime-lifetime, not pipeline-lifetime: carry them over
        new_disp.results = disp.results
        new_disp.live_predictions = disp.live_predictions
        new_disp.records = disp.records
        new_disp.tracer = disp.tracer
        new_disp.drift = disp.drift
        new_disp.trace_pid = disp.trace_pid
        ready = []
        for s in np.nonzero(old.ctrl["state"] != 0)[0]:
            ns = move_slot(old, table, int(s))
            c = table.ctrl[ns]
            if c["state"] == 1 and c["count"] >= depth:
                c["state"] = 2  # READY under the new (deeper-or-equal) prefix
                c["ready_ts"] = now
                ready.append(ns)
        for ns in ready:
            new_disp.enqueue(ns, now)
        if table.anchor is not None:
            # anchors are feature vectors under the *old* plan: invalidate
            # them all so the first post-swap refresh re-infers and
            # re-snaps against the new feature set
            table.anchor_valid[:] = False
        self.table, self.dispatcher, self.pipeline = table, new_disp, pipeline
        recs.extend(new_disp.maybe_flush(now))
        return recs

    def drain(self, now: float) -> list[BatchRecord]:
        """End of stream: classify every flow still holding packets."""
        for slot in self.table.flush_all(now):
            self.dispatcher.enqueue(slot, now)
        return self.dispatcher.drain(now)
