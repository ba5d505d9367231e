"""Online flow table: preallocated dense per-flow packet state (DESIGN.md §6).

Port of `repro.serve.runtime.flow_table`,
unchanged but for its imports (numpy only).

Traffic Refinery's measurement holds here too: per-flow state management is
the dominant systems cost of a network-ML pipeline, so the table is laid
out for the extractor, not for the tracker. All packet payload lives in
preallocated dense ``(capacity, pkt_depth)`` arrays — the *same* layout the
batch ``TrafficDataset`` uses (DESIGN.md §3) — so dispatch is a row gather
with zero per-flow reshaping, and the serving pipeline's kernels run
unchanged on streaming state.

Components:

- a NumPy structured *control block* (key, state, counts, timestamps) —
  one row per slot;
- dense payload arrays (ts/size/direction/ttl/winsize/flags + 5-tuple
  metadata) capped at ``pkt_depth`` packets: CATO classifies at connection
  depth n, so packets past n never touch the payload, only the tracker;
- an open-addressed hash index (linear probing, stored-key verification,
  tombstone deletion) mapping 64-bit 5-tuple hashes to slots;
- a free list for O(1) slot recycling, idle-timeout eviction, and overflow
  (drop) accounting when the preallocated capacity is exhausted.

Timestamps stored in the payload are *flow-relative* float32 (first packet
= 0.0): absolute epoch seconds in float32 would lose the microsecond bits
the IAT features are made of.
"""
from __future__ import annotations

import enum

import numpy as np

from .metrics import RuntimeMetrics
from ...traffic.extraction import (
    AGG_CNT,
    AGG_DIR_STRIDE,
    AGG_FAM_BASE,
    AGG_FIRST_TS,
    AGG_FLAGS,
    AGG_HS_ACK,
    AGG_HS_SYN,
    AGG_HS_SYNACK,
    AGG_IAT_CNT,
    AGG_IAT_M2,
    AGG_IAT_MAX,
    AGG_IAT_MIN,
    AGG_IAT_SUM,
    AGG_LAST_TS,
    AGG_TS_MAX,
    AGG_TS_MIN,
    AGG_WIDTH,
    agg_init,
)
from ...traffic.synth import FLAG_NAMES

__all__ = [
    "FlowStatus",
    "FlowTable",
    "move_slot",
    "symmetric_tuple_hash64",
    "tuple_hash64",
]


_CTRL_DTYPE = np.dtype([
    ("key", np.uint64),        # 5-tuple hash (verified on probe)
    ("state", np.uint8),       # FREE / ACTIVE / READY / PREDICTED
    ("fin_mask", np.uint8),    # bit per direction; flow closed when == 0b11
    ("count", np.int32),       # packets accumulated into the payload (<= depth)
    ("seen", np.int32),        # all packets observed for the flow
    ("first_ts", np.float64),  # absolute arrival of first packet
    ("last_ts", np.float64),   # absolute arrival of latest packet
    ("ready_ts", np.float64),  # when the flow was queued for dispatch
    ("flow_id", np.int32),     # external id (dataset row) for result join
])


class FlowStatus(enum.IntEnum):
    """Outcome of `FlowTable.observe` for one packet."""

    TRACKED = 0        # payload or tracker updated, nothing to dispatch
    READY = 1          # flow just reached depth n -> queue for inference
    READY_EOF = 2      # flow closed (FIN both ways) before depth n -> queue
    CLOSED = 3         # close completed on a predicted flow -> slot recycled
    DROPPED = 4        # table full: packet of an untracked flow lost


# (256, 8) lookup: packed TCP-flag byte -> FLAG_NAMES-ordered uint8 vector.
_FLAG_LUT = ((np.arange(256, dtype=np.uint16)[:, None] >> np.arange(8)) & 1).astype(
    np.uint8
)

_SYN_BIT = FLAG_NAMES.index("syn")
_ACK_BIT = FLAG_NAMES.index("ack")
_AGG_BIG = 3.4e38  # same sentinel as the extraction emitter's _BIG

# stacked-row layouts for the block aggregate fold (`_agg_update_sorted`):
# handshake min-timestamp columns and per-direction family SUM offsets, in
# the row order the fold stacks values (bytes, winsize, ttl)
_HS_COLS = np.array([AGG_HS_SYN, AGG_HS_SYNACK, AGG_HS_ACK], dtype=np.int64)
_FAM_COLS = np.array(
    [AGG_FAM_BASE["bytes"], AGG_FAM_BASE["winsize"], AGG_FAM_BASE["ttl"]],
    dtype=np.int64,
)


_M64 = 0xFFFFFFFFFFFFFFFF


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


def tuple_hash64(s_ip: int, d_ip: int, s_port: int, d_port: int, proto: int) -> int:
    """64-bit 5-tuple hash: splitmix64 chained over two lossless words.

    Each word packs its fields without overlap (ips: 32+32 bits; ports +
    proto: 16+16+8 bits), so distinct 5-tuples collide only at the generic
    ~2^-64 hash-collision rate — never structurally.
    """
    w1 = ((s_ip & 0xFFFFFFFF) << 32) | (d_ip & 0xFFFFFFFF)
    w2 = ((proto & 0xFF) << 32) | ((s_port & 0xFFFF) << 16) | (d_port & 0xFFFF)
    h = _splitmix64(_splitmix64(w1) ^ w2)
    return h or 1  # 0 is reserved for "empty bucket"


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized `_splitmix64` over uint64 arrays (wrapping arithmetic)."""
    with np.errstate(over="ignore"):  # mod-2^64 wrap is the algorithm
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def symmetric_tuple_hash64(
    s_ip, d_ip, s_port, d_port, proto
) -> np.ndarray:
    """Direction-invariant 5-tuple hash: RSS-style symmetric steering key.

    The two endpoints are sorted (ip, then port) before packing, so the
    forward and reverse directions of a flow hash identically — the
    property NIC symmetric-RSS needs so both halves of a connection land
    on the same queue/worker. Accepts scalars or equal-length arrays;
    always returns a uint64 ndarray. Distinct from `tuple_hash64`, which
    is intentionally asymmetric (it is the flow-table identity key and
    must separate A->B from B->A when both are tracked)."""
    s_ip = np.asarray(s_ip, np.uint64)
    d_ip = np.asarray(d_ip, np.uint64)
    s_port = np.asarray(s_port, np.uint64)
    d_port = np.asarray(d_port, np.uint64)
    proto = np.asarray(proto, np.uint64)
    swap = (s_ip > d_ip) | ((s_ip == d_ip) & (s_port > d_port))
    lo_ip = np.where(swap, d_ip, s_ip)
    hi_ip = np.where(swap, s_ip, d_ip)
    lo_port = np.where(swap, d_port, s_port)
    hi_port = np.where(swap, s_port, d_port)
    w1 = ((lo_ip & np.uint64(0xFFFFFFFF)) << np.uint64(32)) | (
        hi_ip & np.uint64(0xFFFFFFFF)
    )
    w2 = (
        ((proto & np.uint64(0xFF)) << np.uint64(32))
        | ((lo_port & np.uint64(0xFFFF)) << np.uint64(16))
        | (hi_port & np.uint64(0xFFFF))
    )
    h = _splitmix64_np(_splitmix64_np(w1) ^ w2)
    return np.where(h == 0, np.uint64(1), h)


_EMPTY = -1      # bucket sentinel: never used
_TOMBSTONE = -2  # bucket sentinel: deleted, keep probing


class FlowTable:
    """Preallocated flow table; all storage is allocated once in __init__."""

    def __init__(
        self,
        capacity: int,
        pkt_depth: int,
        *,
        idle_timeout_s: float = 60.0,
        load_factor: float = 0.5,
        rebuild_tombstone_frac: float = 0.25,
        metrics: RuntimeMetrics | None = None,
        track_agg: bool = False,
        reuse: bool = False,
        refresh_every: int = 0,
        anchor_dim: int = 0,
        agg_buffer: int = 4096,
    ):
        if capacity <= 0 or pkt_depth <= 0:
            raise ValueError("capacity and pkt_depth must be positive")
        if not 0.0 < load_factor < 1.0:
            raise ValueError("load_factor must be in (0, 1)")
        if rebuild_tombstone_frac < 0.0:
            raise ValueError("rebuild_tombstone_frac must be >= 0")
        if load_factor + rebuild_tombstone_frac >= 1.0:
            # probe termination proof: live slots (<= n_buckets *
            # load_factor) plus un-rebuilt tombstones (<= n_buckets *
            # rebuild_tombstone_frac) must leave at least one EMPTY
            # bucket, or a probe miss on a full table never terminates
            raise ValueError(
                "load_factor + rebuild_tombstone_frac must be < 1.0 "
                "(open addressing needs a guaranteed empty bucket)"
            )
        self.capacity = capacity
        self.pkt_depth = pkt_depth
        self.idle_timeout_s = idle_timeout_s
        self.load_factor = load_factor
        self.rebuild_tombstone_frac = rebuild_tombstone_frac
        self.metrics = metrics if metrics is not None else RuntimeMetrics()

        self.ctrl = np.zeros(capacity, dtype=_CTRL_DTYPE)
        # dense payload, TrafficDataset layout (DESIGN.md §3)
        self.ts = np.zeros((capacity, pkt_depth), dtype=np.float32)
        self.size = np.zeros((capacity, pkt_depth), dtype=np.float32)
        self.direction = np.zeros((capacity, pkt_depth), dtype=np.uint8)
        self.ttl = np.zeros((capacity, pkt_depth), dtype=np.float32)
        self.winsize = np.zeros((capacity, pkt_depth), dtype=np.float32)
        self.flags = np.zeros((capacity, pkt_depth, 8), dtype=np.uint8)
        self.proto = np.zeros(capacity, dtype=np.float32)
        self.s_port = np.zeros(capacity, dtype=np.float32)
        self.d_port = np.zeros(capacity, dtype=np.float32)

        # incremental aggregate state (DESIGN.md §12): one float64 row of
        # running statistics per slot, updated on every ingest when enabled.
        # `reuse` additionally activates the frozen fast path for PREDICTED
        # flows and the seen-counter refresh cadence.
        self.track_agg = bool(track_agg or reuse)
        self.reuse = bool(reuse)
        self.refresh_every = int(refresh_every)
        self.anchor_dim = int(anchor_dim)
        if self.track_agg:
            self._agg_init = agg_init()
            self.agg = np.tile(self._agg_init, (capacity, 1))
        else:
            self._agg_init = None
            self.agg = None
        self.anchor = (
            np.zeros((capacity, anchor_dim), np.float32) if anchor_dim else None
        )
        self.anchor_valid = np.zeros(capacity, bool)
        # per-slot re-tenancy generation: a refresh scheduled for (slot, gen)
        # is dropped if the slot was cleared (gen bumped) before it drains
        self.gen = np.zeros(capacity, np.int64)
        self.refresh_pending = np.zeros(capacity, bool)
        self._refresh_due: list[tuple[int, int]] = []
        # per-packet frozen-class mask of the last observe_batch (reuse on):
        # the replay cost model charges these packets the frozen-path rate
        self.last_frozen: np.ndarray | None = None
        self.last1_frozen = False
        # deferred-fold arena for the frozen fast path (DESIGN.md §12): a
        # frozen packet costs one buffer append at ingest; the ~hundred-op
        # aggregate fold runs once per `agg_buffer` packets (chunk-invariant
        # fold boundaries — appends split exactly at capacity), amortizing
        # numpy per-op overhead that would otherwise dominate small blocks.
        # Any reader of a frozen slot's aggregates/tracker fields drains it
        # first (`flush_agg`): refresh discovery, close, eviction, migration.
        self._ab_cap = max(1, int(agg_buffer)) if reuse else 0
        if self.reuse:
            cap_b = self._ab_cap
            self._ab_slot = np.zeros(cap_b, np.int64)
            self._ab_t = np.zeros(cap_b, np.float64)
            self._ab_rel = np.zeros(cap_b, np.float64)
            self._ab_size = np.zeros(cap_b, np.float64)
            self._ab_dir = np.zeros(cap_b, np.int64)
            self._ab_ttl = np.zeros(cap_b, np.float64)
            self._ab_win = np.zeros(cap_b, np.float64)
            self._ab_fb = np.zeros(cap_b, np.int64)
            self._ab_has = np.zeros(capacity, bool)  # slot has buffered pkts
        self._abuf_n = 0

        # open-addressed index: power-of-two bucket array sized so a full
        # table stays at load <= load_factor (default 0.5)
        n_buckets = 1
        while n_buckets * load_factor < capacity:
            n_buckets *= 2
        self._n_buckets = n_buckets
        self._mask = n_buckets - 1
        self._buckets = np.full(n_buckets, _EMPTY, dtype=np.int64)
        self._tombstones = 0
        self._rebuild_at = int(n_buckets * rebuild_tombstone_frac)

        self._free = list(range(capacity - 1, -1, -1))  # pop() -> slot 0 first

    # -- hash index ----------------------------------------------------------

    def _probe_many(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized read-only probe: slot per key, -1 on miss.

        Replicates `_probe`'s traversal (linear probing, stored-key
        verification, tombstones skipped) with one numpy step per probe
        distance across all still-unresolved keys. Probe distance 0 is
        unrolled without the pending-index machinery: at sane load
        factors nearly every key resolves in its home bucket, and this
        probe sits on the frozen fast path's per-block budget.
        """
        U = len(keys)
        if U == 0:
            return np.full(U, -1, np.int64)
        b = (keys & np.uint64(self._mask)).astype(np.int64)
        s = self._buckets[b]
        live = s >= 0
        match = live.copy()
        if live.any():
            match[live] = self.ctrl["key"][s[live]] == keys[live]
        res = np.where(match, s, -1)
        keep = ~match & (s != _EMPTY)  # tombstone / live mismatch: probe on
        if not keep.any():
            return res
        pending = np.flatnonzero(keep)
        b[pending] = (b[pending] + 1) & self._mask
        while pending.size:
            s = self._buckets[b[pending]]
            empty = s == _EMPTY
            live = s >= 0
            match = np.zeros(pending.size, bool)
            if live.any():
                match[live] = self.ctrl["key"][s[live]] == keys[pending[live]]
            res[pending[match]] = s[match]
            keep = ~(empty | match)
            pending = pending[keep]
            b[pending] = (b[pending] + 1) & self._mask
        return res

    def _probe(self, key: int) -> tuple[int, int]:
        """Return (slot, first_usable_bucket). slot is -1 on miss."""
        b = key & self._mask
        first_usable = -1
        while True:
            s = self._buckets[b]
            if s == _EMPTY:
                return -1, (b if first_usable < 0 else first_usable)
            if s == _TOMBSTONE:
                if first_usable < 0:
                    first_usable = b
            elif self.ctrl["key"][s] == key:
                return int(s), b
            b = (b + 1) & self._mask

    def _index_insert(self, key: int, slot: int, bucket: int) -> None:
        if self._buckets[bucket] == _TOMBSTONE:
            self._tombstones -= 1
        self._buckets[bucket] = slot

    def _index_remove(self, key: int) -> None:
        b = key & self._mask
        while True:
            s = self._buckets[b]
            if s == _EMPTY:
                return  # not present (already removed)
            if s >= 0 and self.ctrl["key"][s] == key:
                self._buckets[b] = _TOMBSTONE
                self._tombstones += 1
                if self._tombstones > self._rebuild_at:
                    self._rebuild_index()
                return
            b = (b + 1) & self._mask

    def _rebuild_index(self) -> None:
        self._buckets.fill(_EMPTY)
        self._tombstones = 0
        for s in np.nonzero(self.ctrl["state"] != 0)[0]:
            key = int(self.ctrl["key"][s])
            b = key & self._mask
            while self._buckets[b] >= 0:
                b = (b + 1) & self._mask
            self._buckets[b] = s

    # -- slot lifecycle ------------------------------------------------------

    @property
    def n_active(self) -> int:
        return self.capacity - len(self._free)

    def occupancy(self) -> dict:
        """Point-in-time table pressure, for the metrics registry's gauge
        namespace (DESIGN.md §11.1). Gauges only — the cumulative story
        (flows_seen, evictions, drops) lives in `RuntimeMetrics`."""
        return {
            "n_active": self.n_active,
            "capacity": self.capacity,
            "load_factor": self.n_active / self.capacity,
            "tombstones": int(self._tombstones),
        }

    def _alloc(self, key: int, t: float, flow_id: int) -> int:
        slot = self._free.pop()
        c = self.ctrl[slot]
        c["key"] = key
        c["state"] = 1  # ACTIVE
        c["fin_mask"] = 0
        c["count"] = 0
        c["seen"] = 0
        c["first_ts"] = t
        c["last_ts"] = t
        c["ready_ts"] = 0.0
        c["flow_id"] = flow_id
        self.metrics.flows_seen += 1
        return slot

    def _clear_slot(self, slot: int) -> None:
        """Detach a slot from the index and zero its state + payload.

        The one slot-clearing sequence, shared by `recycle` (flow ended)
        and `detach_slot` (flow migrating) so the two can never diverge.
        State must clear BEFORE the index removal: removal can trigger a
        rebuild, and the rebuild must not re-insert the departing slot.
        Payload rows are zeroed so the next tenant starts from padding.
        """
        if self.reuse and self._abuf_n and self._ab_has[slot]:
            # fold pending frozen-path packets before the row resets, or a
            # later drain would resurrect the departed tenant's statistics
            # into whatever tenant holds the slot then
            self.flush_agg()
        key = int(self.ctrl["key"][slot])
        self.ctrl["state"][slot] = 0
        self._index_remove(key)
        # zero the whole control row, not just key/state: a slot on the
        # free list holds no trace of its previous tenant, so the audit can
        # compare recycled slots bitwise against never-used ones
        self.ctrl[slot] = np.zeros((), dtype=self.ctrl.dtype)[()]
        self.ts[slot] = 0.0
        self.size[slot] = 0.0
        self.direction[slot] = 0
        self.ttl[slot] = 0.0
        self.winsize[slot] = 0.0
        self.flags[slot] = 0
        # 5-tuple metadata resets too: alloc happens to overwrite these, but
        # a slot on the free list must hold NO previous tenant's state — the
        # invariant the aggregate columns below depend on, audited by
        # tests/test_reuse.py::test_recycle_resets_every_column
        self.proto[slot] = 0.0
        self.s_port[slot] = 0.0
        self.d_port[slot] = 0.0
        if self.agg is not None:
            self.agg[slot] = self._agg_init
        if self.anchor is not None:
            self.anchor[slot] = 0.0
        self.anchor_valid[slot] = False
        self.refresh_pending[slot] = False
        self.gen[slot] += 1
        self._free.append(slot)

    def recycle(self, slot: int) -> None:
        """Return a slot to the free list and clear its payload row."""
        self._clear_slot(slot)
        self.metrics.slots_recycled += 1

    # -- incremental aggregates (DESIGN.md §12) ------------------------------

    def _agg_update1(
        self, slot, rel_ts, size, direction, ttl, winsize, flags_byte
    ) -> None:
        """Scalar Welford update of one slot's aggregate row.

        The reference semantics: the block path (`_agg_update_sorted`,
        Chan merges) must match this exactly for count/sum/min/max and to
        ~1e-6 relative for the M2 cells (reassociation only).
        """
        a = self.agg[slot]
        ts = float(rel_ts)
        b = AGG_DIR_STRIDE * (int(direction) & 1)
        if ts < a[AGG_TS_MIN]:
            a[AGG_TS_MIN] = ts
        if ts > a[AGG_TS_MAX]:
            a[AGG_TS_MAX] = ts
        fb = int(flags_byte)
        a[AGG_FLAGS:AGG_FLAGS + 8] += _FLAG_LUT[fb]
        syn = (fb >> _SYN_BIT) & 1
        ack = (fb >> _ACK_BIT) & 1
        if syn and not ack and ts < a[AGG_HS_SYN]:
            a[AGG_HS_SYN] = ts
        if syn and ack and ts < a[AGG_HS_SYNACK]:
            a[AGG_HS_SYNACK] = ts
        if ack and not syn and ts < a[AGG_HS_ACK]:
            a[AGG_HS_ACK] = ts
        # same-direction inter-arrival (uses the previous LAST_TS, so this
        # runs before the timestamp cells are advanced). The stored sum
        # telescopes to last - first: exact by construction, never drifts.
        prev = a[b + AGG_LAST_TS]
        if prev > -_AGG_BIG / 2:
            x = ts - prev
            n0 = a[b + AGG_IAT_CNT]
            mean0 = a[b + AGG_IAT_SUM] / n0 if n0 > 0 else 0.0
            delta = x - mean0
            n1 = n0 + 1.0
            a[b + AGG_IAT_CNT] = n1
            if x < a[b + AGG_IAT_MIN]:
                a[b + AGG_IAT_MIN] = x
            if x > a[b + AGG_IAT_MAX]:
                a[b + AGG_IAT_MAX] = x
            a[b + AGG_IAT_SUM] = ts - a[b + AGG_FIRST_TS]
            a[b + AGG_IAT_M2] += delta * (x - a[b + AGG_IAT_SUM] / n1)
        else:
            a[b + AGG_FIRST_TS] = ts
        a[b + AGG_LAST_TS] = ts
        n0 = a[b + AGG_CNT]
        n1 = n0 + 1.0
        a[b + AGG_CNT] = n1
        for val, fam in (
            (float(size), AGG_FAM_BASE["bytes"]),
            (float(winsize), AGG_FAM_BASE["winsize"]),
            (float(ttl), AGG_FAM_BASE["ttl"]),
        ):
            base = b + fam
            s_old = a[base]
            mean0 = s_old / n0 if n0 > 0 else 0.0
            delta = val - mean0
            s_new = s_old + val
            a[base] = s_new
            if val < a[base + 1]:
                a[base + 1] = val
            if val > a[base + 2]:
                a[base + 2] = val
            a[base + 3] += delta * (val - s_new / n1)

    def _agg_update_sorted(
        self, fs, g, uniq_g, start, counts, slots_g,
        rel_ts, size, direction, ttl, winsize, flags_byte,
    ) -> None:
        """Block aggregate update over key-sorted packet positions `fs`.

        `fs` must be time-ascending within each key group (the stable sort
        `fast_apply` already produces). Per-(slot, direction) segment
        statistics are computed two-pass and folded in with Chan's merge;
        count/sum/min/max cells are exact vs the scalar path (integer-valued
        payload fields sum exactly in float64, the iat sum telescopes), M2
        differs only by reassociation.
        """
        agg = self.agg
        flat = agg.reshape(-1)  # flat view: cell (slot, col) -> slot*W + col
        W = AGG_WIDTH
        rel = np.asarray(rel_ts, np.float64)[fs]
        fb = flags_byte[fs]
        ends = start + counts - 1
        agg[slots_g, AGG_TS_MIN] = np.minimum(agg[slots_g, AGG_TS_MIN],
                                              rel[start])
        agg[slots_g, AGG_TS_MAX] = np.maximum(agg[slots_g, AGG_TS_MAX],
                                              rel[ends])
        flv = _FLAG_LUT[fb].astype(np.float64)
        agg[slots_g, AGG_FLAGS:AGG_FLAGS + 8] += np.add.reduceat(
            flv, start, axis=0)
        syn = (fb >> _SYN_BIT) & 1
        ack = (fb >> _ACK_BIT) & 1
        conds = np.stack(((syn == 1) & (ack == 0),
                          (syn == 1) & (ack == 1),
                          (ack == 1) & (syn == 0)))
        seg = np.minimum.reduceat(np.where(conds, rel[None, :], _AGG_BIG),
                                  start, axis=1)
        fi_hs = slots_g[None, :] * W + _HS_COLS[:, None]
        flat[fi_hs] = np.minimum(flat[fi_hs], seg)

        # (slot, direction) segments: stable re-sort keeps time order.
        # Segment structure is derived from sorted-boundary masks + a
        # cumsum segment index instead of np.unique/np.repeat, and the
        # three payload families fold in one stacked (3, n) pass with
        # flat-index gathers — per-op numpy overhead dominates small
        # blocks, and this fold IS the frozen fast path.
        dirb = direction[fs].astype(np.int64) & 1
        g2 = g * 2 + dirb
        o2 = np.argsort(g2, kind="stable")
        g2s = g2[o2]
        r2 = rel[o2]
        n2 = g2s.size
        bnd2 = np.empty(n2, bool)
        bnd2[0] = True
        np.not_equal(g2s[1:], g2s[:-1], out=bnd2[1:])
        s2 = np.flatnonzero(bnd2)
        c2 = np.diff(np.append(s2, n2))
        seg2 = np.cumsum(bnd2) - 1  # per-element segment id
        u2 = g2s[s2]
        slots2 = slots_g[np.searchsorted(uniq_g, u2 >> 1)]
        fiB = slots2 * W + (u2 & 1) * AGG_DIR_STRIDE  # flat base per segment
        nb = c2.astype(np.float64)
        n_old = flat[fiB + AGG_CNT]
        n_new = n_old + nb
        flat[fiB + AGG_CNT] = n_new
        idx2 = fs[o2]
        V = np.stack((np.asarray(size, np.float64)[idx2],
                      np.asarray(winsize, np.float64)[idx2],
                      np.asarray(ttl, np.float64)[idx2]))
        sum_b = np.add.reduceat(V, s2, axis=1)
        mean_b = sum_b / nb[None, :]
        dif = V - mean_b[:, seg2]
        m2_b = np.add.reduceat(dif * dif, s2, axis=1)
        fi = fiB[None, :] + _FAM_COLS[:, None]  # (3, G2) flat SUM-cell index
        s_old = flat[fi]
        mean_old = s_old / np.maximum(n_old, 1.0)[None, :]
        delta = mean_b - mean_old
        flat[fi] = s_old + sum_b
        flat[fi + 1] = np.minimum(flat[fi + 1],
                                  np.minimum.reduceat(V, s2, axis=1))
        flat[fi + 2] = np.maximum(flat[fi + 2],
                                  np.maximum.reduceat(V, s2, axis=1))
        flat[fi + 3] += m2_b + delta * delta * (n_old * nb / n_new)[None, :]

        # inter-arrival: the segment's first sample bridges from the stored
        # LAST_TS (when one exists); the rest are in-segment diffs
        prev_last = flat[fiB + AGG_LAST_TS]
        first_old = flat[fiB + AGG_FIRST_TS]
        has_prev = prev_last > -_AGG_BIG / 2
        seg_first = r2[s2]
        seg_last = r2[s2 + c2 - 1]
        iv = np.empty(r2.size, np.float64)
        iv[1:] = r2[1:] - r2[:-1]
        iv[s2] = seg_first - prev_last
        validm = np.ones(r2.size, bool)
        validm[s2] = has_prev
        nbi = (c2 - 1 + has_prev).astype(np.float64)
        prev_eff = np.where(has_prev, prev_last, seg_first)
        # block mean telescopes exactly: (last - effective first) / count
        mean_b = np.where(nbi > 0, (seg_last - prev_eff) / np.maximum(nbi, 1.0),
                          0.0)
        dif = np.where(validm, iv - mean_b[seg2], 0.0)
        m2_b = np.add.reduceat(dif * dif, s2)
        n_old_i = flat[fiB + AGG_IAT_CNT]
        mean_old_i = flat[fiB + AGG_IAT_SUM] / np.maximum(n_old_i, 1.0)
        n_new_i = n_old_i + nbi
        delta = mean_b - mean_old_i
        flat[fiB + AGG_IAT_M2] += np.where(
            nbi > 0,
            m2_b + delta * delta * n_old_i * nbi / np.maximum(n_new_i, 1.0),
            0.0,
        )
        flat[fiB + AGG_IAT_CNT] = n_new_i
        flat[fiB + AGG_IAT_MIN] = np.minimum(
            flat[fiB + AGG_IAT_MIN],
            np.minimum.reduceat(np.where(validm, iv, _AGG_BIG), s2))
        flat[fiB + AGG_IAT_MAX] = np.maximum(
            flat[fiB + AGG_IAT_MAX],
            np.maximum.reduceat(np.where(validm, iv, -_AGG_BIG), s2))
        first_new = np.minimum(first_old, seg_first)
        flat[fiB + AGG_FIRST_TS] = first_new
        flat[fiB + AGG_LAST_TS] = seg_last
        flat[fiB + AGG_IAT_SUM] = np.where(
            n_new_i > 0, seg_last - first_new, 0.0)

    def _note_refresh(self, slots, old_seen, new_seen) -> None:
        """Schedule drift checks for slots whose seen counter crossed a
        refresh_every boundary — chunk-invariant: any split of the same
        packet sequence schedules the same refreshes."""
        K = self.refresh_every
        cross = (old_seen // K) != (new_seen // K)
        sel = cross & ~self.refresh_pending[slots]
        for s in slots[sel].tolist():
            self._refresh_due.append((s, int(self.gen[s])))
        self.refresh_pending[slots[sel]] = True

    def take_refresh_due(self) -> list[int]:
        """Drain scheduled drift checks. Entries whose slot was cleared or
        re-tenanted since scheduling (generation mismatch) or is no longer
        PREDICTED are dropped — a refresh must never touch another flow."""
        if not self._refresh_due:
            return []
        out = []
        for s, gen in self._refresh_due:
            self.refresh_pending[s] = False
            if self.gen[s] == gen and self.ctrl["state"][s] == 3:
                out.append(s)
        self._refresh_due.clear()
        return out

    # -- hot path ------------------------------------------------------------

    def observe(
        self,
        key: int,
        t: float,
        rel_ts: float,
        size: float,
        direction: int,
        ttl: float,
        winsize: float,
        flags_byte: int,
        proto: float,
        s_port: float,
        d_port: float,
        flow_id: int,
        fin: bool,
    ) -> tuple[FlowStatus, int]:
        """Account one packet; returns (status, slot) — slot is -1 on drop."""
        self.metrics.pkts_total += 1
        return self._observe1(
            key, t, rel_ts, size, direction, ttl, winsize, flags_byte,
            proto, s_port, d_port, flow_id, fin,
        )

    def _observe1(
        self, key, t, rel_ts, size, direction, ttl, winsize, flags_byte,
        proto, s_port, d_port, flow_id, fin,
    ) -> tuple[FlowStatus, int]:
        """`observe` body without the pkts_total bump (observe_batch adds
        the whole block's count up front)."""
        m = self.metrics
        self.last1_frozen = False
        slot, bucket = self._probe(key)
        if slot < 0:
            if not self._free:
                m.drops_table += 1
                return FlowStatus.DROPPED, -1
            slot = self._alloc(key, t, flow_id)
            self._index_insert(key, slot, bucket)
            self.proto[slot] = proto
            self.s_port[slot] = s_port
            self.d_port[slot] = d_port
        elif self.reuse and self.ctrl["state"][slot] == 3 and not fin:
            # frozen fast path, scalar cadence: defer the tracker touch
            # and aggregate update to the shared fold arena
            m.pkts_tracked += 1
            self.last1_frozen = True
            self._ab_append1(slot, t, rel_ts, size, direction, ttl,
                             winsize, flags_byte)
            return FlowStatus.TRACKED, slot
        if self.reuse and self._abuf_n and self._ab_has[slot]:
            # the eager path below writes seen/last_ts/agg directly: any
            # staged packets of this slot must fold first or the updates
            # would land out of arrival order
            self.flush_agg()

        c = self.ctrl[slot]
        c["last_ts"] = t
        c["seen"] += 1
        if self.track_agg:
            self._agg_update1(slot, rel_ts, size, direction, ttl, winsize,
                              flags_byte)
        state = int(c["state"])
        if fin:
            # per-direction FIN: a half-close (one side done, the other
            # still sending) must NOT end the flow, or trailing packets
            # would re-tenant the 5-tuple and get classified twice
            c["fin_mask"] |= np.uint8(1 << (direction & 1))
        closed = c["fin_mask"] == 3

        if state == 1 and c["count"] < self.pkt_depth:  # ACTIVE, accumulating
            i = int(c["count"])
            self.ts[slot, i] = rel_ts
            self.size[slot, i] = size
            self.direction[slot, i] = direction
            self.ttl[slot, i] = ttl
            self.winsize[slot, i] = winsize
            self.flags[slot, i] = _FLAG_LUT[flags_byte]
            c["count"] = i + 1
            m.pkts_accumulated += 1
            if c["count"] == self.pkt_depth:
                c["state"] = 2  # READY
                c["ready_ts"] = t
                return FlowStatus.READY, slot
            if closed:
                c["state"] = 2
                c["ready_ts"] = t
                return FlowStatus.READY_EOF, slot
            return FlowStatus.TRACKED, slot

        # past depth / already queued / already predicted: tracker only
        m.pkts_tracked += 1
        if closed and state == 3:  # PREDICTED: flow over, reclaim now
            self.recycle(slot)
            return FlowStatus.CLOSED, slot
        if state == 3 and self.reuse and self.refresh_every > 0:
            # only FIN-bearing packets of a PREDICTED flow reach here (the
            # frozen carve above returns early otherwise): keep the eager
            # seen bump's refresh crossing, matching `fast_apply`'s noting
            sn = int(c["seen"])
            K = self.refresh_every
            if (sn - 1) // K != sn // K and not self.refresh_pending[slot]:
                self._refresh_due.append((slot, int(self.gen[slot])))
                self.refresh_pending[slot] = True
        return FlowStatus.TRACKED, slot

    def observe_batch(
        self,
        key: np.ndarray,        # (B,) uint64
        t: np.ndarray,          # (B,) float64 arrival clock
        rel_ts: np.ndarray,     # (B,) float32 payload timestamp
        size: np.ndarray,
        direction: np.ndarray,
        ttl: np.ndarray,
        winsize: np.ndarray,
        flags_byte: np.ndarray,
        proto: np.ndarray,
        s_port: np.ndarray,
        d_port: np.ndarray,
        flow_id: np.ndarray,
        fin: np.ndarray,        # (B,) bool
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized `observe` over a packet block, exact-equivalent to the
        scalar loop in delivery order (DESIGN.md §7).

        Packets are partitioned per 5-tuple key into three phases that
        reproduce the scalar interleaving exactly:

        1. **Vector prefix** — resident keys with a FIN later in the block
           apply their pre-FIN payload writes in bulk (no structural effect,
           and within the key they precede the FIN suffix).
        2. **Ordered scalar pass** — everything structural runs through
           `_observe1` per packet in original order: the *first* packet of
           each new key (allocation order decides slot identity and drops),
           every packet from a key's first FIN onward (close accounting,
           PREDICTED recycling, re-tenancy), all packets of new keys that
           also FIN in the block, and all new-key packets when the free
           list could run out (allocation vs. recycle order then matters).
        3. **Vector bulk** — all remaining packets: resident FIN-free keys
           in full, plus new keys' packets after their (already allocated)
           first. Per-direction payload writes, seen/last_ts, and READY
           transitions are numpy fancy-indexing over the whole block;
           within a key they follow its scalar-phase packets and ordering
           across keys is immaterial (disjoint slots).

        Returns ``(statuses, slots, accumulated)`` — per-packet FlowStatus
        values, slot ids (-1 on drop), and whether the packet landed in the
        dense payload (the replay clock's per-packet cost class).

        Under reuse (DESIGN.md §12) the block is first split by a
        per-packet probe: packets of resident PREDICTED keys with no FIN
        in the block take the *frozen fast path* — they are staged in the
        deferred fold arena (`_ab_append`) and their seen/last_ts and
        aggregate updates land at the next `flush_agg`, amortizing the
        numpy fold over ~`agg_buffer` packets — and never enter the
        three-phase machinery; only the remainder pays the general path's
        per-key partitioning. A PREDICTED key cannot change state
        mid-block except through a FIN (those keys are excluded whole, and
        drain any staged state for their slot first), so the split
        decision at block start is exact, and frozen slots are disjoint
        from every slot the remainder can touch (no allocation lands on
        an occupied slot), so processing the carve first preserves the
        scalar cadence.
        """
        key = np.asarray(key, np.uint64)
        B = len(key)
        self.metrics.pkts_total += B
        self.last_frozen = None
        if B == 0:
            return (np.full(0, int(FlowStatus.TRACKED), np.uint8),
                    np.full(0, -1, np.int64), np.zeros(0, bool))
        if not self.reuse:
            return self._observe_general(
                key, t, rel_ts, size, direction, ttl, winsize, flags_byte,
                proto, s_port, d_port, flow_id, fin)
        slots_pp = self._probe_many(key)
        miss = slots_pp < 0
        if not miss.any():
            frzm = self.ctrl["state"][slots_pp] == 3
            if frzm.all() and not np.asarray(fin, bool).any():
                # all-frozen lane: the steady state under skewed traffic.
                # Every packet is a buffer append (slice copies, no
                # gathers); slots_pp is freshly allocated so it doubles
                # as the returned slot array
                self.metrics.pkts_tracked += B
                self._ab_append_all(slots_pp, t, rel_ts, size, direction,
                                    ttl, winsize, flags_byte)
                self.last_frozen = frzm
                return (np.full(B, int(FlowStatus.TRACKED), np.uint8),
                        slots_pp, np.zeros(B, bool))
        else:
            frzm = ~miss
            res = np.flatnonzero(frzm)
            frzm[res] = self.ctrl["state"][slots_pp[res]] == 3
        if frzm.any():
            bad = frzm & np.asarray(fin, bool)
            if bad.any():
                # a FIN on a predicted key: the whole key group goes to
                # the general path (close accounting, recycling)
                badslot = np.zeros(self.capacity, bool)
                badslot[slots_pp[bad]] = True
                res = np.flatnonzero(~miss)
                excl = np.zeros(B, bool)
                excl[res] = badslot[slots_pp[res]]
                frzm &= ~excl
                if self._abuf_n and self._ab_has[slots_pp[bad]].any():
                    # close accounting needs these slots' statistics current
                    self.flush_agg()
        if not frzm.any():
            out = self._observe_general(
                key, t, rel_ts, size, direction, ttl, winsize, flags_byte,
                proto, s_port, d_port, flow_id, fin)
            self.last_frozen = frzm
            return out
        statuses = np.full(B, int(FlowStatus.TRACKED), np.uint8)
        slots_out = np.full(B, -1, np.int64)
        accumulated = np.zeros(B, bool)
        frz = np.flatnonzero(frzm)
        slots_out[frz] = slots_pp[frz]
        self.metrics.pkts_tracked += frz.size
        self._ab_append(frz, slots_pp[frz], t, rel_ts, size, direction,
                        ttl, winsize, flags_byte)
        rem = np.flatnonzero(~frzm)
        if rem.size:
            st, sl, acc = self._observe_general(
                key[rem], t[rem], rel_ts[rem], size[rem], direction[rem],
                ttl[rem], winsize[rem], flags_byte[rem], proto[rem],
                s_port[rem], d_port[rem], flow_id[rem], fin[rem])
            statuses[rem] = st
            slots_out[rem] = sl
            accumulated[rem] = acc
        self.last_frozen = frzm
        return statuses, slots_out, accumulated

    def _ab_append1(self, slot, t, rel_ts, size, direction, ttl, winsize,
                    flags_byte) -> None:
        """Stage one frozen-path packet in the fold arena (scalar cadence)."""
        i = self._abuf_n
        self._ab_slot[i] = slot
        self._ab_t[i] = t
        self._ab_rel[i] = rel_ts
        self._ab_size[i] = size
        self._ab_dir[i] = direction
        self._ab_ttl[i] = ttl
        self._ab_win[i] = winsize
        self._ab_fb[i] = flags_byte
        self._ab_has[slot] = True
        self._abuf_n = i + 1
        if self._abuf_n == self._ab_cap:
            self.flush_agg()

    def _ab_append(self, frz, sl, t, rel_ts, size, direction, ttl, winsize,
                   flags_byte) -> None:
        """Stage a block's frozen carve in the fold arena.

        Appends split exactly at arena capacity so fold boundaries land on
        the same packet positions regardless of how the stream was chunked
        — the scalar cadence and any block cadence stage and fold the same
        packet sequence at the same points (refresh scheduling and the
        buffered/current split stay chunk-invariant)."""
        n = frz.size
        off = 0
        while off < n:
            take = min(n - off, self._ab_cap - self._abuf_n)
            i = self._abuf_n
            sel = frz[off:off + take]
            sls = sl[off:off + take]
            self._ab_slot[i:i + take] = sls
            self._ab_t[i:i + take] = t[sel]
            self._ab_rel[i:i + take] = rel_ts[sel]
            self._ab_size[i:i + take] = size[sel]
            self._ab_dir[i:i + take] = direction[sel]
            self._ab_ttl[i:i + take] = ttl[sel]
            self._ab_win[i:i + take] = winsize[sel]
            self._ab_fb[i:i + take] = flags_byte[sel]
            self._ab_has[sls] = True
            self._abuf_n = i + take
            off += take
            if self._abuf_n == self._ab_cap:
                self.flush_agg()

    def _ab_append_all(self, sl, t, rel_ts, size, direction, ttl, winsize,
                       flags_byte) -> None:
        """`_ab_append` when the whole block is frozen: contiguous slice
        copies instead of fancy gathers (the steady-state hot path)."""
        n = sl.size
        off = 0
        while off < n:
            take = min(n - off, self._ab_cap - self._abuf_n)
            i = self._abuf_n
            j = i + take
            p = off + take
            sls = sl[off:p]
            self._ab_slot[i:j] = sls
            self._ab_t[i:j] = t[off:p]
            self._ab_rel[i:j] = rel_ts[off:p]
            self._ab_size[i:j] = size[off:p]
            self._ab_dir[i:j] = direction[off:p]
            self._ab_ttl[i:j] = ttl[off:p]
            self._ab_win[i:j] = winsize[off:p]
            self._ab_fb[i:j] = flags_byte[off:p]
            self._ab_has[sls] = True
            self._abuf_n = j
            off = p
            if j == self._ab_cap:
                self.flush_agg()

    def flush_agg(self) -> None:
        """Fold every arena-staged packet into seen/last_ts and the
        aggregate columns, in arrival order.

        One stable sort groups the arena by slot (time order preserved
        within each group); the fold is the same Chan-merge
        `_agg_update_sorted` the general path uses, so a table that drains
        here is bit-comparable to one that folded eagerly — exact on every
        count/sum/min/max cell, with M2 differing only by float merge
        order (~1e-15 rel). Refresh crossings are detected at fold time
        from the per-slot seen span."""
        n = self._abuf_n
        if not n:
            return
        self._abuf_n = 0
        sl = self._ab_slot[:n]
        order = np.argsort(sl, kind="stable")
        sls = sl[order]
        bnd = np.empty(n, bool)
        bnd[0] = True
        np.not_equal(sls[1:], sls[:-1], out=bnd[1:])
        start = np.flatnonzero(bnd)
        counts = np.diff(np.append(start, n))
        slots_g = sls[start]
        segidx = np.cumsum(bnd) - 1
        old_seen = self.ctrl["seen"][slots_g].astype(np.int64)
        new_seen = old_seen + counts
        self.ctrl["seen"][slots_g] = new_seen
        self.ctrl["last_ts"][slots_g] = self._ab_t[order[start + counts - 1]]
        self._agg_update_sorted(
            order, segidx, np.arange(len(start)), start, counts, slots_g,
            self._ab_rel[:n], self._ab_size[:n], self._ab_dir[:n],
            self._ab_ttl[:n], self._ab_win[:n], self._ab_fb[:n])
        self._ab_has.fill(False)
        if self.refresh_every > 0:
            # the arena stages packets of any live flow, but only
            # PREDICTED flows are on a drift-refresh cadence
            pred = self.ctrl["state"][slots_g] == 3
            if pred.any():
                self._note_refresh(slots_g[pred], old_seen[pred],
                                   new_seen[pred])

    def _observe_general(
        self, key, t, rel_ts, size, direction, ttl, winsize, flags_byte,
        proto, s_port, d_port, flow_id, fin,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The three-phase block machinery (`observe_batch`'s docstring);
        under reuse it runs on the non-frozen remainder only."""
        B = len(key)
        m = self.metrics
        statuses = np.full(B, int(FlowStatus.TRACKED), np.uint8)
        slots_out = np.full(B, -1, np.int64)
        accumulated = np.zeros(B, bool)

        uk, firstpos, inv = np.unique(key, return_index=True,
                                      return_inverse=True)
        U = len(uk)
        uslot = self._probe_many(uk)
        # first FIN position per key (B = no FIN in this block); fidx is
        # ascending, so unique's first occurrence is the minimum position
        finpos = np.full(U, B, np.int64)
        fidx = np.flatnonzero(fin)
        if fidx.size:
            uf, ufirst = np.unique(inv[fidx], return_index=True)
            finpos[uf] = fidx[ufirst]

        new_u = uslot < 0
        has_fin_u = finpos < B
        # conservative: if allocations could exhaust the free list, the
        # alloc/recycle interleaving decides slots and drops — keep every
        # new-key packet in the ordered scalar pass
        tight = len(self._free) < int(new_u.sum())
        scalar_all_u = new_u & (has_fin_u | tight)

        pos = np.arange(B)
        pinv = inv  # per-packet key index
        # phase-2 membership per packet
        in_scalar = scalar_all_u[pinv] \
            | (has_fin_u[pinv] & (pos >= finpos[pinv])) \
            | (new_u[pinv] & (pos == firstpos[pinv]))
        # phase-1 membership: resident FIN-key packets before the first FIN
        in_prefix = (~new_u[pinv]) & has_fin_u[pinv] & (pos < finpos[pinv])

        def fast_apply(fsel: np.ndarray, slot_of_key: np.ndarray) -> None:
            """Vectorized observe for packets with no structural effects.

            `fsel` holds block positions (ascending); `slot_of_key` maps
            unique-key index -> resolved slot."""
            if not fsel.size:
                return
            order = np.argsort(pinv[fsel], kind="stable")
            fs = fsel[order]
            g = pinv[fs]
            uniq_g, start = np.unique(g, return_index=True)
            counts = np.diff(np.append(start, g.size))
            slots_g = slot_of_key[uniq_g]
            rank = np.arange(g.size) - np.repeat(start, counts)
            slots_out[fs] = np.repeat(slots_g, counts)

            # tracker touch: every packet updates seen/last_ts
            if self.reuse:
                # deferred-fold lane for every non-structural packet of a
                # reuse table, not just frozen ones: seen/last_ts and the
                # aggregate columns fold in arena order (the structural
                # scalar path and every agg reader flush first, so per-slot
                # ordering stays exact). This keeps the pre-classification
                # phase as cheap as plain tracking — the eager per-chunk
                # Chan fold is what the arena exists to amortize.
                self._ab_append(fs, np.repeat(slots_g, counts), t, rel_ts,
                                size, direction, ttl, winsize, flags_byte)
            else:
                self.ctrl["seen"][slots_g] += counts
                self.ctrl["last_ts"][slots_g] = t[fs[start + counts - 1]]
                if self.track_agg:
                    self._agg_update_sorted(fs, g, uniq_g, start, counts,
                                            slots_g, rel_ts, size, direction,
                                            ttl, winsize, flags_byte)

            # ACTIVE flows accumulate their first (pkt_depth - count) packets
            c0 = self.ctrl["count"][slots_g].astype(np.int64)
            active = self.ctrl["state"][slots_g] == 1
            n_acc = np.where(active, np.minimum(counts, self.pkt_depth - c0), 0)
            acc_mask = rank < np.repeat(n_acc, counts)
            apk = fs[acc_mask]
            rows = np.repeat(slots_g, n_acc)
            cols = np.repeat(c0, n_acc) + rank[acc_mask]
            self.ts[rows, cols] = rel_ts[apk]
            self.size[rows, cols] = size[apk]
            self.direction[rows, cols] = direction[apk]
            self.ttl[rows, cols] = ttl[apk]
            self.winsize[rows, cols] = winsize[apk]
            self.flags[rows, cols] = _FLAG_LUT[flags_byte[apk]]
            self.ctrl["count"][slots_g] = c0 + n_acc
            accumulated[apk] = True
            m.pkts_accumulated += int(n_acc.sum())
            m.pkts_tracked += int(fs.size - n_acc.sum())

            # depth reached inside the block -> READY at the triggering pkt
            now_ready = np.flatnonzero(active & (c0 + n_acc == self.pkt_depth))
            if now_ready.size:
                rdy_slots = slots_g[now_ready]
                trig = fs[start[now_ready] + n_acc[now_ready] - 1]
                self.ctrl["state"][rdy_slots] = 2
                self.ctrl["ready_ts"][rdy_slots] = t[trig]
                statuses[trig] = int(FlowStatus.READY)

        # phase 1: pre-FIN prefixes of resident FIN-bearing keys
        fast_apply(np.flatnonzero(in_prefix), uslot)

        # phase 2: structural events in original packet order (bulk-convert
        # the scalar subset to python values once — ~10x cheaper than
        # per-field numpy scalar conversion inside the loop)
        sc = np.flatnonzero(in_scalar)
        if sc.size:
            obs = self._observe1
            for i, k_, t_, rts, sz, dr, tl, ws, fb, pr, sp_, dp_, fl, fn in zip(
                sc.tolist(), key[sc].tolist(), t[sc].tolist(),
                rel_ts[sc].tolist(), size[sc].tolist(),
                direction[sc].tolist(), ttl[sc].tolist(),
                winsize[sc].tolist(), flags_byte[sc].tolist(),
                proto[sc].tolist(), s_port[sc].tolist(), d_port[sc].tolist(),
                flow_id[sc].tolist(), fin[sc].tolist(),
            ):
                a0 = m.pkts_accumulated
                st, sl = obs(k_, t_, rts, sz, dr, tl, ws, fb, pr, sp_, dp_,
                             fl, bool(fn))
                statuses[i] = int(st)
                slots_out[i] = sl
                accumulated[i] = m.pkts_accumulated > a0

        # phase 3: the fin-free bulk (now-allocated new keys re-resolved)
        bulk = ~(in_scalar | in_prefix)
        if bulk.any():
            slot_of_key = uslot
            if new_u.any() and not tight:
                nk = np.flatnonzero(new_u & ~scalar_all_u)
                if nk.size:
                    slot_of_key = uslot.copy()
                    slot_of_key[nk] = self._probe_many(uk[nk])
            fast_apply(np.flatnonzero(bulk), slot_of_key)

        return statuses, slots_out, accumulated

    # -- maintenance ---------------------------------------------------------

    def detach_slot(self, slot: int) -> None:
        """Remove a slot from this table *without* recycle accounting.

        Used by migration (`move_slot`): the flow is not ending, it is
        moving to another table, so `slots_recycled` must not count it —
        the migration counters do."""
        self._clear_slot(slot)

    def mark_predicted(self, slots: np.ndarray) -> list[int]:
        """Dispatch flushed these slots: recycle fully-closed flows, keep
        the rest as PREDICTED (tracked until both FINs or idle timeout)."""
        recycled = []
        for s in np.asarray(slots, dtype=np.int64):
            if self.ctrl["fin_mask"][s] == 3:
                self.recycle(int(s))
                recycled.append(int(s))
            else:
                self.ctrl["state"][s] = 3  # PREDICTED
        return recycled

    def evict_idle(self, now: float) -> list[int]:
        """Timeout flows idle for > idle_timeout_s.

        PREDICTED flows are recycled; ACTIVE flows (never reached depth n,
        never saw FIN) are transitioned to READY and returned so the caller
        can enqueue them for a late flush. READY flows are left to the
        dispatcher's flush timeout.
        """
        if self.reuse and self._abuf_n:
            # idleness reads last_ts, which may still be staged in the arena
            self.flush_agg()
        state = self.ctrl["state"]
        idle = (now - self.ctrl["last_ts"]) > self.idle_timeout_s
        for s in np.nonzero((state == 3) & idle)[0]:
            self.recycle(int(s))
        late = []
        for s in np.nonzero((state == 1) & idle)[0]:
            if self.ctrl["count"][s] > 0:
                self.ctrl["state"][s] = 2
                self.ctrl["ready_ts"][s] = now
                late.append(int(s))
                self.metrics.flows_evicted_idle += 1
            else:
                self.recycle(int(s))
        return late

    def flush_all(self, now: float) -> list[int]:
        """End-of-stream drain: queue every still-active flow with data."""
        if self.reuse and self._abuf_n:
            self.flush_agg()
        late = []
        for s in np.nonzero(self.ctrl["state"] == 1)[0]:
            if self.ctrl["count"][s] > 0:
                self.ctrl["state"][s] = 2
                self.ctrl["ready_ts"][s] = now
                late.append(int(s))
            else:
                self.recycle(int(s))
        return late


def move_slot(src: FlowTable, dst: FlowTable, slot: int) -> int:
    """Migrate one live flow's state from `src` to `dst` (DESIGN.md §9).

    The transfer is a pure relocation: identity (5-tuple key), control
    fields (state, fin_mask, counts, timestamps, flow_id) and the dense
    payload move bit-exactly, so extraction on the destination produces
    exactly what it would have produced on the source. Lifecycle counters
    are *not* bumped — a migrated flow is the same flow, not a new one
    (`flows_seen`) nor a finished one (`slots_recycled`); only the
    `flows_migrated_out/in` counters record the transfer.

    Tables may differ in `pkt_depth` (pipeline hot-swap): the payload
    prefix up to `min(src.pkt_depth, dst.pkt_depth)` is copied and
    `count` clamps to the destination depth. The caller decides what a
    clamped ACTIVE flow becomes (a flow with `count == dst.pkt_depth`
    is dispatchable under the new configuration).

    Returns the destination slot, or -1 if `dst` has no free slot — the
    flow then stays where it is, and the caller must leave its steering
    entry unchanged (a misrouted continuation would re-tenant the
    5-tuple on the destination and classify the flow twice).
    """
    if not dst._free:
        return -1
    if src.reuse and src._abuf_n and src._ab_has[slot]:
        # the migrating flow has staged frozen-path packets: fold them on
        # the source first so ctrl/agg copy the complete statistics
        src.flush_agg()
    key = int(src.ctrl["key"][slot])
    found, bucket = dst._probe(key)
    if found >= 0:
        # the key already lives in dst (should be impossible while a flow
        # is owned by exactly one shard); refuse rather than double-track
        return -1
    dslot = int(dst._free.pop())
    dst.ctrl[dslot] = src.ctrl[slot]
    d = min(src.pkt_depth, dst.pkt_depth)
    cnt = min(int(src.ctrl["count"][slot]), d)
    dst.ctrl["count"][dslot] = cnt
    # destination payload rows are zero (init or recycle), so copying the
    # overlapping prefix leaves the rest as padding — the batch layout
    dst.ts[dslot, :d] = src.ts[slot, :d]
    dst.size[dslot, :d] = src.size[slot, :d]
    dst.direction[dslot, :d] = src.direction[slot, :d]
    dst.ttl[dslot, :d] = src.ttl[slot, :d]
    dst.winsize[dslot, :d] = src.winsize[slot, :d]
    dst.flags[dslot, :d] = src.flags[slot, :d]
    dst.proto[dslot] = src.proto[slot]
    dst.s_port[dslot] = src.s_port[slot]
    dst.d_port[dslot] = src.d_port[slot]
    # incremental aggregates are depth-independent whole-lifetime state:
    # they migrate bit-exactly. Anchors only transfer between same-plan
    # tables (matching anchor width) — a hot-swap to a different feature
    # plan clears them on the caller's side instead.
    if src.agg is not None and dst.agg is not None:
        dst.agg[dslot] = src.agg[slot]
    if (src.anchor is not None and dst.anchor is not None
            and src.anchor.shape[1] == dst.anchor.shape[1]):
        dst.anchor[dslot] = src.anchor[slot]
        dst.anchor_valid[dslot] = src.anchor_valid[slot]
    dst._index_insert(key, dslot, bucket)
    src.detach_slot(slot)
    src.metrics.flows_migrated_out += 1
    dst.metrics.flows_migrated_in += 1
    return dslot
