"""Bounded ring-buffer span tracer on the replay packet clock

Port of `repro.serve.obs.trace`,
unchanged but for its imports (numpy only).
(DESIGN.md §11.2).

Spans are recorded against *virtual* time — the same two-lane
`_WorkerClock` seconds every latency number already uses — so a trace of
a replay is exactly as deterministic as the replay itself. Two span
families:

- **worker stage spans** (Chrome ``ph: "X"`` complete events): per-block
  ingest service envelopes and per-batch inference service, charged by
  `_WorkerClock` on the lane that served them. ``pid`` is the shard,
  ``tid`` the lane (0 = ingest, 1 = inference, 2 = control).
- **flow lifecycle spans** (Chrome async ``b``/``n``/``e`` events keyed
  by flow id): ingest (first packet) → ready → flush (with reason) →
  emit (prediction resolved at the inference-lane completion edge).

Storage is a preallocated numpy ring of `capacity` events — recording
never allocates per event on the vectorized path and never grows; once
the ring wraps, the oldest events fall off (``dropped`` counts them).
Flows are sampled at `sample` by a deterministic hash threshold on the
flow id, so a 1% trace keeps *whole* lifecycles, never partial ones, and
two replays of the same stream sample the same flows.

`chrome()` exports the Chrome trace-event JSON (``chrome://tracing`` /
Perfetto load it directly); timestamps are exported in microseconds.

Tracing is **off by default** everywhere: every hook site guards on
``tracer is not None`` and the tracer itself no-ops when
``enabled=False``, so the untraced hot path pays one attribute test.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional

import numpy as np

__all__ = ["Tracer", "TID_INGEST", "TID_INFER", "TID_CONTROL", "TID_TENANT0"]

TID_INGEST = 0
TID_INFER = 1
TID_CONTROL = 2
# multi-tenant serving (DESIGN.md §15): per-tenant infer sub-lanes start
# here — tenant t's share of each fused batch lands on tid TID_TENANT0 + t
TID_TENANT0 = 3

_TID_NAMES = {TID_INGEST: "ingest lane", TID_INFER: "inference lane",
              TID_CONTROL: "control plane"}

# event phases, packed as u1
_PH_X, _PH_B, _PH_E, _PH_N, _PH_I = 0, 1, 2, 3, 4
_PH_CHR = {_PH_X: "X", _PH_B: "b", _PH_E: "e", _PH_N: "n", _PH_I: "i"}


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: uniform u64 from flow ids (sampling hash)."""
    x = np.asarray(x).astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class Tracer:
    def __init__(
        self,
        capacity: int = 1 << 16,
        sample: float = 1.0,
        enabled: bool = True,
        seed: int = 0,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not 0.0 <= sample <= 1.0:
            raise ValueError("sample must be in [0, 1]")
        self.capacity = int(capacity)
        self.sample = float(sample)
        self.enabled = bool(enabled)
        # threshold comparison against the mixed id; seed shifts the hash
        # so distinct tracers can sample distinct flow subsets
        self._seed = np.uint64(seed)
        self._thresh = np.uint64(min(int(sample * float(2**64)), 2**64 - 1))
        self._sample_all = sample >= 1.0
        cap = self.capacity
        self._ph = np.zeros(cap, np.uint8)
        self._name = np.zeros(cap, np.int32)
        self._ts = np.zeros(cap, np.float64)    # virtual seconds
        self._dur = np.zeros(cap, np.float64)
        self._pid = np.zeros(cap, np.int32)
        self._tid = np.zeros(cap, np.int32)
        self._id = np.zeros(cap, np.int64)      # flow id for async events
        self._names: list[str] = []
        self._intern: dict[str, int] = {}
        self.total = 0                           # events ever recorded

    # -- bookkeeping ---------------------------------------------------------

    def __len__(self) -> int:
        return min(self.total, self.capacity)

    @property
    def dropped(self) -> int:
        """Events that fell off the ring (oldest-first)."""
        return max(0, self.total - self.capacity)

    def _name_id(self, name: str) -> int:
        i = self._intern.get(name)
        if i is None:
            i = len(self._names)
            self._names.append(name)
            self._intern[name] = i
        return i

    def _slots(self, k: int) -> np.ndarray:
        idx = (self.total + np.arange(k)) % self.capacity
        self.total += k
        return idx

    # -- sampling ------------------------------------------------------------

    def sample_mask(self, flow_ids: np.ndarray) -> np.ndarray:
        """Deterministic per-flow keep mask at the configured rate."""
        if self._sample_all:
            return np.ones(len(flow_ids), bool)
        if self.sample <= 0.0:
            return np.zeros(len(flow_ids), bool)
        return _mix64(np.asarray(flow_ids, np.int64) + np.int64(self._seed)) \
            < self._thresh

    # -- recording (vectorized; every method no-ops when disabled) -----------

    def span(self, name: str, ts: float, dur: float, *, pid: int = 0,
             tid: int = 0) -> None:
        if not self.enabled:
            return
        self.span_many(name, np.asarray([ts]), np.asarray([dur]),
                       pid=pid, tid=tid)

    def span_many(self, name: str, ts: np.ndarray, dur: np.ndarray, *,
                  pid: int = 0, tid: int = 0) -> None:
        """One ``X`` complete event per (ts, dur) pair."""
        if not self.enabled or len(ts) == 0:
            return
        idx = self._slots(len(ts))
        self._ph[idx] = _PH_X
        self._name[idx] = self._name_id(name)
        self._ts[idx] = ts
        self._dur[idx] = np.maximum(dur, 0.0)
        self._pid[idx] = pid
        self._tid[idx] = tid
        self._id[idx] = -1

    def instant(self, name: str, now_pkts: float, *, pid: int = 0,
                tid: int = 0) -> None:
        """One point event at `now_pkts` on the replay packet clock (the
        unit is the control plane's, `serve/control/plane.py` in the
        reference)."""
        if not self.enabled:
            return
        idx = self._slots(1)
        self._ph[idx] = _PH_I
        self._name[idx] = self._name_id(name)
        self._ts[idx] = now_pkts
        self._dur[idx] = 0.0
        self._pid[idx] = pid
        self._tid[idx] = tid
        self._id[idx] = -1

    def _flow_event(self, ph: int, name: str, ids: np.ndarray,
                    ts: np.ndarray, pid: int) -> None:
        if not self.enabled or len(ids) == 0:
            return
        idx = self._slots(len(ids))
        self._ph[idx] = ph
        self._name[idx] = self._name_id(name)
        self._ts[idx] = ts
        self._dur[idx] = 0.0
        self._pid[idx] = pid
        self._tid[idx] = TID_INGEST
        self._id[idx] = np.asarray(ids, np.int64)

    def flow_begin(self, ids: np.ndarray, ts: np.ndarray, *,
                   pid: int = 0) -> None:
        """Open one async lifecycle span per flow at its first-packet time."""
        self._flow_event(_PH_B, "flow", ids, ts, pid)

    def flow_mark(self, name: str, ids: np.ndarray, ts: np.ndarray, *,
                  pid: int = 0) -> None:
        """Milestone inside open lifecycles (ready / flush.reason / ...)."""
        self._flow_event(_PH_N, name, ids, ts, pid)

    def flow_end(self, ids: np.ndarray, ts: np.ndarray, *,
                 pid: int = 0) -> None:
        """Close lifecycles at the prediction-emit edge."""
        self._flow_event(_PH_E, "flow", ids, ts, pid)

    # -- export --------------------------------------------------------------

    def events(self) -> list[dict]:
        """Ring contents in record order as Chrome trace-event dicts."""
        n = len(self)
        if n == 0:
            return []
        if self.total <= self.capacity:
            order = np.arange(n)
        else:  # wrapped: oldest surviving event first
            order = (self.total + np.arange(self.capacity)) % self.capacity
        out = []
        for i in order:
            ph = int(self._ph[i])
            ev = {
                "name": self._names[int(self._name[i])],
                "ph": _PH_CHR[ph],
                "ts": float(self._ts[i]) * 1e6,   # Chrome wants microseconds
                "pid": int(self._pid[i]),
                "tid": int(self._tid[i]),
            }
            if ph == _PH_X:
                ev["dur"] = float(self._dur[i]) * 1e6
            elif ph == _PH_I:
                ev["s"] = "t"
            else:  # async lifecycle event
                ev["cat"] = "flow"
                ev["id"] = int(self._id[i])
            out.append(ev)
        return out

    def chrome(self) -> dict:
        """Full Chrome trace-event document (with lane/shard labels)."""
        meta = []
        pids = sorted({int(p) for p in
                       self._pid[: len(self)].tolist()}) if len(self) else []
        tids = sorted({int(t) for t in self._tid[: len(self)].tolist()}) \
            if len(self) else []
        for pid in pids:
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "args": {"name": f"shard {pid}"}})
            for tid, label in _TID_NAMES.items():
                meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                             "tid": tid, "args": {"name": label}})
            for tid in tids:
                if tid >= TID_TENANT0:
                    meta.append({
                        "ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid,
                        "args": {"name": f"tenant {tid - TID_TENANT0} infer"},
                    })
        return {
            "traceEvents": meta + self.events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "clock": "virtual (replay packet clock)",
                "sample_rate": self.sample,
                "events_recorded": self.total,
                "events_dropped": self.dropped,
            },
        }

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.chrome()) + "\n")
        return path

    def summary(self) -> Optional[dict]:
        if self.total == 0:
            return None
        return {
            "events": self.total,
            "retained": len(self),
            "dropped": self.dropped,
            "capacity": self.capacity,
            "sample": self.sample,
        }
