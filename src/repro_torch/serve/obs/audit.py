"""Structured control-plane audit log (DESIGN.md §11.3).

Port of `repro.serve.obs.audit`, unchanged but for its imports (numpy
only).

Every actuation the control plane performs — RETA rebalance, worker
scale-out/retirement, pipeline hot-swap, compile-to-deploy push — is
recorded as one `AuditEvent`: what was done, *why* the planner did it
(its rationale, stated against the numbers it saw), and the before/after
per-shard EWMA load snapshot. The log makes fleet behavior replayable
and explainable: an operator can line audit events up against the trace
timeline and the metrics deltas and reconstruct every decision.

Events are plain data (JSONL round-trip via ``save``/``load``), appended
in decision order with a monotone sequence number — the control plane is
single-threaded per fleet, so the sequence *is* the causal order.

Event timestamps are `now_pkts` — the replay packet clock (see
`repro_torch.serve.control.plane` for the unit's one canonical definition) —
never wall time. Documents written before the rename carried the key
``"t"``; `AuditEvent.from_doc` still reads it.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional

import numpy as np

__all__ = ["AuditEvent", "AuditLog"]

KINDS = ("rebalance", "scale_out", "retire", "hot_swap", "swap_scheduled",
         "deploy", "reopt", "slo")


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


@dataclasses.dataclass
class AuditEvent:
    """One control-plane decision, with its evidence."""

    seq: int                    # monotone per-log decision order
    now_pkts: float             # replay packet clock at the decision
    kind: str                   # one of KINDS
    rationale: str              # the planner's reason, in its own numbers
    detail: dict                # action-specific payload (moves, shard ids …)
    before: Optional[dict] = None  # shard-load EWMA snapshot pre-actuation
    after: Optional[dict] = None   # same, post-actuation

    @property
    def t(self) -> float:
        """Pre-rename alias for `now_pkts` (deprecated)."""
        return self.now_pkts

    def to_doc(self) -> dict:
        return _jsonable(dataclasses.asdict(self))

    @classmethod
    def from_doc(cls, d: dict) -> "AuditEvent":
        now_pkts = d["now_pkts"] if "now_pkts" in d else d["t"]
        return cls(
            seq=int(d["seq"]), now_pkts=float(now_pkts), kind=d["kind"],
            rationale=d["rationale"], detail=dict(d["detail"]),
            before=d.get("before"), after=d.get("after"),
        )


class AuditLog:
    def __init__(self) -> None:
        self.events: list[AuditEvent] = []

    def __len__(self) -> int:
        return len(self.events)

    def record(
        self,
        kind: str,
        now_pkts: float,
        rationale: str,
        detail: Optional[dict] = None,
        *,
        before: Optional[dict] = None,
        after: Optional[dict] = None,
    ) -> AuditEvent:
        if kind not in KINDS:
            raise ValueError(f"unknown audit kind {kind!r} (one of {KINDS})")
        ev = AuditEvent(
            seq=len(self.events), now_pkts=float(now_pkts), kind=kind,
            rationale=rationale, detail=_jsonable(detail or {}),
            before=_jsonable(before), after=_jsonable(after),
        )
        self.events.append(ev)
        return ev

    def of_kind(self, kind: str) -> list[AuditEvent]:
        return [e for e in self.events if e.kind == kind]

    def summary(self) -> dict:
        out: dict = {"events": len(self.events)}
        for k in KINDS:
            n = sum(1 for e in self.events if e.kind == k)
            if n:
                out[k] = n
        return out

    # -- persistence ---------------------------------------------------------

    def save(self, path) -> pathlib.Path:
        """One JSON document per line, in decision order."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            for e in self.events:
                f.write(json.dumps(e.to_doc()) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "AuditLog":
        log = cls()
        for line in pathlib.Path(path).read_text().splitlines():
            if line.strip():
                log.events.append(AuditEvent.from_doc(json.loads(line)))
        return log
