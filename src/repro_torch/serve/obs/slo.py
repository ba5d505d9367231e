"""Windowed SLO tracking on the replay packet clock (DESIGN.md §14.2).

Port of `repro.serve.obs.slo`, unchanged but for its imports (numpy only).

An SLO here is "fraction of flows whose enqueue→prediction latency is
within ``target_s`` must be at least ``objective``" — attainment, not a
single percentile, so it composes across windows and shards by integer
addition. `SLOTracker` buckets every charged flow into fixed windows of
the *virtual* packet clock (the same `now_pkts` timeline the control
plane steps on), and `check` folds them into the two-window burn-rate
form of error-budget accounting:

- the **fast** window (the current window) catches an ongoing breach
  quickly;
- the **slow** window (the last `slow_windows` windows) filters
  one-window blips.

``burn = violation_fraction / (1 - objective)`` — burn 1.0 means the
error budget is being spent exactly at the rate that would exhaust it,
sustained. A breach verdict requires *both* burns at or above
``burn_threshold`` with at least one sample in the fast window; the
tracker reports rising edges (``new_breach``) so `ControlPlane` audits
one ``"slo"`` event per episode, not one per control step.

All mutable state is per-window integer pairs ``(total, violations)``
plus lifetime counters, so a single tracker can be shared by every
shard's `_WorkerClock` and `merge_from` is order-independent like the
rest of the registry.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..runtime.metrics import METRIC_NAMESPACE

__all__ = ["SLOConfig", "SLOTracker", "SLOVerdict"]


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Latency objective on the replay packet clock.

    `target_s` is the per-flow latency bound; `objective` the required
    attainment (0.99 = "p99 within target"); `window_s` the fast-window
    length in *virtual* seconds — size it to the replayed trace span
    (smoke traces cover well under a second of virtual time)."""

    target_s: float
    objective: float = 0.99
    window_s: float = 0.05
    slow_windows: int = 8
    burn_threshold: float = 1.0

    def __post_init__(self):
        if self.target_s <= 0:
            raise ValueError(f"target_s must be > 0, got {self.target_s}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {self.objective}")
        if self.window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")
        if self.slow_windows < 1:
            raise ValueError(f"slow_windows must be >= 1, got {self.slow_windows}")


@dataclasses.dataclass(frozen=True)
class SLOVerdict:
    """One `check` result. `new_breach` is True only on the rising edge
    into breach, so audit consumers fire once per episode."""

    breached: bool
    new_breach: bool
    attainment_fast: float
    attainment_slow: float
    burn_fast: float
    burn_slow: float
    samples_fast: int
    samples_slow: int
    target_s: float
    objective: float

    def to_doc(self) -> dict:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, float):
                d[k] = round(v, 6)
        return d


class SLOTracker:
    """Shared, mergeable attainment/burn-rate accountant.

    `note` is the hot-path write: one float compare + two dict adds per
    charged batch. `check` (control-step cadence) is the only reader
    and the only place breach state transitions."""

    def __init__(self, config: SLOConfig):
        self.config = config
        self._total: dict[int, int] = {}
        self._viol: dict[int, int] = {}
        self.samples = 0
        self.violations = 0
        self.checks = 0
        self.breaches = 0          # rising edges seen by check()
        self._breached = False

    # -- writes --------------------------------------------------------------

    def note(self, done_s: float, latency_s: np.ndarray) -> None:
        """Account one resolved batch: all flows in it complete at
        `done_s` on the packet clock, so they share a window."""
        lat = np.asarray(latency_s, np.float64)
        n = int(lat.size)
        if n == 0:
            return
        v = int((lat > self.config.target_s).sum())
        w = int(math.floor(done_s / self.config.window_s))
        self._total[w] = self._total.get(w, 0) + n
        self.samples += n
        if v:
            self._viol[w] = self._viol.get(w, 0) + v
            self.violations += v

    def merge_from(self, other: "SLOTracker") -> None:
        """Integer window adds — order-independent. Breach edge state is
        deliberately not merged; merged trackers are reporting views."""
        if other.config != self.config:
            raise ValueError(
                f"SLO config mismatch: {other.config} vs {self.config}")
        for w, n in other._total.items():
            self._total[w] = self._total.get(w, 0) + n
        for w, v in other._viol.items():
            self._viol[w] = self._viol.get(w, 0) + v
        self.samples += other.samples
        self.violations += other.violations

    # -- reads ---------------------------------------------------------------

    def _span(self, w_hi: int, k: int) -> tuple[int, int]:
        """(total, violations) over window indices [w_hi - k + 1, w_hi]."""
        lo = w_hi - k + 1
        tot = sum(n for w, n in self._total.items() if lo <= w <= w_hi)
        if tot == 0:
            return 0, 0
        bad = sum(v for w, v in self._viol.items() if lo <= w <= w_hi)
        return tot, bad

    def check(self, now_s: float) -> SLOVerdict:
        """Fold windows ending at `now_s` into a burn-rate verdict and
        advance the breach edge state."""
        cfg = self.config
        w_hi = int(math.floor(now_s / cfg.window_s))
        tot_f, bad_f = self._span(w_hi, 1)
        tot_s, bad_s = self._span(w_hi, cfg.slow_windows)
        budget = 1.0 - cfg.objective
        frac_f = bad_f / tot_f if tot_f else 0.0
        frac_s = bad_s / tot_s if tot_s else 0.0
        burn_f = frac_f / budget
        burn_s = frac_s / budget
        breached = (tot_f > 0 and burn_f >= cfg.burn_threshold
                    and burn_s >= cfg.burn_threshold)
        new = breached and not self._breached
        if new:
            self.breaches += 1
        self._breached = breached
        self.checks += 1
        return SLOVerdict(
            breached=breached,
            new_breach=new,
            attainment_fast=1.0 - frac_f,
            attainment_slow=1.0 - frac_s,
            burn_fast=burn_f,
            burn_slow=burn_s,
            samples_fast=tot_f,
            samples_slow=tot_s,
            target_s=cfg.target_s,
            objective=cfg.objective,
        )

    @property
    def attainment(self) -> float:
        """Lifetime attainment across all windows."""
        return 1.0 - self.violations / self.samples if self.samples else 1.0

    def windows(self) -> list[tuple[int, int, int]]:
        """Sorted (window_index, total, violations) rows."""
        return [(w, n, self._viol.get(w, 0))
                for w, n in sorted(self._total.items())]

    def signal(self) -> dict:
        """Compact JSON-able state for snapshots and JSONL export."""
        return {
            "target_s": self.config.target_s,
            "objective": self.config.objective,
            "window_s": self.config.window_s,
            "samples": self.samples,
            "violations": self.violations,
            "attainment": round(self.attainment, 6),
            "breaches": self.breaches,
            "breached": self._breached,
            "windows": [[w, n, v] for w, n, v in self.windows()],
        }

    def to_registry(self, registry=None, prefix: str = ""):
        """Project lifetime counters + current verdict-shape gauges into
        a `MetricsRegistry` under the `slo.*` namespace."""
        from .registry import MetricsRegistry

        reg = registry if registry is not None else MetricsRegistry()
        ns = METRIC_NAMESPACE
        reg.inc(prefix + ns["slo_samples"], self.samples)
        reg.inc(prefix + ns["slo_violations"], self.violations)
        reg.inc(prefix + ns["slo_breaches"], self.breaches)
        reg.set_gauge(prefix + ns["slo_attainment"], self.attainment,
                      reduce="min")
        reg.set_gauge(prefix + ns["slo_breached"],
                      1.0 if self._breached else 0.0, reduce="max")
        return reg
