"""Elastic scaling + straggler mitigation primitives.

Port of `repro.train.elastic` (pure Python, the same code). Checkpoints
are device-agnostic (host copies of every leaf + a manifest), so a job
that loses hosts restarts on the surviving device set — `plan_remesh`
picks the largest (data × model) grid that preserves the model-parallel
degree when possible, and `restore` places the leaves on load.

Straggler mitigation: `StragglerMonitor` keeps a per-step EWMA and flags
outliers; at the launcher level the policy is (a) log + alert, (b) after
`evict_after` consecutive flags from the same host, drop it from the mesh
and trigger an elastic restart (the loop in launch/train.py implements
(a); (b) requires a cluster controller, stubbed with the same interface).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["plan_remesh", "StragglerMonitor"]


def plan_remesh(n_devices: int, prefer_model: int) -> tuple[int, int]:
    """Largest (data, model) grid for n_devices keeping model degree if able."""
    model = prefer_model
    while model > 1 and n_devices % model != 0:
        model //= 2
    data = n_devices // model
    return data, model


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    alpha: float = 0.1
    evict_after: int = 5
    _ewma: Optional[float] = None
    flags: int = 0
    consecutive: int = 0

    def observe(self, step_seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        if self._ewma is None:
            self._ewma = step_seconds
            return False
        is_straggler = step_seconds > self.factor * self._ewma
        if is_straggler:
            self.flags += 1
            self.consecutive += 1
        else:
            self.consecutive = 0
        # slow steps should not drag the baseline up
        if not is_straggler:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * step_seconds
        return is_straggler

    @property
    def should_evict(self) -> bool:
        return self.consecutive >= self.evict_after
