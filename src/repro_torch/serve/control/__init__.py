"""Adaptive serving control plane (DESIGN.md §9).

Port of `repro.serve.control`, unchanged but for its imports.

Closes the loop between runtime telemetry and runtime configuration for
the sharded serving fleet:

- **telemetry** (`BucketTelemetry`): per-RETA-bucket EWMA load, fed by
  the steered ingest path at one vector op per block;
- **planning** (`plan_rebalance`, `plan_retirement`, `HeadroomPolicy`):
  pure functions from telemetry to indirection rewrites and fleet sizes;
- **actuation** (`ControlPlane` + the runtime's `migrate_buckets` /
  `hot_swap`): quiescent flow-state migration so rewritten RETA entries
  never misroute a mid-flight flow, and per-shard drain-and-swap so a
  new Pareto-optimal (F, n) pipeline deploys with zero drops;
- **measurement** (`controlled_replay`): the offered-load replay
  for the adaptive fleet — interleaved per-shard clocks, control steps
  between blocks, zero-loss bisection compatible;
- **re-optimization** (`ReoptimizerPolicy` + `cato_retuner`): the
  drift-triggered episode state machine (DESIGN.md §13) that closes the
  outer loop — drift excursion → budgeted shadow re-tune → audited
  hot-swap through the same `schedule_swap` path as operator deploys.

The invariant every piece preserves: control actions permute *where* and
*when* work happens, never *what* is predicted — flows that complete
under a single pipeline configuration classify bit-identically to an
oracle single-worker run (tests/test_control.py).
"""
from .plane import ControlConfig, ControlPlane, PipelineSwap, StepReport
from .planner import HeadroomPolicy, plan_rebalance, plan_retirement
from .reoptimizer import (
    ReoptimizerConfig,
    ReoptimizerPolicy,
    ReoptOutcome,
    cato_retuner,
)
from .replay import controlled_replay
from .telemetry import BucketTelemetry

__all__ = [
    "BucketTelemetry",
    "ControlConfig",
    "ControlPlane",
    "HeadroomPolicy",
    "PipelineSwap",
    "ReoptOutcome",
    "ReoptimizerConfig",
    "ReoptimizerPolicy",
    "StepReport",
    "cato_retuner",
    "controlled_replay",
    "plan_rebalance",
    "plan_retirement",
]
