"""Distribution layer: logical-axis sharding rules and parallel context.

Port of `repro.parallel` (its sharding half; the collectives wait for the
multi-card slice)."""
from .sharding import (
    ParallelCtx,
    constrain,
    current_ctx,
    default_rules,
    maybe_axis,
    param_pspecs,
    parallel_ctx,
)

__all__ = [
    "ParallelCtx",
    "constrain",
    "current_ctx",
    "default_rules",
    "maybe_axis",
    "param_pspecs",
    "parallel_ctx",
]
