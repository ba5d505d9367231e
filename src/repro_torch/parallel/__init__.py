"""Distribution layer: logical-axis sharding rules, the parallel context,
cutting tensors by a spec, and the collectives over a mesh's process
groups.

Port of `repro.parallel`."""
from .collectives import (
    all_gather,
    all_to_all,
    compressed_pod_psum,
    hierarchical_psum,
    int8_decode,
    int8_encode,
    psum,
    psum_scatter,
)
from .sharding import (
    ParallelCtx,
    constrain,
    current_ctx,
    default_rules,
    gather_full,
    local_shard,
    maybe_axis,
    param_pspecs,
    parallel_ctx,
    shard_module,
)

__all__ = [
    "ParallelCtx",
    "all_gather",
    "all_to_all",
    "compressed_pod_psum",
    "constrain",
    "current_ctx",
    "default_rules",
    "gather_full",
    "hierarchical_psum",
    "int8_decode",
    "int8_encode",
    "local_shard",
    "maybe_axis",
    "param_pspecs",
    "parallel_ctx",
    "psum",
    "psum_scatter",
    "shard_module",
]
