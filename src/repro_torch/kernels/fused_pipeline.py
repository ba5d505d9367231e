"""Fused extract+infer: the CUDA kernel B2 and its plain version.

Port of the window entry of `repro.kernels.fused_pipeline`. The unfused
pipeline writes the ``(N, F)`` feature matrix to device memory and reads it
back in the forest kernel; the fused kernel (``csrc/fused_pipeline.cu``)
computes each flow's columns in the thread that owns the flow and walks
the forest on them in the same launch.

The reference specialises its kernel per static stats plan through jit.
Here the plan is encoded once per pipeline as an int32 op table
(`encode_plan`): one row of (kind, direction, field, stat) per column,
which the one compiled kernel interprets. No nvcc runs on the serving path,
so a warmed replacement pipeline can be swapped in without a compile
(DESIGN.md §9.3).

`fused_forest_infer` picks its path from the device of the packet tensors:
CUDA tensors go to `fused_pipeline_call` (the kernel), CPU tensors to
`fused_forest_infer_plain`, which decodes the table back to the plan, runs
`emit_feature_columns` and the plain traversal — the reference's
`_traverse` order, shared with `tree_infer.forest_infer_plain`.

The aggregate entry (DESIGN.md §12) is the same pair for a refresh batch of
the reuse path: `fused_agg_call` launches B3 (``csrc/fused_agg.cu``),
which computes an incremental plan's columns from each flow's (53,)
float32 aggregate row instead of its packet window;
`fused_agg_infer_plain` runs the torch `emit_agg_features` and the plain
traversal; `fused_agg_infer` picks by device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..traffic.extraction import AGG_WIDTH, emit_agg_features, emit_feature_columns
from ._build import check_tensor, launch
from .tree_infer import MAX_CLASSES, MAX_DEPTH, forest_infer_plain, tree_blocking

__all__ = ["encode_plan", "decode_plan", "fused_forest_infer",
           "fused_forest_infer_plain", "fused_pipeline_call",
           "fused_agg_call", "fused_agg_infer", "fused_agg_infer_plain",
           "MAX_FEATURES", "MAX_WINDOW"]

MAX_FEATURES = 128  # kMaxFeatures in csrc/fused_pipeline.cu and fused_agg.cu
MAX_WINDOW = 128    # kMaxWindow: the most packets a flow's window may hold

# op-table codes, as the enums of csrc/fused_pipeline.cu number them
_KINDS = ("dur", "meta", "load", "pkt_cnt", "handshake", "flag_cnt", "stat")
_DIRS = ("s", "d")
_FIELDS = {
    "meta": ("proto", "s_port", "d_port"),
    "handshake": ("tcp_rtt", "syn_ack", "ack_dat"),
    "stat": ("bytes", "iat", "winsize", "ttl"),
}
_STATS = ("sum", "mean", "min", "max", "med", "std")


def encode_plan(plan: tuple[tuple, ...]) -> np.ndarray:
    """The (F, 4) int32 op table of a `stats_plan`: kind, direction,
    field, stat per column (unused slots 0)."""
    rows = []
    for e in plan:
        kind = e[0]
        row = [_KINDS.index(kind), 0, 0, 0]
        if kind in ("meta", "handshake"):
            row[2] = _FIELDS[kind].index(e[1])
        elif kind in ("load", "pkt_cnt"):
            row[1] = _DIRS.index(e[1])
        elif kind == "flag_cnt":
            row[2] = int(e[1])
        elif kind == "stat":
            row[1:] = [_DIRS.index(e[1]), _FIELDS["stat"].index(e[2]),
                       _STATS.index(e[3])]
        rows.append(row)
    return np.asarray(rows, np.int32).reshape(len(plan), 4)


def decode_plan(table) -> tuple[tuple, ...]:
    """Inverse of `encode_plan` (takes the array or a tensor)."""
    plan = []
    for kind_i, d, field, stat in torch.as_tensor(table).tolist():
        kind = _KINDS[kind_i]
        if kind == "dur":
            plan.append(("dur",))
        elif kind in ("meta", "handshake"):
            plan.append((kind, _FIELDS[kind][field]))
        elif kind in ("load", "pkt_cnt"):
            plan.append((kind, _DIRS[d]))
        elif kind == "flag_cnt":
            plan.append(("flag_cnt", field))
        else:
            plan.append(("stat", _DIRS[d], _FIELDS["stat"][field], _STATS[stat]))
    return tuple(plan)


def _check_forest(feature, threshold, leaf, forest_depth: int, dev) -> tuple:
    """Check the forest tables a fused kernel takes; returns (T, K)."""
    if feature.ndim != 2 or leaf.ndim != 3:
        raise ValueError("expected feature (T, NI), leaf (T, NL, K)")
    if not 0 <= forest_depth <= MAX_DEPTH:
        raise ValueError(f"forest depth {forest_depth} outside [0, {MAX_DEPTH}]")
    T, K = feature.shape[0], leaf.shape[2]
    if T < 1 or not 1 <= K <= MAX_CLASSES:
        raise ValueError(f"need >= 1 tree and 1..{MAX_CLASSES} classes, "
                         f"got T={T}, K={K}")
    ni = 2 ** forest_depth - 1
    check_tensor("feature", feature, torch.int32, (T, ni), dev)
    check_tensor("threshold", threshold, torch.float32, (T, ni), dev)
    check_tensor("leaf", leaf, torch.float32, (T, ni + 1, K), dev)
    return T, K


def fused_forest_infer_plain(
    ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port, d_port,
    feature, threshold, leaf, *, op_table, depth: int, forest_depth: int,
    block_t: int = 8, columns: torch.Tensor | None = None,
) -> torch.Tensor:
    """The fused pipeline in torch ops: plan columns, then the plain
    traversal. If `columns` is given, the (N, F) columns are copied into it.
    """
    x = torch.stack(emit_feature_columns(
        decode_plan(op_table), ts=ts, size=size, direction=direction, ttl=ttl,
        winsize=winsize, flags=flags, flow_len=flow_len, proto=proto,
        s_port=s_port, d_port=d_port, depth=depth), dim=1)
    if columns is not None:
        columns.copy_(x)
    return forest_infer_plain(x, feature, threshold, leaf, forest_depth,
                              block_t=block_t)


def fused_pipeline_call(
    ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port, d_port,
    feature, threshold, leaf, *, op_table, depth: int, forest_depth: int,
    block_t: int = 8, columns: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the B2 CUDA kernel; returns (N, K) float32 probabilities.

    Takes float32 ts/size/ttl/winsize (N, P), uint8 direction (N, P) and
    flags (N, P, 8), int32 flow_len and float32 proto/s_port/d_port (N,),
    the forest tables as `forest_infer_kernel_call` takes them, and the
    int32 (F, 4) `op_table` from `encode_plan`, all contiguous on one CUDA
    device. The kernel reads the first ``min(P, depth)`` packets of each
    row, which may be at most MAX_WINDOW; F may be at most MAX_FEATURES.
    `columns`, if given, is an (N, F) float32 buffer that receives the
    kernel's own feature columns. Launches on the current stream and does
    not synchronise.
    """
    dev = ts.device
    if ts.ndim != 2 or op_table.ndim != 2:
        raise ValueError("expected ts (N, P), op_table (F, 4)")
    N, P = ts.shape
    nf = op_table.shape[0]
    if not 1 <= nf <= MAX_FEATURES:
        raise ValueError(f"plan has {nf} columns; the kernel takes 1..{MAX_FEATURES}")
    if min(P, depth) > MAX_WINDOW:
        raise ValueError(f"packet window min(P={P}, depth={depth}) exceeds "
                         f"the kernel's {MAX_WINDOW}")
    T, K = _check_forest(feature, threshold, leaf, forest_depth, dev)
    for name, t in (("ts", ts), ("size", size), ("ttl", ttl),
                    ("winsize", winsize)):
        check_tensor(name, t, torch.float32, (N, P), dev)
    check_tensor("direction", direction, torch.uint8, (N, P), dev)
    check_tensor("flags", flags, torch.uint8, (N, P, 8), dev)
    check_tensor("flow_len", flow_len, torch.int32, (N,), dev)
    for name, t in (("proto", proto), ("s_port", s_port), ("d_port", d_port)):
        check_tensor(name, t, torch.float32, (N,), dev)
    check_tensor("op_table", op_table, torch.int32, (nf, 4), dev)
    if columns is not None:
        check_tensor("columns", columns, torch.float32, (N, nf), dev)
    out = torch.empty((N, K), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    bt, tp, rescale = tree_blocking(T, block_t)
    launch("fused_forest_infer_launch", dev,
           ts.data_ptr(), size.data_ptr(), direction.data_ptr(),
           ttl.data_ptr(), winsize.data_ptr(), flags.data_ptr(),
           flow_len.data_ptr(), proto.data_ptr(), s_port.data_ptr(),
           d_port.data_ptr(), op_table.data_ptr(), feature.data_ptr(),
           threshold.data_ptr(), leaf.data_ptr(), out.data_ptr(),
           None if columns is None else columns.data_ptr(),
           N, P, nf, depth, forest_depth, T, K, bt, tp, rescale)
    fused_pipeline_call.launches += 1
    return out


fused_pipeline_call.launches = 0


def fused_forest_infer(
    ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port, d_port,
    feature, threshold, leaf, *, op_table, depth: int, forest_depth: int,
    block_t: int = 8, columns: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused pipeline entry: packets -> class probabilities, one launch on
    CUDA tensors, the plain version on CPU tensors."""
    fn = fused_pipeline_call if ts.is_cuda else fused_forest_infer_plain
    return fn(ts, size, direction, ttl, winsize, flags, flow_len, proto,
              s_port, d_port, feature, threshold, leaf, op_table=op_table,
              depth=depth, forest_depth=forest_depth, block_t=block_t,
              columns=columns)


def fused_agg_infer_plain(
    agg, meta, feature, threshold, leaf, *, op_table, forest_depth: int,
    block_t: int = 8, columns: torch.Tensor | None = None,
) -> torch.Tensor:
    """The aggregate entry in torch ops: the torch `emit_agg_features`
    over float32 (N, AGG_WIDTH) rows and (N, 3) meta (proto, s_port,
    d_port), then the plain traversal. If `columns` is given, the (N, F)
    columns are copied into it."""
    x = torch.stack(emit_agg_features(
        decode_plan(op_table), agg, proto=meta[:, 0], s_port=meta[:, 1],
        d_port=meta[:, 2]), dim=1)
    if columns is not None:
        columns.copy_(x)
    return forest_infer_plain(x, feature, threshold, leaf, forest_depth,
                              block_t=block_t)


def fused_agg_call(
    agg, meta, feature, threshold, leaf, *, op_table, forest_depth: int,
    block_t: int = 8, columns: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the B3 CUDA kernel; returns (N, K) float32 probabilities.

    Takes float32 `agg` (N, AGG_WIDTH) and `meta` (N, 3) = proto, s_port,
    d_port, the forest tables as `forest_infer_kernel_call` takes them, and
    the int32 (F, 4) `op_table` from `encode_plan` of an incremental plan
    (no median), all contiguous on one CUDA device. Padding rows may be all
    zero: they yield an all-zero feature row. `columns`, if given, is an
    (N, F) float32 buffer that receives the kernel's own feature columns.
    Launches on the current stream; its one wait is the read-back of the
    op table for the median check (a refresh batch resolves at once
    anyway).
    """
    dev = agg.device
    if agg.ndim != 2 or op_table.ndim != 2:
        raise ValueError("expected agg (N, AGG_WIDTH), op_table (F, 4)")
    N = agg.shape[0]
    nf = op_table.shape[0]
    if not 1 <= nf <= MAX_FEATURES:
        raise ValueError(f"plan has {nf} columns; the kernel takes 1..{MAX_FEATURES}")
    stat = op_table[:, 3][op_table[:, 0] == _KINDS.index("stat")]
    if bool((stat == _STATS.index("med")).any()):
        raise ValueError("the plan has a median, which has no incremental "
                         "form: the aggregate kernel takes incremental plans "
                         "only")
    T, K = _check_forest(feature, threshold, leaf, forest_depth, dev)
    check_tensor("agg", agg, torch.float32, (N, AGG_WIDTH), dev)
    check_tensor("meta", meta, torch.float32, (N, 3), dev)
    check_tensor("op_table", op_table, torch.int32, (nf, 4), dev)
    if columns is not None:
        check_tensor("columns", columns, torch.float32, (N, nf), dev)
    out = torch.empty((N, K), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    bt, tp, rescale = tree_blocking(T, block_t)
    launch("fused_agg_infer_launch", dev,
           agg.data_ptr(), meta.data_ptr(), op_table.data_ptr(),
           feature.data_ptr(), threshold.data_ptr(), leaf.data_ptr(),
           out.data_ptr(), None if columns is None else columns.data_ptr(),
           N, nf, forest_depth, T, K, bt, tp, rescale)
    fused_agg_call.launches += 1
    return out


fused_agg_call.launches = 0


def fused_agg_infer(
    agg, proto, s_port, d_port, feature, threshold, leaf, *, op_table,
    forest_depth: int, block_t: int = 8, columns: torch.Tensor | None = None,
) -> torch.Tensor:
    """Aggregate entry: (N, AGG_WIDTH) rows -> class probabilities, one
    launch on CUDA tensors, the plain version on CPU tensors. `agg` is
    rounded to float32 first, as the reference's ``agg.astype(float32)``
    does; the per-flow meta are (N,) float32."""
    meta = torch.stack([proto, s_port, d_port], dim=1)
    fn = fused_agg_call if agg.is_cuda else fused_agg_infer_plain
    return fn(agg.to(torch.float32), meta, feature, threshold, leaf,
              op_table=op_table, forest_depth=forest_depth, block_t=block_t,
              columns=columns)
