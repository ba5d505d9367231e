"""Fused extract+infer: the CUDA kernel B2 and its plain version.

Port of the window entry of `repro.kernels.fused_pipeline`. The unfused
pipeline writes the ``(N, F)`` feature matrix to device memory and reads it
back in the forest kernel; the fused kernel (``csrc/fused_pipeline.cu``)
computes each flow's columns in the warp that owns the flow (its lanes over
the columns, then over the trees) and walks the forest on them in the same
launch.

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
the reuse path: `fused_agg_call` launches B3 (``csrc/fused_agg.cu``, a
warp per flow as B2), which computes an incremental plan's columns from
each flow's (53,) float32 aggregate row instead of its packet window;
`fused_agg_infer_plain` runs the torch `emit_agg_features` and the plain
traversal; `fused_agg_infer` picks by device. A plan with a median has no
incremental form: `agg_op_table` refuses it on the host, once, before
the table goes to the card, and `fused_agg_call` takes only CUDA tables
made so, so that a launch never reads the card back.

The multi-tenant entry (DESIGN.md §15) serves N tenants in one launch:
`fused_multi_forest_call` launches B4 (``csrc/fused_multi.cu``, a warp per
flow as B2), which computes a merged plan's columns once per flow, each
depth group over its own window slice, then walks every tenant's forest,
stacked on the tree axis by `stack_multi_forests`, into the tenant's own
output lanes.
`fused_multi_forest_infer_plain` runs the torch `emit_merged_columns` and
the plain traversal per tenant; `fused_multi_forest_infer` picks by device.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ..traffic.extraction import (
    AGG_WIDTH,
    emit_agg_features,
    emit_feature_columns,
    emit_merged_columns,
)
from ._build import check_tensor, launch
from .tree_infer import (
    MAX_CLASSES,
    MAX_DEPTH,
    forest_infer_plain,
    pad_forest_blocks,
    tree_blocking,
)

__all__ = ["agg_op_table", "encode_plan", "decode_plan", "fused_forest_infer",
           "fused_forest_infer_plain", "fused_pipeline_call",
           "fused_agg_call", "fused_agg_infer", "fused_agg_infer_plain",
           "encode_merged_plan", "decode_merged_plan", "stack_multi_forests",
           "fused_multi_forest_call", "fused_multi_forest_infer",
           "fused_multi_forest_infer_plain", "MAX_FEATURES",
           "MAX_MERGED_COLUMNS", "MAX_WINDOW", "SPEC_FIELDS"]

MAX_FEATURES = 128  # kMaxFeatures in csrc/fused_pipeline.cu and fused_agg.cu
# kMaxMergedColumns in csrc/fused_multi.cu: the most merged columns B4 keeps
# in shared memory; a wider merged plan keeps them in the (N, F) `columns`
# buffer
MAX_MERGED_COLUMNS = 4096
# kChunk in csrc/plan_warp.cuh (B2's and B4's shared-memory window); a
# longer window W = min(P, depth) keeps a median's samples in an (N, W)
# scratch instead
MAX_WINDOW = 128
# B4's per-tenant spec row (csrc/fused_multi.cu `Spec`): tree offset, trees,
# padded trees, forest depth, tree block, classes, lane offset
SPEC_FIELDS = ("offset", "trees", "trees_padded", "depth", "block_t",
               "classes", "lane")

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


def _window_scratch(N: int, window: int, dev) -> torch.Tensor | None:
    """A window's (N, window) float32 sample scratch, or None when the
    window fits the kernels' shared-memory buffer: B2 and B4 put a median's
    samples in the flow's row, contiguous for the warp that owns it."""
    if window <= MAX_WINDOW:
        return None
    return torch.empty((N, window), dtype=torch.float32, device=dev)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


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
    row; above MAX_WINDOW packets it stages the window in chunks and a
    median's samples go to a scratch allocated here. F may be at most
    MAX_FEATURES. `columns`, if given, is an (N, F) float32 buffer that
    receives the kernel's own feature columns. Launches on the current
    stream and does not synchronise.
    """
    dev = ts.device
    if ts.ndim != 2 or op_table.ndim != 2:
        raise ValueError("expected ts (N, P), op_table (F, 4)")
    N, P = ts.shape
    nf = op_table.shape[0]
    if not 1 <= nf <= MAX_FEATURES:
        raise ValueError(f"plan has {nf} columns; the kernel takes 1..{MAX_FEATURES}")
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
    scratch = _window_scratch(N, min(P, depth), dev)
    launch("fused_forest_infer_launch", dev,
           ts.data_ptr(), size.data_ptr(), direction.data_ptr(),
           ttl.data_ptr(), winsize.data_ptr(), flags.data_ptr(),
           flow_len.data_ptr(), proto.data_ptr(), s_port.data_ptr(),
           d_port.data_ptr(), op_table.data_ptr(), feature.data_ptr(),
           threshold.data_ptr(), leaf.data_ptr(), out.data_ptr(),
           _ptr(columns), _ptr(scratch),
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


# CUDA op tables that `agg_op_table` checked for a median on the host, by
# identity and version (an edit in place makes a table new)
_AGG_TABLES: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


def _refuse_median(table: torch.Tensor) -> None:
    """Raise if a host (F, 4) op table has a median column."""
    stat = table[:, 3][table[:, 0] == _KINDS.index("stat")]
    if bool((stat == _STATS.index("med")).any()):
        raise ValueError("the plan has a median, which has no incremental "
                         "form: the aggregate kernel takes incremental plans "
                         "only")


def agg_op_table(table, device) -> torch.Tensor:
    """The (F, 4) int32 op table of an incremental plan on `device`, as
    `fused_agg_call` takes it: `table` (from `encode_plan`, an array or a
    CPU tensor) is checked for a median on the host before it goes there."""
    host = torch.as_tensor(table)
    if host.device.type != "cpu":
        raise ValueError(f"the op table is on {host.device}: give the host's")
    _refuse_median(host)
    out = host.to(device=device, dtype=torch.int32).contiguous()
    if out.is_cuda:
        _AGG_TABLES[(id(out), out._version)] = out
    return out


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
    the int32 (F, 4) `op_table` of an incremental plan (no median) from
    `agg_op_table`, all contiguous on one CUDA device. A host op table is
    checked for a median here, so that one raises too; a CUDA one made
    otherwise raises, since checking it would read the card. Padding rows
    may be all zero: they yield an all-zero feature row. `columns`, if
    given, is an (N, F) float32 buffer that receives the kernel's own
    feature columns. Launches on the current stream, reads nothing back
    and does not synchronise, so a CUDA graph can capture it.
    """
    dev = agg.device
    if agg.ndim != 2 or op_table.ndim != 2:
        raise ValueError("expected agg (N, AGG_WIDTH), op_table (F, 4)")
    N = agg.shape[0]
    nf = op_table.shape[0]
    if not 1 <= nf <= MAX_FEATURES:
        raise ValueError(f"plan has {nf} columns; the kernel takes 1..{MAX_FEATURES}")
    if op_table.device.type == "cpu":
        _refuse_median(op_table)
    elif _AGG_TABLES.get((id(op_table), op_table._version)) is not op_table:
        raise ValueError("a CUDA op table for the aggregate kernel comes from "
                         "agg_op_table, which checks it for a median on the "
                         "host")
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


# ---------------------------------------------------------------------------
# multi-tenant entry (DESIGN.md §15): kernel B4
# ---------------------------------------------------------------------------


def encode_merged_plan(merged: tuple[tuple, ...]) -> np.ndarray:
    """The (F, 5) int32 op table of a merged plan: `encode_plan`'s four
    fields and each column's connection depth (0 for meta columns)."""
    table = encode_plan(tuple(e for e, _ in merged))
    depths = np.asarray([int(d) for _, d in merged], np.int32)
    return np.concatenate([table, depths[:, None]], axis=1)


def decode_merged_plan(table) -> tuple[tuple, ...]:
    """Inverse of `encode_merged_plan` (takes the array or a tensor)."""
    t = torch.as_tensor(table)
    return tuple(zip(decode_plan(t[:, :4]), t[:, 4].tolist()))


def stack_multi_forests(forests, tenant_cols, *, block_t: int = 8):
    """Stack N tenants' forests into tenant-stacked node tables.

    Port of the reference's host-side `stack_multi_forests`, over the
    port's `pad_forest_blocks`: each forest is padded with pass-through
    trees to a multiple of its own block ``min(block_t, T)`` (the solo
    recipe, so each tenant's sums run as in a solo launch), its node
    feature ids are remapped through ``tenant_cols[t]`` into merged-column
    ids, and node, leaf and class axes are zero-padded to the fleet maxima.
    Returns CPU tensors ``(feature int32 (ΣT_pad, NI), threshold float32
    (ΣT_pad, NI), leaf float32 (ΣT_pad, NL, K_max))`` and the reference's
    per-tenant spec tuple ``(offset, n_padded, forest_depth, block_t,
    n_internal, n_leaf, n_out, rescale)``.
    """
    ni_max = max(int(f.feature.shape[1]) for f in forests)
    nl_max = max(int(f.leaf.shape[1]) for f in forests)
    k_max = max(int(f.leaf.shape[2]) for f in forests)
    feats, thrs, leafs, tenants = [], [], [], []
    off = 0
    for f, cols in zip(forests, tenant_cols):
        T, ni = f.feature.shape
        nl, k = f.leaf.shape[1], f.leaf.shape[2]
        bt = min(block_t, int(T))
        remap = torch.as_tensor(np.asarray(cols, np.int32)[
            np.asarray(f.feature, np.int64)])
        feat, thr, leaf, rem_t = pad_forest_blocks(
            remap, torch.as_tensor(np.asarray(f.threshold, np.float32)),
            torch.as_tensor(np.asarray(f.leaf, np.float32)), bt)
        tp = int(T) + rem_t
        feats.append(torch.nn.functional.pad(feat, (0, ni_max - ni)))
        thrs.append(torch.nn.functional.pad(thr, (0, ni_max - ni)))
        leafs.append(torch.nn.functional.pad(
            leaf, (0, k_max - k, 0, nl_max - nl)))
        tenants.append((off, tp, int(f.depth), bt, int(ni), int(nl), int(k),
                        (tp / T) if rem_t else 1.0))
        off += tp
    return (torch.cat(feats), torch.cat(thrs), torch.cat(leafs),
            tuple(tenants))


def fused_multi_forest_infer_plain(
    ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port, d_port,
    feature, threshold, leaf, spec, rescale, *, op_table, depth: int,
    n_out: int, columns: torch.Tensor | None = None,
) -> torch.Tensor:
    """The multi-tenant entry in torch ops: the merged plan's columns by
    `emit_merged_columns`, then each tenant's slice of the stacked tables
    by the plain traversal, into its lanes. Takes what
    `fused_multi_forest_call` takes, on any device; if `columns` is given,
    the (N, F) merged columns are copied into it."""
    merged = decode_merged_plan(op_table)
    if max(d for _, d in merged) > depth:
        raise ValueError(f"the op table holds a depth above depth={depth}")
    x = torch.stack(emit_merged_columns(
        merged, ts=ts, size=size, direction=direction, ttl=ttl,
        winsize=winsize, flags=flags, flow_len=flow_len, proto=proto,
        s_port=s_port, d_port=d_port), dim=1)
    if columns is not None:
        columns.copy_(x)
    out = torch.zeros((ts.shape[0], n_out), dtype=torch.float32,
                      device=ts.device)
    for row, r in zip(torch.as_tensor(spec).tolist(),
                      torch.as_tensor(rescale).tolist()):
        s = dict(zip(SPEC_FIELDS, row))
        o, tp, fd, k = s["offset"], s["trees_padded"], s["depth"], s["classes"]
        # the padded trees are walked, as the reference walks them: their
        # zero leaves add +0.0 to the block sums
        p = forest_infer_plain(
            x, feature[o:o + tp, :2 ** fd - 1],
            threshold[o:o + tp, :2 ** fd - 1], leaf[o:o + tp, :2 ** fd, :k],
            fd, block_t=s["block_t"])
        out[:, s["lane"]:s["lane"] + k] = p * r
    return out


def fused_multi_forest_call(
    ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port, d_port,
    feature, threshold, leaf, spec, rescale, *, op_table, depth: int,
    n_out: int, columns: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the B4 CUDA kernel; returns (N, n_out) float32 probability
    lanes, tenant t's in its lane slice.

    Takes the packet tensors as `fused_pipeline_call` does; the stacked
    tables and the int32 (n_tenants, 7) `spec` and float32 (n_tenants,)
    `rescale` from `repro_torch.convert.multi_forest_tables`; the int32
    (F, 5) `op_table` from `encode_merged_plan`; `depth`, the merged plan's
    largest connection depth, and `n_out`, the sum of the tenants' class
    counts. All contiguous on one CUDA device. The spec is checked once,
    where the tables are made, not per call (that would read the card
    back). `columns`, if given, is an (N, F) float32 buffer that receives
    the kernel's own merged columns; above MAX_MERGED_COLUMNS columns the
    kernel keeps its columns there, in one allocated here if none is
    given. Above MAX_WINDOW packets (``min(P, depth)``) a median's samples
    go to a scratch allocated here. Launches on the current stream, reads
    nothing back and does not synchronise.
    """
    dev = ts.device
    if (ts.ndim != 2 or op_table.ndim != 2 or feature.ndim != 2
            or leaf.ndim != 3 or spec.ndim != 2):
        raise ValueError("expected ts (N, P), op_table (F, 5), feature "
                         "(ΣT, NI), leaf (ΣT, NL, K), spec (n_tenants, 7)")
    N, P = ts.shape
    nf = op_table.shape[0]
    if nf < 1:
        raise ValueError("the merged plan has no column")
    TP, NI = feature.shape
    NL, K = leaf.shape[1], leaf.shape[2]
    nt = spec.shape[0]
    if TP < 1 or nt < 1 or not 1 <= K <= MAX_CLASSES or n_out < 1:
        raise ValueError(f"need >= 1 tree and tenant, 1..{MAX_CLASSES} "
                         f"classes a tenant and n_out >= 1, got ΣT={TP}, "
                         f"tenants={nt}, K={K}, n_out={n_out}")
    for name, t in (("ts", ts), ("size", size), ("ttl", ttl),
                    ("winsize", winsize)):
        check_tensor(name, t, torch.float32, (N, P), dev)
    check_tensor("direction", direction, torch.uint8, (N, P), dev)
    check_tensor("flags", flags, torch.uint8, (N, P, 8), dev)
    check_tensor("flow_len", flow_len, torch.int32, (N,), dev)
    for name, t in (("proto", proto), ("s_port", s_port), ("d_port", d_port)):
        check_tensor(name, t, torch.float32, (N,), dev)
    check_tensor("op_table", op_table, torch.int32, (nf, 5), dev)
    check_tensor("spec", spec, torch.int32, (nt, len(SPEC_FIELDS)), dev)
    check_tensor("rescale", rescale, torch.float32, (nt,), dev)
    check_tensor("feature", feature, torch.int32, (TP, NI), dev)
    check_tensor("threshold", threshold, torch.float32, (TP, NI), dev)
    check_tensor("leaf", leaf, torch.float32, (TP, NL, K), dev)
    if columns is not None:
        check_tensor("columns", columns, torch.float32, (N, nf), dev)
    out = torch.empty((N, n_out), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    if columns is None and nf > MAX_MERGED_COLUMNS:
        columns = torch.empty((N, nf), dtype=torch.float32, device=dev)
    scratch = _window_scratch(N, min(P, depth), dev)
    launch("fused_multi_forest_launch", dev,
           ts.data_ptr(), size.data_ptr(), direction.data_ptr(),
           ttl.data_ptr(), winsize.data_ptr(), flags.data_ptr(),
           flow_len.data_ptr(), proto.data_ptr(), s_port.data_ptr(),
           d_port.data_ptr(), op_table.data_ptr(), spec.data_ptr(),
           rescale.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
           leaf.data_ptr(), out.data_ptr(), _ptr(columns), _ptr(scratch),
           N, P, nf, depth, nt, NI, NL, K, n_out)
    fused_multi_forest_call.launches += 1
    return out


fused_multi_forest_call.launches = 0


def fused_multi_forest_infer(
    ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port, d_port,
    feature, threshold, leaf, spec, rescale, *, op_table, depth: int,
    n_out: int, columns: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-tenant fused entry: packets -> stacked per-tenant probability
    lanes, one launch on CUDA tensors, the plain version on CPU tensors."""
    fn = fused_multi_forest_call if ts.is_cuda else fused_multi_forest_infer_plain
    return fn(ts, size, direction, ttl, winsize, flags, flow_len, proto,
              s_port, d_port, feature, threshold, leaf, spec, rescale,
              op_table=op_table, depth=depth, n_out=n_out, columns=columns)
