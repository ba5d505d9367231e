"""Feature extraction in PyTorch: the window half of `repro.traffic.extraction`.

A feature tuple lowers first to a **static stats plan** (`stats_plan`): a
tuple of per-feature op descriptors, identical to the reference's. Two
execution paths consume it:

- `emit_feature_columns` computes the plan's columns with torch ops over
  ``(flows, P)`` packet tensors on any device. It is the extraction stage
  of the two-launch pipeline and the plain version of the fused kernel.
- the fused CUDA kernel (`repro_torch.kernels.fused_pipeline`) interprets
  the same plan, encoded once as a small int32 op table, inside one launch.

A multi-tenant fleet merges its tenants' plans into one (`merge_stats_plans`,
DESIGN.md §15): `emit_merged_columns` emits each depth group of the merged
plan over its own window slice, and the multi-forest kernel B4 interprets
the same merged plan.

All statistics are masked segmented reductions, written op for op as the
reference writes them. Sums run in packet order (`_seq_sum`), as the fused
kernel runs them, so the two are bitwise equal; against the reference the
columns agree to float32 rounding, and bitwise where XLA also adds in
packet order (windows up to 32 packets on the CPU).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .synth import FLAG_NAMES, TrafficDataset

__all__ = [
    "dataset_tensors",
    "extract_features",
    "extraction_fn",
    "stats_plan",
    "emit_feature_columns",
    "merge_stats_plans",
    "emit_merged_columns",
    "emit_merged_agg_features",
    "merged_plan_is_incremental",
    "plan_is_incremental",
    "emit_agg_features",
    "agg_init",
    "AGG_INIT",
    "AGG_WIDTH",
]

# the reference's float32-representable sentinel (extraction.py `_BIG`)
_BIG = 3.4e38


def _seq_sum(v, square: bool = False):
    """Row sums of (rows, P) in packet order, one rounding per add; with
    `square`, the sum of squares, each step a fused multiply-add.

    The fused CUDA kernel adds a row left to right, and so does the
    reference's XLA reduction on the CPU for windows up to 32 packets,
    contracting the squares of std's second pass into FMAs. `Tensor.sum`
    reassociates, and a column one ulp off can cross a forest threshold
    equal to it. The loop keeps the port's two versions bitwise equal on
    the sums at the cost of P launches per sum. The FMA is computed in
    float64, where the product of two float32 values is exact."""
    acc = torch.zeros_like(v[:, 0])
    for i in range(v.shape[1]):
        if square:
            x = v[:, i].double()
            acc = (acc.double() + x * x).float()
        else:
            acc = acc + v[:, i]
    return acc


def _sqrt_f32(v):
    """The correctly rounded float32 square root of float32 `v`: the root
    in float64 rounded once to float32 is exact to the last bit. The CPU's
    vectorized float32 `torch.sqrt` is not always correctly rounded (one
    ulp off on about 0.7% of values); the card's and the kernels' `sqrtf`
    are, so this leaves the card's bits as they were."""
    return torch.sqrt(v.double()).float()


def _masked_sum(v, m):
    return _seq_sum(torch.where(m, v, 0.0))


def _masked_mean(v, m):
    c = m.sum(dim=1)
    return torch.where(c > 0, _masked_sum(v, m) / c.clamp(min=1), 0.0)


def _masked_min(v, m):
    r = torch.where(m, v, _BIG).amin(dim=1)
    return torch.where(m.any(dim=1), r, 0.0)


def _masked_max(v, m):
    r = torch.where(m, v, -_BIG).amax(dim=1)
    return torch.where(m.any(dim=1), r, 0.0)


def _masked_std(v, m):
    # two-pass (subtract mean first): the one-pass E[x^2]-E[x]^2 form
    # catastrophically cancels in float32 for ~1e4-scale window sizes
    c = m.sum(dim=1)
    mean = _masked_sum(v, m) / c.clamp(min=1)
    d = torch.where(m, v - mean[:, None], 0.0)
    var = _seq_sum(d, square=True) / c.clamp(min=1)
    return torch.where(c > 0, _sqrt_f32(var), 0.0)


def _masked_median(v, m):
    srt = torch.sort(torch.where(m, v, _BIG), dim=1).values
    c = m.sum(dim=1)
    lo = srt.gather(1, ((c - 1) // 2).clamp(min=0)[:, None])[:, 0]
    hi = srt.gather(1, (c // 2).clamp(min=0)[:, None])[:, 0]
    return torch.where(c > 0, 0.5 * (lo + hi), 0.0)


_STATS = {
    "sum": _masked_sum,
    "mean": _masked_mean,
    "min": _masked_min,
    "max": _masked_max,
    "med": _masked_median,
    "std": _masked_std,
}

_FLAG_IDX = {n: i for i, n in enumerate(FLAG_NAMES)}


# ---------------------------------------------------------------------------
# static stats plan
# ---------------------------------------------------------------------------

def stats_plan(names: Sequence[str]) -> tuple[tuple, ...]:
    """Lower a feature tuple to a static per-feature op plan.

    Each entry is a small hashable descriptor naming the op family and its
    static parameters; `emit_feature_columns` interprets it with torch ops,
    and `repro_torch.kernels.fused_pipeline.encode_plan` turns it into the
    op table the fused CUDA kernel interprets.
    """
    plan: list[tuple] = []
    for name in names:
        if name == "dur":
            plan.append(("dur",))
        elif name in ("proto", "s_port", "d_port"):
            plan.append(("meta", name))
        elif name in ("s_load", "d_load"):
            plan.append(("load", name[0]))
        elif name in ("s_pkt_cnt", "d_pkt_cnt"):
            plan.append(("pkt_cnt", name[0]))
        elif name in ("tcp_rtt", "syn_ack", "ack_dat"):
            plan.append(("handshake", name))
        elif name.endswith("_cnt") and name[:-4] in _FLAG_IDX:
            plan.append(("flag_cnt", _FLAG_IDX[name[:-4]]))
        else:
            d, fam, stat = name.split("_")
            if d not in ("s", "d") or fam not in ("bytes", "iat", "winsize",
                                                  "ttl") or stat not in _STATS:
                raise ValueError(f"unknown feature {name!r}")
            plan.append(("stat", d, fam, stat))
    return tuple(plan)


def emit_feature_columns(
    plan: tuple[tuple, ...],
    *,
    ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port, d_port,
    depth: int,
) -> list[torch.Tensor]:
    """The plan's feature columns over (rows, P) packet tensors.

    `direction` and `flags` may be uint8 or float32; the per-flow tensors
    are (rows,). Returns a list of float32 (rows,) columns in plan order,
    on the device of the inputs.
    """
    # packets past the connection depth are masked out everywhere below, so
    # the window is cut to the depth first; the columns do not change
    P = min(ts.shape[1], int(depth))
    ts, size, direction = ts[:, :P], size[:, :P], direction[:, :P]
    ttl, winsize, flags = ttl[:, :P], winsize[:, :P], flags[:, :P]
    idx = torch.arange(P, device=ts.device)[None, :]
    valid = (idx < flow_len[:, None]) & (idx < depth)

    dir_mask = {
        "s": valid & (direction == 0),
        "d": valid & (direction == 1),
    }

    # directional inter-arrival times: ts_i - ts(previous pkt, same dir).
    # ts is monotone within a flow, so the previous same-direction timestamp
    # is an exclusive cumulative max over masked timestamps.
    def dir_iat(m):
        cm = torch.cummax(torch.where(m, ts, -_BIG), dim=1).values
        prev = torch.cat([torch.full_like(ts[:, :1], -_BIG), cm[:, :-1]], dim=1)
        has_prev = prev > -_BIG / 2
        iat = torch.where(m & has_prev, ts - prev, 0.0)
        return iat, m & has_prev

    fields = {"bytes": size, "winsize": winsize, "ttl": ttl}
    meta = {"proto": proto, "s_port": s_port, "d_port": d_port}

    def first_ts(cond):
        # argmax over uint8 returns the first maximal index, as jnp does
        i = torch.argmax(cond.to(torch.uint8), dim=1)
        return torch.where(cond.any(dim=1), ts.gather(1, i[:, None])[:, 0], 0.0)

    cols = []
    for entry in plan:
        kind = entry[0]
        if kind == "dur":
            c = _masked_max(ts, valid) - _masked_min(ts, valid)
        elif kind == "meta":
            c = meta[entry[1]]
        elif kind == "load":
            dur = _masked_max(ts, valid) - _masked_min(ts, valid)
            byt = _masked_sum(size, dir_mask[entry[1]])
            c = torch.where(dur > 0, byt * 8.0 / dur.clamp(min=1e-9), 0.0)
        elif kind == "pkt_cnt":
            c = dir_mask[entry[1]].sum(dim=1)
        elif kind == "handshake":
            syn = flags[:, :, _FLAG_IDX["syn"]] > 0
            ack = flags[:, :, _FLAG_IDX["ack"]] > 0
            t_syn = first_ts(valid & syn & ~ack)
            t_synack = first_ts(valid & syn & ack)
            t_ack = first_ts(valid & ack & ~syn)
            if entry[1] == "tcp_rtt":
                c = (t_ack - t_syn).clamp(min=0.0)
            elif entry[1] == "syn_ack":
                c = (t_synack - t_syn).clamp(min=0.0)
            else:
                c = (t_ack - t_synack).clamp(min=0.0)
        elif kind == "flag_cnt":
            c = torch.where(valid, flags[:, :, entry[1]], 0).sum(dim=1)
        else:  # ("stat", dir, family, stat)
            _, d, fam, stat = entry
            if fam == "iat":
                v, m = dir_iat(dir_mask[d])
            else:
                v, m = fields[fam], dir_mask[d]
            c = _STATS[stat](v, m)
        cols.append(c.to(torch.float32))
    return cols


# ---------------------------------------------------------------------------
# merged multi-tenant plans (DESIGN.md §15)
# ---------------------------------------------------------------------------
# N tenants' stats plans union into one merged plan, extracted once per
# flow; each tenant reads its column subset through a static index map. A
# merged column is identified by the (op descriptor, connection depth)
# pair: two tenants at the same depth share every common op, while meta
# columns (proto/ports), which no window mask touches, share across all
# depths (stored with depth 0).


def merge_stats_plans(
    plans: Sequence[tuple[tuple, ...]], depths: Sequence[int]
) -> tuple[tuple[tuple, ...], tuple[tuple[int, ...], ...]]:
    """Union-dedup N tenants' static plans into one merged plan.

    Returns ``(merged, tenant_cols)``: ``merged`` is a hashable tuple of
    ``(entry, depth)`` pairs in first-seen order, and ``tenant_cols[t][i]``
    is the merged column that holds position ``i`` of tenant t's own plan.
    """
    if len(plans) != len(depths):
        raise ValueError("plans and depths must align")
    merged: list[tuple[tuple, int]] = []
    where: dict[tuple[tuple, int], int] = {}
    tenant_cols: list[tuple[int, ...]] = []
    for plan, depth in zip(plans, depths):
        cols = []
        for entry in plan:
            key = (entry, 0 if entry[0] == "meta" else int(depth))
            if key not in where:
                where[key] = len(merged)
                merged.append(key)
            cols.append(where[key])
        tenant_cols.append(tuple(cols))
    return tuple(merged), tuple(tenant_cols)


def emit_merged_columns(
    merged: tuple[tuple, ...],
    *,
    ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port, d_port,
) -> list[torch.Tensor]:
    """A merged plan's columns over (rows, P) packet tensors.

    One `emit_feature_columns` call per distinct connection depth, with the
    packet window sliced to that depth first (``dd = min(d, P)``, 1 for the
    depth-0 meta group): a depth-n group reduces over exactly the (rows, n)
    tensors a solo tenant's table would hold, so every merged column is
    bitwise its solo twin even when the shared table is wider. Returns
    float32 (rows,) columns in merged-plan order.
    """
    groups: dict[int, list[int]] = {}
    for i, (_, d) in enumerate(merged):
        groups.setdefault(int(d), []).append(i)
    out: list = [None] * len(merged)
    for d, idxs in sorted(groups.items()):
        plan = tuple(merged[i][0] for i in idxs)
        dd = min(d, ts.shape[1]) if d else 1
        cols = emit_feature_columns(
            plan,
            ts=ts[:, :dd], size=size[:, :dd], direction=direction[:, :dd],
            ttl=ttl[:, :dd], winsize=winsize[:, :dd], flags=flags[:, :dd, :],
            flow_len=flow_len, proto=proto, s_port=s_port, d_port=d_port,
            depth=dd,
        )
        for i, c in zip(idxs, cols):
            out[i] = c
    return out


def emit_merged_agg_features(merged: tuple[tuple, ...], agg, *,
                             proto, s_port, d_port):
    """Aggregate twin of `emit_merged_columns` (DESIGN.md §12 + §15).

    Running statistics cover the flow's whole lifetime, which connection
    depth never clips, so a merged column's aggregate form is its solo
    `emit_agg_features` column: one emitter call over the deduplicated
    entries. Numpy float64 rows take the reference's path, a float32 tensor
    the torch path, as `emit_agg_features` does. Returns columns in
    merged-plan order.
    """
    return emit_agg_features(
        tuple(e for e, _ in merged), agg,
        proto=proto, s_port=s_port, d_port=d_port)


def merged_plan_is_incremental(merged: tuple[tuple, ...]) -> bool:
    """True iff every merged column has an incremental (aggregate) form."""
    return plan_is_incremental(tuple(e for e, _ in merged))


# ---------------------------------------------------------------------------
# incremental aggregate state (DESIGN.md §12)
# ---------------------------------------------------------------------------
# The flow table keeps, per slot, a float64 row of AGG_WIDTH running
# statistics: per direction d at offset AGG_DIR_STRIDE * d the packet count,
# sum/min/max/M2 of bytes, winsize and ttl, count/sum/min/max/M2 of the
# directional inter-arrival times and the first/last timestamp; then the
# flow-wide ts min/max, the first SYN, SYN-ACK and ACK times and the eight
# flag counters. Min-style cells start at +_BIG, max-style at -_BIG;
# emission maps "never matched" back to the window emitter's 0.0-on-empty.

AGG_DIR_STRIDE = 20
AGG_CNT = 0
AGG_FAM_BASE = {"bytes": 1, "winsize": 5, "ttl": 9}   # +0 SUM +1 MIN +2 MAX +3 M2
AGG_IAT_CNT = 13
AGG_IAT_SUM = 14
AGG_IAT_MIN = 15
AGG_IAT_MAX = 16
AGG_IAT_M2 = 17
AGG_FIRST_TS = 18
AGG_LAST_TS = 19
AGG_TS_MIN = 40
AGG_TS_MAX = 41
AGG_HS_SYN = 42
AGG_HS_SYNACK = 43
AGG_HS_ACK = 44
AGG_FLAGS = 45
AGG_WIDTH = 53

_DIR_OF = {"s": 0, "d": 1}


def agg_init() -> np.ndarray:
    """Pristine per-slot aggregate row (the `_clear_slot` reset value)."""
    v = np.zeros(AGG_WIDTH, np.float64)
    for d in (0, 1):
        b = AGG_DIR_STRIDE * d
        for fb in AGG_FAM_BASE.values():
            v[b + fb + 1] = _BIG
            v[b + fb + 2] = -_BIG
        v[b + AGG_IAT_MIN] = _BIG
        v[b + AGG_IAT_MAX] = -_BIG
        v[b + AGG_FIRST_TS] = _BIG
        v[b + AGG_LAST_TS] = -_BIG
    v[AGG_TS_MIN] = _BIG
    v[AGG_TS_MAX] = -_BIG
    v[AGG_HS_SYN] = _BIG
    v[AGG_HS_SYNACK] = _BIG
    v[AGG_HS_ACK] = _BIG
    return v


AGG_INIT = agg_init()


def plan_is_incremental(plan: tuple[tuple, ...]) -> bool:
    """True iff every plan column is computable from the aggregate row.

    Medians are the one window statistic with no bounded incremental
    form — a plan containing one disables the reuse fast path entirely.
    """
    return all(not (e[0] == "stat" and e[3] == "med") for e in plan)


def emit_agg_features(plan: tuple[tuple, ...], agg, *, proto, s_port, d_port):
    """The plan's feature columns over (rows, AGG_WIDTH) aggregates.

    The incremental twin of `emit_feature_columns`: same plan, same
    empty-mask semantics (0.0 when a direction/condition never matched),
    but reading the flow table's running statistics instead of the raw
    packet window. On numpy arrays (the host drift check, float64) it is
    the reference's code; on torch tensors (float32) it is the plain
    version of the aggregate kernel B3, which computes each column in the
    same order of IEEE operations. Returns float32 (rows,) columns in plan
    order. Raises on a non-incremental plan entry ("med").
    """
    if isinstance(agg, torch.Tensor):
        return _emit_agg_torch(plan, agg, proto=proto, s_port=s_port,
                               d_port=d_port)
    xp = np

    def col(i):
        return agg[:, i]

    def dcol(d, i):
        return agg[:, AGG_DIR_STRIDE * d + i]

    cnt = {k: dcol(v, AGG_CNT) for k, v in _DIR_OF.items()}
    n_any = cnt["s"] + cnt["d"]
    dur = xp.where(n_any > 0, col(AGG_TS_MAX) - col(AGG_TS_MIN), 0.0)

    def fam_stat(d, fam, stat):
        di = _DIR_OF[d]
        if fam == "iat":
            c = dcol(di, AGG_IAT_CNT)
            cells = {"sum": AGG_IAT_SUM, "min": AGG_IAT_MIN,
                     "max": AGG_IAT_MAX}
            m2 = dcol(di, AGG_IAT_M2)
        else:
            c = cnt[d]
            fb = AGG_FAM_BASE[fam]
            cells = {"sum": fb, "min": fb + 1, "max": fb + 2}
            m2 = dcol(di, fb + 3)
        if stat == "sum":
            return dcol(di, cells["sum"])
        if stat == "mean":
            return xp.where(
                c > 0, dcol(di, cells["sum"]) / xp.maximum(c, 1.0), 0.0)
        if stat in ("min", "max"):
            return xp.where(c > 0, dcol(di, cells[stat]), 0.0)
        if stat == "std":
            var = m2 / xp.maximum(c, 1.0)
            return xp.where(c > 0, xp.sqrt(xp.maximum(var, 0.0)), 0.0)
        raise ValueError(f"stat {stat!r} has no incremental form")

    def hs(i):
        v = col(i)
        return xp.where(v < _BIG / 2, v, 0.0)

    meta = {"proto": proto, "s_port": s_port, "d_port": d_port}
    cols = []
    for entry in plan:
        kind = entry[0]
        if kind == "dur":
            c = dur
        elif kind == "meta":
            c = meta[entry[1]]
        elif kind == "load":
            byt = dcol(_DIR_OF[entry[1]], AGG_FAM_BASE["bytes"])
            c = xp.where(dur > 0, byt * 8.0 / xp.maximum(dur, 1e-9), 0.0)
        elif kind == "pkt_cnt":
            c = cnt[entry[1]]
        elif kind == "handshake":
            t_syn = hs(AGG_HS_SYN)
            t_synack = hs(AGG_HS_SYNACK)
            t_ack = hs(AGG_HS_ACK)
            if entry[1] == "tcp_rtt":
                c = xp.maximum(t_ack - t_syn, 0.0)
            elif entry[1] == "syn_ack":
                c = xp.maximum(t_synack - t_syn, 0.0)
            else:
                c = xp.maximum(t_ack - t_synack, 0.0)
        elif kind == "flag_cnt":
            c = col(AGG_FLAGS + entry[1])
        else:  # ("stat", dir, family, stat)
            _, d, fam, stat = entry
            c = fam_stat(d, fam, stat)
        cols.append(xp.asarray(c, xp.float32))
    return cols


def _emit_agg_torch(plan, agg, *, proto, s_port, d_port):
    """`emit_agg_features` over a float32 (rows, AGG_WIDTH) tensor: the
    reference's jnp path, op for op. The sentinels survive the float32
    cast (3.4e38 is representable), so an unselected branch may hold
    +-inf; every masked value is chosen by `torch.where`, never by a
    multiply with a mask."""
    if agg.dtype != torch.float32:
        raise TypeError(f"agg: dtype {agg.dtype}, expected torch.float32 "
                        "(round on the host, as the reference's float32 "
                        "path does)")

    def dcol(d, i):
        return agg[:, AGG_DIR_STRIDE * d + i]

    cnt = {k: dcol(v, AGG_CNT) for k, v in _DIR_OF.items()}
    n_any = cnt["s"] + cnt["d"]
    dur = torch.where(n_any > 0, agg[:, AGG_TS_MAX] - agg[:, AGG_TS_MIN], 0.0)

    def fam_stat(d, fam, stat):
        di = _DIR_OF[d]
        if fam == "iat":
            c = dcol(di, AGG_IAT_CNT)
            cells = {"sum": AGG_IAT_SUM, "min": AGG_IAT_MIN,
                     "max": AGG_IAT_MAX}
            m2 = dcol(di, AGG_IAT_M2)
        else:
            c = cnt[d]
            fb = AGG_FAM_BASE[fam]
            cells = {"sum": fb, "min": fb + 1, "max": fb + 2}
            m2 = dcol(di, fb + 3)
        if stat == "sum":
            return dcol(di, cells["sum"])
        if stat == "mean":
            return torch.where(
                c > 0, dcol(di, cells["sum"]) / c.clamp(min=1.0), 0.0)
        if stat in ("min", "max"):
            return torch.where(c > 0, dcol(di, cells[stat]), 0.0)
        if stat == "std":
            var = m2 / c.clamp(min=1.0)
            return torch.where(c > 0, _sqrt_f32(var.clamp(min=0.0)), 0.0)
        raise ValueError(f"stat {stat!r} has no incremental form")

    def hs(i):
        v = agg[:, i]
        return torch.where(v < _BIG / 2, v, 0.0)

    meta = {"proto": proto, "s_port": s_port, "d_port": d_port}
    cols = []
    for entry in plan:
        kind = entry[0]
        if kind == "dur":
            c = dur
        elif kind == "meta":
            c = meta[entry[1]]
        elif kind == "load":
            byt = dcol(_DIR_OF[entry[1]], AGG_FAM_BASE["bytes"])
            c = torch.where(dur > 0, byt * 8.0 / dur.clamp(min=1e-9), 0.0)
        elif kind == "pkt_cnt":
            c = cnt[entry[1]]
        elif kind == "handshake":
            t_syn, t_synack, t_ack = (hs(AGG_HS_SYN), hs(AGG_HS_SYNACK),
                                      hs(AGG_HS_ACK))
            if entry[1] == "tcp_rtt":
                c = (t_ack - t_syn).clamp(min=0.0)
            elif entry[1] == "syn_ack":
                c = (t_synack - t_syn).clamp(min=0.0)
            else:
                c = (t_ack - t_synack).clamp(min=0.0)
        elif kind == "flag_cnt":
            c = agg[:, AGG_FLAGS + entry[1]]
        else:  # ("stat", dir, family, stat)
            _, d, fam, stat = entry
            c = fam_stat(d, fam, stat)
        cols.append(c.to(torch.float32))
    return cols


# ---------------------------------------------------------------------------
# batch entry points
# ---------------------------------------------------------------------------

def dataset_tensors(ds: TrafficDataset, device: torch.device) -> dict:
    """The batch's arrays as tensors on `device`, in the dtypes the kernels
    take: float32 packet fields, uint8 `direction` and `flags`, int32
    `flow_len`, float32 per-flow metadata.

    The copies are queued without waiting. From pageable memory CUDA reads
    the source before the call returns; from pinned memory (the streaming
    dispatcher's staging arenas) it reads it later, on the stream, so the
    owner of pinned arrays must not overwrite them until the copies ran."""
    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype)).to(
            device, non_blocking=True)

    out = {k: put(getattr(ds, k), np.float32)
           for k in ("ts", "size", "ttl", "winsize", "proto", "s_port", "d_port")}
    out["direction"] = put(ds.direction, np.uint8)
    out["flags"] = put(ds.flags, np.uint8)
    out["flow_len"] = put(ds.flow_len, np.int32)
    return out


def extraction_fn(names: Sequence[str], depth: int, max_pkts: int,
                  *, device: str | torch.device = "cuda"):
    """Return the extraction callable for (names, depth): ds -> (N, F)
    float32 tensor on `device`. `max_pkts` is kept for the reference's
    signature; the window is whatever the batch holds."""
    plan = stats_plan(tuple(names))
    dev = resolve_device(device)

    def run(ds: TrafficDataset) -> torch.Tensor:
        return torch.stack(
            emit_feature_columns(plan, **dataset_tensors(ds, dev),
                                 depth=int(depth)), dim=1)

    return run


def extract_features(
    ds: TrafficDataset, names: Sequence[str], depth: int,
    *, device: str | torch.device = "cuda",
) -> np.ndarray:
    """Extract feature matrix (n_flows, len(names)) at connection depth."""
    fn = extraction_fn(tuple(names), int(depth), ds.max_pkts, device=device)
    return fn(ds).cpu().numpy()
