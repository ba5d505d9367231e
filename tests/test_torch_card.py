"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device and skips without one. The file
imports nothing of JAX, so it also runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py
"""
import functools
import itertools

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    assert_straddle_parity,
    cuda,
    quantile_forest,
)
from repro_torch.convert import forest_from_numpy, forest_tables, multi_forest_tables
from repro_torch.core.search_space import FeatureRep
from repro_torch.kernels.fused_pipeline import (
    MAX_MERGED_COLUMNS,
    MAX_WINDOW,
    agg_op_table,
    decode_merged_plan,
    encode_merged_plan,
    encode_plan,
    fused_agg_call,
    fused_agg_infer_plain,
    fused_forest_infer_plain,
    fused_multi_forest_call,
    fused_multi_forest_infer_plain,
    fused_pipeline_call,
)
from repro_torch.kernels.decode_attention import (
    decode_attention_kernel_call,
    decode_attention_plain,
    split_plan,
)
from repro_torch.kernels.feature_extract import flow_stats_kernel_call, flow_stats_plain
from repro_torch.kernels.flash_attention import (
    flash_attention_kernel_call,
    flash_attention_plain,
)
from repro_torch.kernels.mamba_scan import mamba_scan_kernel_call, mamba_scan_plain
from repro_torch.kernels.tree_infer import forest_infer_kernel_call, forest_infer_plain
from repro_torch.traffic.extraction import (
    dataset_tensors,
    emit_agg_features,
    extract_features,
    merge_stats_plans,
    stats_plan,
)
from repro_torch.traffic.features import FEATURE_NAMES
from repro_torch.traffic.models import train_traffic_model
from repro_torch.serve import runtime as prt
from repro_torch.traffic.multi_tenant import build_multi_tenant_pipeline
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_dataset, make_scenario_dataset

pytestmark = pytest.mark.cuda


def _random_forest(R, T, depth, K, F):
    return forest_from_numpy(
        R.integers(0, F, (T, 2 ** depth - 1)),
        R.standard_normal((T, 2 ** depth - 1)),
        R.random((T, 2 ** depth, K)), depth, F)


def _packets(ds, dev):
    t = dataset_tensors(ds, dev)
    return [t[k] for k in ("ts", "size", "direction", "ttl", "winsize", "flags",
                           "flow_len", "proto", "s_port", "d_port")]


@pytest.mark.parametrize("T", [1, 25, 33, 70])
@pytest.mark.parametrize("K", [1, 28, 33, 64])
@pytest.mark.parametrize("depth", [0, 1, 4, 6, 10])
def test_forest_kernel_matches_plain(cuda, T, K, depth):  # noqa: F811
    """The same x and the same order of additions: the plain version's
    bits, at trees either side of a warp's 32 lanes, one class slot a lane
    or two, forests of one leaf, middle depths and the main path's, and
    batches of one flow, under a warp, across blocks and at the main
    path's 4096."""
    R = np.random.default_rng(1000 * T + 10 * K + depth)
    tables = forest_tables(_random_forest(R, T, depth, K, 67), cuda)
    for n in (1, 31, 257, 4096):
        x = torch.from_numpy(
            R.standard_normal((n, 67)).astype(np.float32)).to(cuda)
        want = forest_infer_plain(x, *tables, depth)
        assert torch.equal(forest_infer_kernel_call(x, *tables, depth),
                           want), n


@pytest.mark.parametrize("conn_depth", [1, 8, 50])
def test_fused_kernel_matches_plain(cuda, conn_depth):  # noqa: F811
    ds = make_dataset("iot-class", n_flows=300, max_pkts=64, seed=2)
    plan = stats_plan(FEATURE_NAMES)
    R = np.random.default_rng(conn_depth)
    forest = _random_forest(R, 9, 6, 28, len(plan))
    tables = forest_tables(forest, cuda)
    op_table = torch.from_numpy(encode_plan(plan)).to(cuda)
    outs = []
    for fn in (fused_pipeline_call, fused_forest_infer_plain):
        cols = torch.empty((ds.n_flows, len(plan)), device=cuda)
        p = fn(*_packets(ds, cuda), *tables, op_table=op_table,
               depth=conn_depth, forest_depth=forest.depth, columns=cols)
        outs.append((p.cpu().numpy(), cols.cpu().numpy()))
    (pk, xk), (pp, xp) = outs
    np.testing.assert_allclose(xk, xp, rtol=1e-5, atol=1e-6)
    assert_straddle_parity(pp, pk, xp, xk, forest)


@functools.cache
def _stream_trace():
    """Flows of up to 4000 packets: the stream phase's zipf app-class trace
    (benchmarks/bench_runtime.py), cut to 200 flows."""
    return make_scenario_dataset("app-class", "zipf", n_flows=200,
                                 max_pkts=4000, seed=3)


@pytest.mark.parametrize("depth", [129, 256, 4000])
def test_fused_kernel_long_window_bitwise(cuda, depth):  # noqa: F811
    """Windows above the shared-memory chunk (MAX_WINDOW) go through the
    kernel's scratch: columns, medians among them, and probabilities
    bitwise the plain version's."""
    ds = _stream_trace()
    assert min(depth, ds.max_pkts) > MAX_WINDOW
    assert (ds.flow_len > depth // 2).sum() > 0
    plan = stats_plan(FEATURE_NAMES)
    x = extract_features(ds, FEATURE_NAMES, depth, device=cuda)
    forest = quantile_forest(x, np.random.default_rng(depth), T=9, D=6, K=28)
    tables = forest_tables(forest, cuda)
    op_table = torch.from_numpy(encode_plan(plan)).to(cuda)
    outs = []
    for fn in (fused_pipeline_call, fused_forest_infer_plain):
        cols = torch.empty((ds.n_flows, len(plan)), device=cuda)
        p = fn(*_packets(ds, cuda), *tables, op_table=op_table, depth=depth,
               forest_depth=forest.depth, columns=cols)
        outs.append((p.cpu().numpy(), cols.cpu().numpy()))
    (pk, xk), (pp, xp) = outs
    np.testing.assert_array_equal(xk, xp)
    np.testing.assert_array_equal(pk, pp)


def _warp_case_plan(F: int) -> tuple:
    """A plan of F columns: the registry's 67 features, cut or repeated;
    F = 1 is one median."""
    if F == 1:
        return stats_plan(("s_iat_med",))
    names = (FEATURE_NAMES * 2)[:F]
    return stats_plan(names)


@pytest.mark.parametrize("N,F,window", [
    (4096, 67, 50), (1, 67, 50), (8, 128, 50), (33, 1, 50),
    (4096, 128, 128), (33, 67, 128), (8, 1, 128),
    (33, 67, 129), (8, 128, 129), (1, 67, 4000), (33, 1, 4000),
    (200, 128, 4000)])
def test_fused_kernel_warp_per_flow_bitwise(cuda, N, F, window):  # noqa: F811
    """The warp-per-flow kernel at batch sizes around a warp's flows and a
    block's, at 1, 67 and 128 columns, 40 trees (more than a warp's lanes)
    and 64 classes (two a lane), and windows inside a shared-memory chunk
    (50, 128) and above it (129, 4000): columns and probabilities bitwise
    the plain version's. The forest's thresholds are quantiles of the
    columns, so a column one ulp off would move some flow's path."""
    if window <= MAX_WINDOW:
        ds = make_dataset("iot-class", n_flows=600, max_pkts=160, seed=5)
    else:
        ds = _stream_trace()
    ds = ds.take(np.arange(N) % ds.n_flows)
    plan = _warp_case_plan(F)
    assert len(plan) == F
    op_table = torch.from_numpy(encode_plan(plan)).to(cuda)
    packets = _packets(ds, cuda)
    x = torch.empty((N, F), device=cuda)
    probe = forest_tables(_random_forest(np.random.default_rng(0), 1, 1, 2, F),
                          cuda)
    fused_forest_infer_plain(*packets, *probe, op_table=op_table, depth=window,
                             forest_depth=1, columns=x)
    forest = quantile_forest(x.cpu().numpy(), np.random.default_rng(N + F),
                             T=40, D=6, K=64)
    tables = forest_tables(forest, cuda)
    outs = []
    for fn in (fused_pipeline_call, fused_forest_infer_plain):
        cols = torch.empty((N, F), device=cuda)
        p = fn(*packets, *tables, op_table=op_table, depth=window,
               forest_depth=forest.depth, columns=cols)
        outs.append((p.cpu().numpy(), cols.cpu().numpy()))
    (pk, xk), (pp, xp) = outs
    np.testing.assert_array_equal(xk, xp)
    np.testing.assert_array_equal(pk, pp)


def test_kernels_refuse_what_they_do_not_take(cuda):  # noqa: F811
    x = torch.zeros((4, 3), device=cuda)
    feature = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    leaf = torch.zeros((2, 4, 5), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        forest_infer_kernel_call(x, feature, feature, leaf, 2)
    with pytest.raises(ValueError, match="contiguous"):
        forest_infer_kernel_call(torch.zeros((3, 4), device=cuda).t(), feature,
                                 torch.zeros((2, 3), device=cuda), leaf, 2)


def test_pipeline_on_card_matches_cpu(cuda):  # noqa: F811
    ds = make_dataset("app-class", n_flows=257, max_pkts=16, seed=11)
    rep = FeatureRep(tuple(FEATURE_NAMES), depth=10)
    X = extract_features(ds, rep.features, rep.depth, device="cpu")
    forest, _ = train_traffic_model(X, ds.label, model="rf-fast", seed=0)
    n0, f0 = forest_infer_kernel_call.launches, fused_pipeline_call.launches
    for fused in (False, True):
        cpu = build_pipeline(rep, forest, ds.max_pkts, fused=fused, device="cpu")
        gpu = build_pipeline(rep, forest, ds.max_pkts, fused=fused)
        gpu.warm([1, 2, 4])
        xg = extract_features(ds, rep.features, rep.depth)
        assert_straddle_parity(cpu.probabilities(ds), gpu.probabilities(ds),
                               X, xg, forest)
        np.testing.assert_array_equal(gpu(ds), cpu(ds))
    assert forest_infer_kernel_call.launches > n0
    assert fused_pipeline_call.launches > f0


def _agg_rows(n_pkts=6000):
    """float64 aggregate rows and float32 meta of the live flows of a reuse
    table after `n_pkts` packets of a zipf trace."""
    ds = make_scenario_dataset("app-class", "zipf", n_flows=120, max_pkts=400,
                               seed=3)
    s = prt.PacketStream.from_dataset(ds, seed=0)
    tbl = prt.FlowTable(512, 8, reuse=True, refresh_every=64, agg_buffer=256)
    f = s.fid[:n_pkts]
    tbl.observe_batch(s.key[f], s.base_t[:n_pkts], s.rel_ts32[:n_pkts],
                      s.size[:n_pkts], s.direction[:n_pkts], s.ttl[:n_pkts],
                      s.winsize[:n_pkts], s.flags_byte[:n_pkts], s.proto[f],
                      s.s_port[f], s.d_port[f], f, s.fin[:n_pkts])
    tbl.flush_agg()
    live = np.flatnonzero(tbl.ctrl["state"] != 0)
    meta = np.stack([tbl.proto[live], tbl.s_port[live], tbl.d_port[live]], 1)
    return tbl.agg[live], meta


INCREMENTAL = tuple(f for f in FEATURE_NAMES if not f.endswith("_med"))


def _agg_case(cuda, n, names, T, D, K, seed):
    """n aggregate rows (the last a padding row, as the dispatcher pads)
    and their meta on the card, the checked op table of `names`, and a
    forest whose thresholds are quantiles of the plain columns, so that a
    column one ulp off would move some flow's path."""
    agg, meta = _agg_rows()
    idx = np.arange(n) % len(agg)
    a = torch.from_numpy(agg[idx].astype(np.float32)).to(cuda)
    m = torch.from_numpy(meta[idx]).to(cuda)
    a[-1:] = 0.0
    m[-1:] = 0.0
    plan = stats_plan(names)
    x = torch.stack(emit_agg_features(plan, a, proto=m[:, 0], s_port=m[:, 1],
                                      d_port=m[:, 2]), dim=1)
    forest = quantile_forest(x.cpu().numpy(), np.random.default_rng(seed),
                             T=T, D=D, K=K)
    return a, m, agg_op_table(encode_plan(plan), cuda), forest


def _agg_both(a, m, op_table, forest, cuda):
    outs = []
    for fn in (fused_agg_call, fused_agg_infer_plain):
        cols = torch.empty((a.shape[0], op_table.shape[0]), device=cuda)
        p = fn(a, m, *forest_tables(forest, cuda), op_table=op_table,
               forest_depth=forest.depth, columns=cols)
        outs.append((p.cpu().numpy(), cols.cpu().numpy()))
    return outs


@pytest.mark.parametrize("n", [1, 8, 37, 4096])
def test_agg_kernel_matches_plain(cuda, n):  # noqa: F811
    """The warp-per-flow kernel: columns and probabilities bitwise the
    plain version's, the padding row's columns zero."""
    a, m, op_table, forest = _agg_case(cuda, n, INCREMENTAL, 25, 8, 7, n)
    n0 = fused_agg_call.launches
    (pk, xk), (pp, xp) = _agg_both(a, m, op_table, forest, cuda)
    assert fused_agg_call.launches == n0 + 1
    np.testing.assert_array_equal(xk, xp)
    np.testing.assert_array_equal(pk, pp)
    assert (xk[-1] == 0).all()


@pytest.mark.parametrize("n,F,T,K", [
    (37, 1, 1, 1), (8, 33, 31, 28), (4096, 97, 33, 33), (33, 128, 40, 64),
    (5, 59, 32, 32)])
def test_agg_kernel_where_lanes_change_hands(cuda, n, F, T, K):  # noqa: F811
    """Columns over one, two, four lane slots (F 33, 97, 128: the 59
    incremental features repeated), trees one either side of a warp's 32
    (a lane's second tree) and 40, and classes 1, 28, 33 and 64 (a lane's
    second class slot): columns and probabilities bitwise the plain
    version's."""
    names = (INCREMENTAL * 3)[:F] if F > 1 else ("s_iat_std",)
    a, m, op_table, forest = _agg_case(cuda, n, names, T, 6, K, n + F)
    (pk, xk), (pp, xp) = _agg_both(a, m, op_table, forest, cuda)
    np.testing.assert_array_equal(xk, xp)
    np.testing.assert_array_equal(pk, pp)


def test_agg_kernel_in_a_cuda_graph(cuda):  # noqa: F811
    """The launch reads nothing back (the op table was checked on the host
    by `agg_op_table`), so a CUDA graph captures it: replayed after new
    rows are copied in, it equals an eager call and the plain version."""
    a, m, op_table, forest = _agg_case(cuda, 256, INCREMENTAL, 25, 8, 7, 1)
    tables = forest_tables(forest, cuda)
    kw = dict(op_table=op_table, forest_depth=forest.depth)
    fused_agg_call(a, m, *tables, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_agg_call(a, m, *tables, **kw)
    agg, meta = _agg_rows()
    for shift in (0, 7, 101):
        idx = (np.arange(256) + shift) % len(agg)
        a.copy_(torch.from_numpy(agg[idx].astype(np.float32)))
        m.copy_(torch.from_numpy(meta[idx]))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fused_agg_call(a, m, *tables, **kw))
        assert torch.equal(out, fused_agg_infer_plain(a, m, *tables, **kw))


def test_pinned_arenas_replay_matches_cpu(cuda):  # noqa: F811
    """A replay whose window lets one batch be in flight: the staging
    arenas are pinned, each carries the event the dispatcher waits on, and
    the predictions, first and refreshed, are the CPU pipeline's."""
    ds = make_scenario_dataset("app-class", "zipf", n_flows=120, max_pkts=400,
                               seed=3)
    rep = FeatureRep(tuple(f for f in FEATURE_NAMES if not f.endswith("_med")),
                     depth=8)
    X = extract_features(ds, rep.features, rep.depth, device="cpu")
    forest, _ = train_traffic_model(X, ds.label, model="rf-fast", seed=0)
    stream = prt.PacketStream.from_dataset(ds, seed=0)
    svc = prt.ServiceModel(pkt_accum_ns=800.0, pkt_track_ns=200.0,
                           bucket_ns={8: 3e4, 16: 4e4}, pkt_frozen_ns=100.0)
    n0 = fused_agg_call.launches
    out = {}
    for device in ("cpu", "cuda"):
        pipe = build_pipeline(rep, forest, rep.depth, fused=True, device=device)
        made = []

        def mk(pipe=pipe, made=made):
            made.append(prt.StreamingRuntime(
                pipe, capacity=512, max_batch=16, flush_timeout_s=2e-4,
                max_pending=1, reuse=prt.ReuseConfig(drift_threshold=0.0,
                                                     refresh_every=64)))
            return made[-1]

        st = prt.replay(stream, mk, stream.base_pps * 3, svc,
                        ring_capacity=stream.n_events // 6)
        disp = made[0].dispatcher
        arenas = [a for ring in disp._arenas.values() for a in ring]
        assert arenas and all(len(r) == 2 for r in disp._arenas.values())
        if device == "cuda":
            assert all(a.copied is not None and a.copied.query()
                       and all(t.is_pinned() for t in a.pinned)
                       for a in arenas)
        else:
            assert all(a.copied is None and not a.pinned for a in arenas)
        out[device] = ({k: int(v) for k, v in st.predictions.items()},
                       {k: int(v) for k, v in disp.live_predictions.items()})
    assert fused_agg_call.launches > n0
    assert out["cuda"] == out["cpu"]


# the reference's multi-tenant fixture (tests/test_multi_tenant.py)
MT_TENANTS = ((("s_bytes_mean", "s_iat_mean", "proto", "s_load"), 8),
              (("s_bytes_mean", "s_bytes_max", "dur", "d_load"), 12),
              (("s_iat_mean", "s_load", "d_pkt_cnt", "ack_cnt"), 8))


def _multi_case(case):
    """The 3-tenant fixture, or the 131-column case: the registry at depths
    50 and 16 and the 59 incremental features at 50."""
    if case == "tenants":
        ds = make_scenario_dataset("app-class", "zipf", n_flows=100,
                                   max_pkts=48, seed=5)
        reps = [FeatureRep(f, d) for f, d in MT_TENANTS]
        model = "tree-fast"
    else:
        ds = make_dataset("iot-class", n_flows=600, max_pkts=128, seed=0)
        inc = tuple(f for f in FEATURE_NAMES if not f.endswith("_med"))
        reps = [FeatureRep(FEATURE_NAMES, 50), FeatureRep(FEATURE_NAMES, 16),
                FeatureRep(inc, 50)]
        model = "rf-fast"
    forests = [train_traffic_model(
        extract_features(ds, r.features, r.depth, device="cpu"), ds.label,
        model=model, seed=t)[0] for t, r in enumerate(reps)]
    return ds, reps, forests


@pytest.mark.parametrize("case", ["tenants", "wide"])
def test_multi_kernel_matches_plain_and_solo(cuda, case):  # noqa: F811
    ds, reps, forests = _multi_case(case)
    plans = [stats_plan(r.features) for r in reps]
    merged, cols = merge_stats_plans(plans, [r.depth for r in reps])
    if case == "wide":
        assert len(merged) == 131
    tables = multi_forest_tables(forests, cols, cuda)[:5]
    op_table = torch.from_numpy(encode_merged_plan(merged)).to(cuda)
    kw = dict(op_table=op_table, depth=max(r.depth for r in reps),
              n_out=sum(f.n_out for f in forests))
    packets = _packets(ds, cuda)
    outs = []
    for fn in (fused_multi_forest_call, fused_multi_forest_infer_plain):
        c = torch.empty((ds.n_flows, len(merged)), device=cuda)
        p = fn(*packets, *tables, columns=c, **kw)
        outs.append((p.cpu().numpy(), c.cpu().numpy()))
    (pk, xk), (pp, xp) = outs
    np.testing.assert_array_equal(xk, xp)
    lo = 0
    for plan, r, f, c in zip(plans, reps, forests, cols):
        hi = lo + f.n_out
        assert assert_straddle_parity(pp[:, lo:hi], pk[:, lo:hi],
                                      xp[:, list(c)], xk[:, list(c)], f) == 0
        # the lane is B2 run alone on the tenant's own plan and forest
        solo = fused_pipeline_call(
            *packets, *forest_tables(f, cuda),
            op_table=torch.from_numpy(encode_plan(plan)).to(cuda),
            depth=r.depth, forest_depth=f.depth)
        np.testing.assert_array_equal(pk[:, lo:hi], solo.cpu().numpy())
        lo = hi


def _tenants_case(case):
    """Flows, tenant feature reps and random quantile forests of the B4
    cases beyond the old per-thread arrays: two tenants whose union window is
    129, 256 or 4000 packets (the registry at depth 100 beside a median
    plan at the long depth), and four tenants over the registry at depths
    5, 10, 15 and 20, whose merged plan has 259 columns."""
    if case == "259_columns":
        ds = make_dataset("iot-class", n_flows=600, max_pkts=128, seed=0)
        reps = [FeatureRep(FEATURE_NAMES, d) for d in (5, 10, 15, 20)]
    else:
        ds = _stream_trace()
        meds = tuple(f for f in FEATURE_NAMES if f.endswith(("_med", "_std")))
        reps = [FeatureRep(FEATURE_NAMES, 100), FeatureRep(meds, int(case))]
    rng = np.random.default_rng(len(reps))
    forests = [quantile_forest(extract_features(ds, r.features, r.depth,
                                                device="cpu"), rng, T=9, D=6,
                               K=5 + t)
               for t, r in enumerate(reps)]
    return ds, reps, forests


@pytest.mark.parametrize("case", ["129", "256", "4000", "259_columns"])
def test_multi_kernel_beyond_its_arrays_bitwise(cuda, case):  # noqa: F811
    """Merged columns and lanes bitwise the plain version's, and each
    tenant's lanes bitwise solo B2, where the window outgrows the
    shared-memory chunk or the merged plan the 256 columns that one thread
    per flow once held (past the shared-memory limit:
    `test_multi_kernel_warp_cases_bitwise`)."""
    ds, reps, forests = _tenants_case(case)
    plans = [stats_plan(r.features) for r in reps]
    merged, cols = merge_stats_plans(plans, [r.depth for r in reps])
    assert (len(merged) == 259 if case == "259_columns" else
            min(max(r.depth for r in reps), ds.max_pkts) > MAX_WINDOW)
    tables = multi_forest_tables(forests, cols, cuda)[:5]
    op_table = torch.from_numpy(encode_merged_plan(merged)).to(cuda)
    assert decode_merged_plan(op_table.cpu()) == merged
    kw = dict(op_table=op_table, depth=max(r.depth for r in reps),
              n_out=sum(f.n_out for f in forests))
    packets = _packets(ds, cuda)
    outs = []
    for fn in (fused_multi_forest_call, fused_multi_forest_infer_plain):
        c = torch.empty((ds.n_flows, len(merged)), device=cuda)
        p = fn(*packets, *tables, columns=c, **kw)
        outs.append((p.cpu().numpy(), c.cpu().numpy()))
    (pk, xk), (pp, xp) = outs
    np.testing.assert_array_equal(xk, xp)
    np.testing.assert_array_equal(pk, pp)
    # serving passes no columns buffer: a wide plan gets one of its own
    np.testing.assert_array_equal(
        fused_multi_forest_call(*packets, *tables, **kw).cpu().numpy(), pk)
    lo = 0
    for plan, r, f in zip(plans, reps, forests):
        solo = fused_pipeline_call(
            *packets, *forest_tables(f, cuda),
            op_table=torch.from_numpy(encode_plan(plan)).to(cuda),
            depth=r.depth, forest_depth=f.depth)
        np.testing.assert_array_equal(pk[:, lo:lo + f.n_out],
                                      solo.cpu().numpy())
        lo += f.n_out


def _merged_unshared(plans, depths):
    """A merged table that shares nothing: every tenant's entries in turn
    (meta columns at depth 0), so that one depth group can hold more rows
    than a warp's 128, interleaved in table order with other depths."""
    merged, cols = [], []
    for plan, d in zip(plans, depths):
        cols.append(tuple(range(len(merged), len(merged) + len(plan))))
        merged += [(e, 0 if e[0] == "meta" else int(d)) for e in plan]
    return tuple(merged), tuple(cols)


def _warp_multi_case(case):
    """Flows, tenant reps, the merged table, its column maps and forests of
    B4's warp cases: a depth group of 192 rows (the registry three times at
    depth 50, unshared, around a tenant at depth 8); a union window of 300
    packets; and 4163 merged columns (the registry at depths 1..65), past
    what shared memory holds. Each has a tenant of 64 classes and 40 trees
    (two class slots a lane, a lane's second tree)."""
    if case == "group_over_128":
        ds = make_dataset("iot-class", n_flows=150, max_pkts=64, seed=7)
        depths = (50, 8, 50, 50)
    elif case == "window_over_128":
        ds = _stream_trace().take(np.arange(64))
        depths = (100, 300)
    else:
        ds = make_dataset("iot-class", n_flows=64, max_pkts=128, seed=8)
        depths = tuple(range(1, 66))
    reps = [FeatureRep(FEATURE_NAMES, d) for d in depths]
    plans = [stats_plan(r.features) for r in reps]
    if case == "past_shared_limit":
        merged, cols = merge_stats_plans(plans, depths)
    else:
        merged, cols = _merged_unshared(plans, depths)
    rng = np.random.default_rng(len(merged))
    forests = []
    for t, r in enumerate(reps):
        x = extract_features(ds, r.features, r.depth, device="cpu")
        T, K = (40, 64) if t == 1 else (3 + t % 7, 2 + t % 5)
        forests.append(quantile_forest(x, rng, T=T, D=6, K=K))
    return ds, reps, plans, merged, cols, forests


@pytest.mark.parametrize("case", ["group_over_128", "window_over_128",
                                  "past_shared_limit"])
def test_multi_kernel_warp_cases_bitwise(cuda, case):  # noqa: F811
    """The warp-per-flow B4 where its lists, its shared memory and its
    lanes run out: merged columns and lanes equal to the plain version's,
    each tenant's lanes equal to solo B2 on its own plan and forest; past
    the shared-memory limit also with no `columns` passed, as serving
    calls it."""
    ds, reps, plans, merged, cols, forests = _warp_multi_case(case)
    if case == "group_over_128":
        assert sum(d == 50 for _, d in merged) == 192
    elif case == "window_over_128":
        assert min(max(r.depth for r in reps), ds.max_pkts) > MAX_WINDOW
    else:
        assert len(merged) > MAX_MERGED_COLUMNS
    tables = multi_forest_tables(forests, cols, cuda)[:5]
    op_table = torch.from_numpy(encode_merged_plan(merged)).to(cuda)
    kw = dict(op_table=op_table, depth=max(r.depth for r in reps),
              n_out=sum(f.n_out for f in forests))
    packets = _packets(ds, cuda)
    c_plain = torch.empty((ds.n_flows, len(merged)), device=cuda)
    want = fused_multi_forest_infer_plain(*packets, *tables, columns=c_plain,
                                          **kw)
    c = torch.empty((ds.n_flows, len(merged)), device=cuda)
    got = fused_multi_forest_call(*packets, *tables, columns=c, **kw)
    assert torch.equal(c, c_plain)
    assert torch.equal(got, want)
    if case == "past_shared_limit":
        assert torch.equal(fused_multi_forest_call(*packets, *tables, **kw),
                           want)
    lo = 0
    for plan, r, f in zip(plans, reps, forests):
        solo = fused_pipeline_call(
            *packets, *forest_tables(f, cuda),
            op_table=torch.from_numpy(encode_plan(plan)).to(cuda),
            depth=r.depth, forest_depth=f.depth)
        assert torch.equal(want[:, lo:lo + f.n_out], solo)
        lo += f.n_out


def test_multi_kernel_in_a_cuda_graph(cuda):  # noqa: F811
    """B4 reads nothing back, so a CUDA graph captures it: replayed after
    other flows' packets are copied in, it equals an eager call and the
    plain version."""
    ds, reps, forests = _multi_case("tenants")
    plans = [stats_plan(r.features) for r in reps]
    merged, cols = merge_stats_plans(plans, [r.depth for r in reps])
    tables = multi_forest_tables(forests, cols, cuda)[:5]
    kw = dict(op_table=torch.from_numpy(encode_merged_plan(merged)).to(cuda),
              depth=max(r.depth for r in reps),
              n_out=sum(f.n_out for f in forests))
    packets = _packets(ds.take(np.arange(64)), cuda)
    fused_multi_forest_call(*packets, *tables, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_multi_forest_call(*packets, *tables, **kw)
    for shift in (0, 7, 31):
        new = _packets(ds.take((np.arange(64) + shift) % ds.n_flows), cuda)
        for dst, src in zip(packets, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fused_multi_forest_call(*packets, *tables, **kw))
        assert torch.equal(out, fused_multi_forest_infer_plain(
            *packets, *tables, **kw))


def test_multi_pipeline_on_card_matches_cpu(cuda):  # noqa: F811
    ds, reps, forests = _multi_case("tenants")
    n0 = fused_multi_forest_call.launches
    cpu = build_multi_tenant_pipeline(reps, forests, fused=True, device="cpu")
    gpu = build_multi_tenant_pipeline(reps, forests, fused=True)
    gpu.warm([1, 8])
    np.testing.assert_array_equal(gpu.probabilities(ds), cpu.probabilities(ds))
    np.testing.assert_array_equal(gpu(ds), cpu(ds))
    assert fused_multi_forest_call.launches == n0 + 4


def _multi_args(dev, N=2, P=4, F=3, K=2):
    f32, u8 = torch.zeros((N, P), device=dev), torch.zeros(
        (N, P), dtype=torch.uint8, device=dev)
    per_flow = [torch.zeros(N, dtype=torch.int32, device=dev)] + [
        torch.zeros(N, device=dev)] * 3
    tables = [torch.zeros((1, 1), dtype=torch.int32, device=dev),
              torch.zeros((1, 1), device=dev), torch.zeros((1, 2, K), device=dev),
              torch.tensor([[0, 1, 1, 1, 1, K, 0]], dtype=torch.int32, device=dev),
              torch.ones(1, device=dev)]
    op = torch.zeros((F, 5), dtype=torch.int32, device=dev)
    return ([f32, f32, u8, f32, f32, torch.zeros((N, P, 8), dtype=torch.uint8,
                                                 device=dev), *per_flow, *tables],
            dict(op_table=op, depth=P, n_out=K))


def test_multi_kernel_refuses_what_it_does_not_take(cuda):  # noqa: F811
    args, kw = _multi_args(cuda)
    fused_multi_forest_call(*args, **kw)        # the base case launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_multi_forest_call(*_multi_args("cpu")[0], **kw)
    # a plan wider than shared memory holds, and a window longer than the
    # shared-memory chunk, launch
    wide = MAX_MERGED_COLUMNS + 1
    assert fused_multi_forest_call(*_multi_args(cuda, F=wide)[0], **{
        **kw, "op_table": torch.zeros((wide, 5), dtype=torch.int32,
                                      device=cuda)}).shape == (2, 2)
    long, kw_l = _multi_args(cuda, P=MAX_WINDOW + 1)
    assert fused_multi_forest_call(*long, **kw_l).shape == (2, 2)
    with pytest.raises(ValueError, match="shape"):
        fused_multi_forest_call(*args, **{**kw, "op_table": kw["op_table"][:, :4]
                                          .contiguous()})


# ---------------------------------------------------------------------------
# the LM kernels: B6, B7 and B8 against their plain versions on the same
# inputs; tolerances those of tests/test_kernels.py (float32 2e-5, 3e-4 for
# the scan; bfloat16 2e-2, one rounding of outputs of magnitude ~1)
# ---------------------------------------------------------------------------

def _randn(R, shape, dev, dtype=torch.float32, scale=1.0):
    a = (R.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D", [
    (2, 4, 2, 256, 256, 64), (1, 8, 1, 128, 256, 128), (1, 2, 2, 200, 200, 32),
    (2, 4, 2, 192, 256, 128), (1, 2, 1, 300, 37, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, Hq, Hkv, Tq, Tk, D,  # noqa: F811
                                              causal, dtype):
    R = np.random.default_rng(Tq * Tk + D)
    q = _randn(R, (B, Hq, Tq, D), cuda, dtype)
    k = _randn(R, (B, Hkv, Tk, D), cuda, dtype)
    v = _randn(R, (B, Hkv, Tk, D), cuda, dtype)
    n0 = flash_attention_kernel_call.launches
    got = flash_attention_kernel_call(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_kernel_call.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("B,Hq,Hkv,T,D", [(2, 32, 8, 2048, 128),
                                          (2, 32, 32, 2048, 64)])
def test_flash_attention_bf16_at_main_shapes(cuda, B, Hq, Hkv, T, D):  # noqa: F811
    """The tensor-core kernel at qwen3-8b's and zamba2-1.2b's prefill
    shapes, causal, bitwise its plain version: the plain version's bf16
    GEMMs into float32 sum as wgmma does, and chip_smoke.py's prefill
    argmax check rests on it."""
    R = np.random.default_rng(T + D)
    q = _randn(R, (B, Hq, T, D), cuda, torch.bfloat16)
    k = _randn(R, (B, Hkv, T, D), cuda, torch.bfloat16)
    v = _randn(R, (B, Hkv, T, D), cuda, torch.bfloat16)
    got = flash_attention_kernel_call(q, k, v)
    assert torch.equal(got, flash_attention_plain(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_row_without_keys_on_card(cuda, dtype):  # noqa: F811
    """Causal with Tq > Tk: the first Tq - Tk rows see no key and give 0;
    the rest agree with the plain version."""
    R = np.random.default_rng(7)
    q = _randn(R, (1, 4, 200, 64), cuda, dtype)
    k = _randn(R, (1, 2, 72, 64), cuda, dtype)
    v = _randn(R, (1, 2, 72, 64), cuda, dtype)
    got = flash_attention_kernel_call(q, k, v, causal=True)
    assert torch.all(got[:, :, :128] == 0)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), flash_attention_plain(
        q, k, v, causal=True).float(), atol=tol, rtol=0)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (2, 4, 2, 256, 64), (3, 8, 8, 512, 32), (1, 16, 2, 300, 64),
    (4, 32, 8, 300, 128), (2, 9, 1, 77, 128), (8, 32, 32, 168, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda, B, Hq, Hkv, S, D,  # noqa: F811
                                               dtype):
    """The split kernel bitwise its plain version, which repeats its splits,
    sums and merge; an empty sequence gives 0."""
    R = np.random.default_rng(S * D + Hq)
    q = _randn(R, (B, Hq, D), cuda, dtype)
    kc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    vc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    lens = R.integers(1, S + 1, B)
    if B > 1:
        lens[0] = 0       # an empty sequence gives 0
    lens = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    n0 = decode_attention_kernel_call.launches
    got = decode_attention_kernel_call(q, kc, vc, lens)
    want = decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert decode_attention_kernel_call.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)
    if B > 1:
        assert torch.all(got[0] == 0)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (2, 4, 2, 256, 64), (4, 32, 8, 300, 128), (8, 40, 10, 16, 128),
    (8, 32, 32, 168, 64), (3, 7, 1, 300, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_stats_match_plain(cuda, B, Hq, Hkv, S, D,  # noqa: F811
                                            dtype):
    """With the rows' statistics (M, L) asked for, one launch writes them
    bitwise the plain version's, an empty row (-1e30, 0), and the output
    bitwise what it is without them."""
    R = np.random.default_rng(S * D + Hq + 1)
    q = _randn(R, (B, Hq, D), cuda, dtype)
    kc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    vc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    lens = R.integers(1, S + 1, B)
    lens[0] = 0
    lens = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    out = decode_attention_kernel_call(q, kc, vc, lens)
    n0 = decode_attention_kernel_call.launches
    got, st = decode_attention_kernel_call(q, kc, vc, lens, stats=True)
    want, st_plain = decode_attention_plain(q, kc, vc, lens, stats=True)
    torch.cuda.synchronize()
    assert decode_attention_kernel_call.launches == n0 + 1
    assert st.dtype == torch.float32 and st.shape == (B, Hq, 2)
    assert torch.equal(got, out) and torch.equal(got, want)
    assert torch.equal(st, st_plain)
    assert torch.all(st[0, :, 0] == -1e30) and torch.all(st[0, :, 1] == 0)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 4, 1, 200, 64), (2, 8, 2, 700, 128), (2, 8, 8, 1100, 32),
    (8, 32, 8, 4096, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_at_split_edges(cuda, B, Hq, Hkv, S, D,  # noqa: F811
                                                dtype):
    """Lengths 0, 1, S and one either side of each split boundary, bitwise
    the plain version (qwen3-8b's decode shape among them)."""
    n_split, split_len = split_plan(B, Hkv, S)
    assert n_split > 1
    R = np.random.default_rng(S + D)
    q = _randn(R, (B, Hq, D), cuda, dtype)
    kc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    vc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    edges = {0, 1, S}
    for e in range(split_len, S, split_len):
        edges.update((e - 1, e, e + 1))
    edges = sorted(edges)
    for i in range(0, len(edges), B):
        lens = torch.tensor((edges[i:i + B] * B)[:B], dtype=torch.int32,
                            device=cuda)
        got = decode_attention_kernel_call(q, kc, vc, lens)
        assert torch.equal(got, decode_attention_plain(q, kc, vc, lens)), \
            lens.tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_in_a_cuda_graph(cuda, dtype):  # noqa: F811
    """The launch reads nothing back, so a CUDA graph captures it: replayed
    after new lengths are copied in, it equals an eager call."""
    B, Hq, Hkv, S, D = 8, 32, 8, 1024, 128
    R = np.random.default_rng(11)
    q = _randn(R, (B, Hq, D), cuda, dtype)
    kc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    vc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    lens = torch.from_numpy(R.integers(1, S + 1, B).astype(np.int32)).to(cuda)
    decode_attention_kernel_call(q, kc, vc, lens)    # warm: attributes set
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_kernel_call(q, kc, vc, lens)
    for new in (R.integers(0, S + 1, B), np.full(B, S), np.arange(B) * 97):
        lens.copy_(torch.from_numpy(new.astype(np.int32)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, decode_attention_kernel_call(q, kc, vc, lens))
        assert torch.equal(out, decode_attention_plain(q, kc, vc, lens))


# the reduced configs' head dims (yi-34b 8, starcoder2-7b 12, qwen3-8b 16,
# phi3-medium-14b 20), and two padded to the wider tiles (40 -> 64, 96 ->
# 128)
SMALL_HEAD_DIMS = (8, 12, 16, 20, 40, 96)


@pytest.mark.parametrize("D", SMALL_HEAD_DIMS)
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk", [(2, 7, 1, 200, 328),
                                            (1, 4, 2, 77, 77)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_small_head_dims_bitwise(cuda, D, B, Hq, Hkv, Tq,  # noqa: F811
                                                 Tk, causal, dtype):
    """A head dim below the kernels' tile width runs on rows zero-padded
    to it (the float32 kernel pads as it loads, the bf16 kernel's TMA boxes
    reach past the rows' ends; a bf16 D of 12 or 20 is first copied to 16
    or 24, as TMA needs 16-byte rows): bitwise the plain version, which
    pads to the tile width, at ragged lengths and with 7 query heads a kv
    head."""
    R = np.random.default_rng(D * 7 + Tq)
    q = _randn(R, (B, Hq, Tq, D), cuda, dtype)
    k = _randn(R, (B, Hkv, Tk, D), cuda, dtype)
    v = _randn(R, (B, Hkv, Tk, D), cuda, dtype)
    n0 = flash_attention_kernel_call.launches
    got = flash_attention_kernel_call(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_kernel_call.launches == n0 + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("D", SMALL_HEAD_DIMS)
@pytest.mark.parametrize("B,Hq,Hkv,S", [(2, 14, 2, 700), (4, 7, 1, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_small_head_dims_bitwise(cuda, D, B, Hq, Hkv, S,  # noqa: F811
                                                  dtype):
    """B7 at a small head dim (rows zero-padded to the tile width in
    shared memory, loaded in 8- or 4-byte pieces where a row is not
    16-byte aligned) bitwise its plain version, at lengths 0, 1, S and
    either side of each split boundary, with 7 query heads a kv head."""
    n_split, split_len = split_plan(B, Hkv, S)
    R = np.random.default_rng(S + D)
    q = _randn(R, (B, Hq, D), cuda, dtype)
    kc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    vc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    edges = {0, 1, S}
    for e in range(split_len, S, split_len):
        edges.update((e - 1, e, e + 1))
    edges = sorted(edges)
    for i in range(0, len(edges), B):
        lens = torch.tensor((edges[i:i + B] * B)[:B], dtype=torch.int32,
                            device=cuda)
        got = decode_attention_kernel_call(q, kc, vc, lens)
        assert got.shape == q.shape and got.dtype == dtype
        assert torch.equal(got, decode_attention_plain(q, kc, vc, lens)), \
            lens.tolist()


@pytest.mark.parametrize("D", [8, 12, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_small_head_dim_in_a_cuda_graph(cuda, D, dtype):  # noqa: F811
    """At a padded head dim the launch still reads nothing back: replayed
    in a captured CUDA graph after new lengths are copied in, it equals an
    eager call and the plain version."""
    B, Hq, Hkv, S = 4, 7, 1, 1024
    R = np.random.default_rng(D)
    q = _randn(R, (B, Hq, D), cuda, dtype)
    kc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    vc = _randn(R, (B, S, Hkv, D), cuda, dtype)
    lens = torch.from_numpy(R.integers(1, S + 1, B).astype(np.int32)).to(cuda)
    decode_attention_kernel_call(q, kc, vc, lens)    # warm: attributes set
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_kernel_call(q, kc, vc, lens)
    for new in (R.integers(0, S + 1, B), np.full(B, S), np.arange(B) * 97):
        lens.copy_(torch.from_numpy(new.astype(np.int32)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, decode_attention_kernel_call(q, kc, vc, lens))
        assert torch.equal(out, decode_attention_plain(q, kc, vc, lens))


def _scan_inputs(R, B, T, H, P, S, dev, dtype):
    x = _randn(R, (B, T, H, P), dev, dtype, 0.5)
    dt = (_randn(R, (B, T, H), dev, scale=0.1).abs() + 0.01).contiguous()
    A = (-_randn(R, (H,), dev).abs() - 0.1).contiguous()
    Bm = _randn(R, (B, T, S), dev, dtype, 0.3)
    Cm = _randn(R, (B, T, S), dev, dtype, 0.3)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,T,H,P,S,chunk", [
    (1, 128, 2, 16, 8, 32), (2, 256, 4, 32, 16, 64), (1, 192, 1, 64, 4, 64),
    (2, 200, 3, 64, 16, 64), (2, 300, 4, 64, 64, 128),
    (2, 2048, 64, 64, 64, 128),    # zamba2-1.2b's prefill: 2,048 blocks
    (4, 512, 80, 64, 32, 128),     # 1,280 blocks, above 132 SMs x 8
    (2, 100, 4, 64, 64, 128),      # one chunk shorter than the tile
    (1, 1, 2, 64, 16, 128),        # one step
    (2, 1000, 8, 64, 16, 128),     # a ragged last chunk
    (1, 150, 2, 70, 10, 128)])     # two column groups, S not a multiple of 4
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_matches_plain(cuda, B, T, H, P, S, chunk,  # noqa: F811
                                         dtype):
    """The three-pass kernel bitwise its plain version: y and the final
    state. The plain version's cuBLAS GEMMs add each output's products in
    k order by FFMA, as the kernel's fmaf chains do."""
    R = np.random.default_rng(T * H + S)
    x, dt, A, Bm, Cm = _scan_inputs(R, B, T, H, P, S, cuda, dtype)
    n0 = mamba_scan_kernel_call.launches
    y, h = mamba_scan_kernel_call(x, dt, A, Bm, Cm, chunk=chunk)
    y_want, h_want = mamba_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert mamba_scan_kernel_call.launches == n0 + 1
    assert y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y, y_want)
    assert torch.equal(h, h_want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_bitwise_over_a_sweep(cuda, dtype):  # noqa: F811
    """Bitwise over 192 small shapes: batch 1 (a single GEMM in the plain
    version, which cuBLAS may split along k) and 2, one step (a GEMV) to
    ragged chunks, one and five heads, P 16 and 64, S 4 to 64, chunks 32
    and 128."""
    differ = []
    for B, T, H, P, S, chunk in itertools.product(
            (1, 2), (1, 17, 129, 300), (1, 5), (16, 64), (4, 16, 64),
            (32, 128)):
        R = np.random.default_rng(T * H + S + B)
        x, dt, A, Bm, Cm = _scan_inputs(R, B, T, H, P, S, cuda, dtype)
        y, h = mamba_scan_kernel_call(x, dt, A, Bm, Cm, chunk=chunk)
        y_p, h_p = mamba_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
        if not (torch.equal(y, y_p) and torch.equal(h, h_p)):
            differ.append((B, T, H, P, S, chunk))
    assert differ == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_in_a_cuda_graph(cuda, dtype):  # noqa: F811
    """The three launches read nothing back and the scratch is allocated
    by the wrapper, so a CUDA graph captures the call: replayed after new
    inputs are copied in, it equals an eager call and the plain version."""
    B, T, H, P, S = 2, 512, 8, 64, 64
    R = np.random.default_rng(5)
    x, dt, A, Bm, Cm = _scan_inputs(R, B, T, H, P, S, cuda, dtype)
    mamba_scan_kernel_call(x, dt, A, Bm, Cm)     # warm: attributes set
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, h = mamba_scan_kernel_call(x, dt, A, Bm, Cm)
    for seed in (6, 7):
        new = _scan_inputs(np.random.default_rng(seed), B, T, H, P, S, cuda,
                           dtype)
        for dst, src in zip((x, dt, A, Bm, Cm), new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        y_e, h_e = mamba_scan_kernel_call(x, dt, A, Bm, Cm)
        y_p, h_p = mamba_scan_plain(x, dt, A, Bm, Cm)
        assert torch.equal(y, y_e) and torch.equal(h, h_e)
        assert torch.equal(y, y_p) and torch.equal(h, h_p)


@pytest.mark.parametrize("n,P", [(73, 17), (5, 8), (256, 12), (1000, 128),
                                 (600, 4000), (4000, 128)])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8, torch.int32])
def test_flow_stats_kernel_bitwise_plain(cuda, n, P, mask_dtype):  # noqa: F811
    R = np.random.default_rng(n + P)
    v = torch.from_numpy((R.random((n, P)) * 1500).astype(np.float32)).to(cuda)
    m = torch.from_numpy(R.random((n, P)) < 0.4).to(cuda)
    m[0] = False                                     # an empty row
    m = m.to(mask_dtype)
    got = flow_stats_kernel_call(v, m)
    want = flow_stats_plain(v, m)
    empty = flow_stats_kernel_call(v, torch.zeros_like(m))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.all(got[0] == 0) and torch.all(empty == 0)


@pytest.mark.parametrize("P", [127, 128, 129, 511, 512, 513, 1023, 2047, 2048,
                               2049, 4095, 4096, 4097, 5003])
def test_flow_stats_kernel_at_split_edges(cuda, P):  # noqa: F811
    """B5 bitwise its plain version just below, at and above the multiples
    of its split (parts of 128-packet steps: one part up to 512 packets,
    two from 513, four from 1025, eight from 2049), at P not a multiple of
    4 (the scalar loads) and on a row whose start is not 16-byte aligned
    (a view one row in); a masked non-finite value makes the sums NaN, as
    in the reference."""
    R = np.random.default_rng(P)
    v = torch.from_numpy((R.random((41, P)) * 1500).astype(np.float32)).to(cuda)
    m = torch.from_numpy(R.random((41, P)) < 0.4).to(cuda)
    m[0] = False
    got = flow_stats_kernel_call(v, m)
    torch.cuda.synchronize()
    assert torch.equal(got, flow_stats_plain(v, m))
    assert torch.equal(flow_stats_kernel_call(v[1:], m[1:]),
                       flow_stats_plain(v[1:], m[1:]))
    v[3, P // 2], m[3, P // 2] = float("inf"), False
    got = flow_stats_kernel_call(v, m)
    want = flow_stats_plain(v, m)
    assert torch.isnan(got[3, 1]) and torch.isnan(want[3, 1])
    assert torch.equal(got[:, [0, 3, 4]], want[:, [0, 3, 4]])


# ---------------------------------------------------------------------------
# whisper-small's attention shapes and the MoE layer on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk", [
    (2, 12, 12, 1024, 1024),      # the encoder (and the served cross attention)
    (2, 12, 12, 448, 1500),       # decoder positions against 30 s of memory
    (2, 12, 12, 40, 48)])         # the reduced config's cross attention
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_whisper_shapes_bitwise(cuda, B, Hq, Hkv, Tq, Tk,  # noqa: F811
                                                dtype):
    """B6 non-causal at whisper-small's head dim 64, with Tq = Tk (the
    encoder) and Tq != Tk (cross attention), bitwise its plain version."""
    R = np.random.default_rng(Tq + Tk)
    q = _randn(R, (B, Hq, Tq, 64), cuda, dtype)
    k = _randn(R, (B, Hkv, Tk, 64), cuda, dtype)
    v = _randn(R, (B, Hkv, Tk, 64), cuda, dtype)
    got = flash_attention_kernel_call(q, k, v, causal=False)
    assert torch.equal(got, flash_attention_plain(q, k, v, causal=False))


@pytest.mark.parametrize("S", [168, 1500])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_at_mem_len_bitwise(cuda, S, dtype):  # noqa: F811
    """B7 as whisper's decode cross-attends its memory: every length
    mem_len = S (the served cache's 168, the reference's cap of 1500),
    12 and 12 heads of 64, bitwise its plain version."""
    R = np.random.default_rng(S)
    q = _randn(R, (8, 12, 64), cuda, dtype)
    kc = _randn(R, (8, S, 12, 64), cuda, dtype)
    vc = _randn(R, (8, S, 12, 64), cuda, dtype)
    lens = torch.full((8,), S, dtype=torch.int32, device=cuda)
    got = decode_attention_kernel_call(q, kc, vc, lens)
    assert torch.equal(got, decode_attention_plain(q, kc, vc, lens))


@pytest.mark.parametrize("N", [8, 4096])
def test_moe_combine_deterministic_on_card(cuda, N):  # noqa: F811
    """The MoE layer at qwen2-moe-a2.7b's routing (60 experts in 64 slots,
    top 4, 4 shared), narrow, in bf16 with each slot's weights drawn apart:
    two runs give the same bits (no atomics in dispatch or combine), at a
    decode batch that drops slots and a prefill batch."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.moe import MoE, moe_ref

    cfg = dataclasses.replace(configs.get("qwen2-moe-a2.7b"), d_model=256,
                              moe_d_ff=128)
    p = MoE(cfg.d_model, cfg, torch.bfloat16, cuda)
    gen = torch.Generator(device=cuda).manual_seed(N)
    for w in p.parameters():
        w.copy_(torch.randn(w.shape, generator=gen, device=cuda) * 0.05)
    x = torch.randn((1, N, cfg.d_model), generator=gen, device=cuda).to(
        torch.bfloat16)
    a, b = moe_ref(x, p, cfg), moe_ref(x, p, cfg)
    assert torch.isfinite(a.float()).all() and torch.equal(a, b)


# ---------------------------------------------------------------------------
# B6b and B8b: the gradients' kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal", [
    (2, 4, 2, 100, 100, 16, True), (1, 2, 1, 40, 90, 12, False),
    (2, 2, 2, 130, 70, 128, True), (2, 4, 4, 200, 300, 64, False),
    (1, 6, 2, 65, 65, 20, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_bitwise_plain(cuda, B, Hq, Hkv, Tq, Tk,  # noqa: F811
                                                  D, causal, dtype):
    """B6b against its plain version on the same inputs, bitwise, and the
    same bits on a second run (no atomics)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel_call,
        flash_attention_bwd_plain,
    )

    R = np.random.default_rng(Tq * 7 + D)
    q = _randn(R, (B, Hq, Tq, D), cuda, dtype)
    k = _randn(R, (B, Hkv, Tk, D), cuda, dtype)
    v = _randn(R, (B, Hkv, Tk, D), cuda, dtype)
    do = _randn(R, (B, Hq, Tq, D), cuda, dtype)
    o = flash_attention_kernel_call(q, k, v, causal=causal)
    got = flash_attention_bwd_kernel_call(q, k, v, o, do, causal=causal)
    again = flash_attention_bwd_kernel_call(q, k, v, o, do, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, w) and torch.equal(g, a)


@pytest.mark.parametrize("B,T,H,P,S,chunk", [
    (2, 100, 4, 64, 16, 128), (1, 37, 3, 16, 40, 128), (2, 300, 8, 64, 64, 128),
    (1, 16, 2, 32, 32, 128), (2, 300, 4, 64, 16, 64), (2, 200, 3, 80, 24, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_dh", [False, True])
def test_mamba_scan_bwd_kernel_bitwise_plain(cuda, B, T, H, P, S, chunk,  # noqa: F811
                                             dtype, with_dh):
    """B8b against its plain version on the same inputs, bitwise, with and
    without dh_last, at chunks of 128 (T above, below and at a ragged
    multiple of it), 64 and 32 (P above 64), and the same bits on a second
    run (no atomics)."""
    from repro_torch.kernels.mamba_scan import (
        mamba_scan_bwd_kernel_call,
        mamba_scan_bwd_plain,
    )

    R = np.random.default_rng(T + S)
    x = _randn(R, (B, T, H, P), cuda, dtype) * 0.5
    dt = _randn(R, (B, T, H), cuda).abs() * 0.1 + 0.01
    A = -_randn(R, (H,), cuda).abs() - 0.1
    Bm = _randn(R, (B, T, S), cuda, dtype) * 0.3
    Cm = _randn(R, (B, T, S), cuda, dtype) * 0.3
    dy = _randn(R, (B, T, H, P), cuda, dtype)
    dh = _randn(R, (B, H, P, S), cuda) if with_dh else None
    got = mamba_scan_bwd_kernel_call(x, dt, A, Bm, Cm, dy, dh, chunk=chunk)
    again = mamba_scan_bwd_kernel_call(x, dt, A, Bm, Cm, dy, dh, chunk=chunk)
    want = mamba_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dh, chunk=chunk)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(g, a)


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-1.2b", "whisper-small"])
def test_training_step_kernels_equal_plain(cuda, arch):  # noqa: F811
    """One step of `make_train_step` on a reduced config in float32: the
    kernel path (B6, B6b, B8, B8b) and the plain path give bitwise the same
    loss, gradient norm and updated parameters."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.kernels.mamba_scan import MambaScan
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import AdamW, init_state, make_train_step
    from repro_torch.train.data import make_batch

    cfg = configs.get_reduced(arch)
    batch = make_batch(cfg, ShapeSpec("t", 40, 2, "train"), 0, device=cuda)
    out = []
    for plain in (False, True):
        saved = ops.flash_attention, ops.mamba_scan
        if plain:
            ops.flash_attention = (
                lambda q, k, v, *, causal=True, scale=None:
                FlashAttention.apply(q, k, v, causal, scale, True))
            ops.mamba_scan = (
                lambda x, dt, A, Bm, Cm, *, chunk=128:
                MambaScan.apply(x, dt, A, Bm, Cm, chunk, True))
        try:
            opt = AdamW(lr=1e-3)
            state = init_state(cfg, 0, opt, device=cuda)
            state, met = make_train_step(cfg, opt, 2)(state, batch)
        finally:
            ops.flash_attention, ops.mamba_scan = saved
        out.append((met, [p.detach().clone()
                          for p in state["params"].parameters()]))
    (m0, p0), (m1, p1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_train_spans_cover_the_traced_step(cuda):  # noqa: F811
    """One step of the reduced qwen3-8b (remat by layer, 2 microbatches)
    under `torch.profiler`, traced as the benchmark traces its train cell
    (`perfbench.harness.profile_window`): the four ``train.*`` phases'
    device ms add up to at least 98% of the trace's busy seconds and no
    more than its window."""
    import dataclasses

    from perfbench.harness import profile_window
    from repro_torch import configs, spans
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import AdamW, init_state, make_train_step
    from repro_torch.train.data import make_batch

    cfg = dataclasses.replace(configs.get_reduced("qwen3-8b"), remat="block")
    opt = AdamW(lr=1e-3)
    state = init_state(cfg, 0, opt, device=cuda)
    step = make_train_step(cfg, opt, 2)
    batch = make_batch(cfg, ShapeSpec("t", 256, 4, "train"), 0, device=cuda)
    state, _ = step(state, batch)          # the build, cuBLAS's plans
    tr = profile_window(lambda: step(state, batch), host_ops=False)
    got = spans.totals()
    phases = sum(got[k]["device_ms"] for k in (
        "train.forward", "train.backward", "train.accumulate",
        "train.optimizer")) / 1e3
    assert 0.98 * tr.busy_s() <= phases <= tr.window_s


def test_adamw_update_waits_for_nothing(cuda):  # noqa: F811
    """`AdamW.update` on the card issues no host synchronisation, with a
    float and with a scheduled learning rate."""
    from repro_torch import configs
    from repro_torch.models import init_params
    from repro_torch.train import AdamW, cosine_schedule

    params = init_params(configs.get_reduced("qwen3-8b"), 0, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    for lr in (1e-3, cosine_schedule(1e-3, 2, 10)):
        opt = AdamW(lr=lr)
        state = opt.init(params)
        grads = {n: torch.randn(p.shape, generator=g, device=cuda)
                 for n, p in params.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.update(grads, state, params)
        finally:
            torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# the collectives and expert parallelism over NCCL
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_one(cuda, tmp_path):  # noqa: F811
    """A process group of one rank over NCCL on the card, and its mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_local_mesh

    init_distributed("cuda", 0, 1, f"file://{tmp_path / 'pg'}", local_rank=0)
    try:
        yield make_local_mesh(1, 1, "cuda")
    finally:
        dist.destroy_process_group()


def test_collectives_one_rank_over_nccl(nccl_one):
    """Over one rank every collective is the identity, forward and
    backward, bitwise, and each call is counted."""
    from repro_torch.parallel import all_gather, all_to_all, psum, psum_scatter
    from repro_torch.parallel.collectives import counts, reset_counts

    mesh = nccl_one
    g = torch.Generator(device="cuda").manual_seed(0)
    reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        for op in (lambda t: psum(t, "data", mesh),
                   lambda t: psum_scatter(t, "data", 1, mesh),
                   lambda t: all_gather(t, "data", 1, mesh),
                   lambda t: all_to_all(t, ("data", "model"), mesh)):
            x = torch.randn((6, 10, 4), generator=g, device="cuda").to(dtype)
            x.requires_grad_(True)
            y = op(x)
            w = torch.randn(y.shape, generator=g, device="cuda").to(dtype)
            (gx,) = torch.autograd.grad((y * w).sum(), [x])
            assert torch.equal(y, x) and torch.equal(gx, w)
    c = counts()
    assert {k: v["calls"] for k, v in c.items()} == {
        "all_reduce": 4, "reduce_scatter": 4, "all_gather": 4,
        "all_to_all": 4}


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"])
def test_moe_sharded_one_rank_is_moe_ref_at_c2(nccl_one, arch, dtype, cf):
    """At a world of one, `moe_sharded` over NCCL is `moe_ref` at the
    capacity factor that makes its capacity C2: output and every gradient
    bitwise, on the card."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe as tmoe

    mesh = nccl_one
    cfg = dataclasses.replace(configs.get_reduced(arch), n_expert_slots=8,
                              capacity_factor=cf)
    g = torch.Generator(device="cuda").manual_seed(1)
    p = tmoe.MoE(cfg.d_model, cfg, dtype, torch.device("cuda"))
    with torch.no_grad():
        for w in p.parameters():
            w.copy_(torch.randn(w.shape, generator=g, device="cuda") * 0.2)
    p.requires_grad_(True)
    B, T = 2, 96
    x = torch.randn((B, T, cfg.d_model), generator=g, device="cuda").to(dtype)
    x = (x + torch.randn(cfg.d_model, generator=g, device="cuda").to(dtype)
         ).requires_grad_(True)
    dy = torch.randn((B, T, cfg.d_model), generator=g, device="cuda").to(dtype)
    N, k = B * T, cfg.experts_per_tok
    C2 = tmoe._capacity(tmoe._capacity(N * k, 1, cf), cfg.expert_slots, cf)
    cf2 = (C2 - 0.5) * cfg.n_experts / (N * k)
    assert tmoe._capacity(N * k, cfg.n_experts, cf2) == C2
    ys = tmoe.moe_sharded(x, p, cfg, mesh, ep_axes=("data",))
    gs = torch.autograd.grad((ys * dy).sum(), [x, *p.parameters()])
    yr = tmoe.moe_ref(x, p, dataclasses.replace(cfg, capacity_factor=cf2))
    gr = torch.autograd.grad((yr * dy).sum(), [x, *p.parameters()])
    assert torch.equal(ys, yr)
    assert all(torch.equal(a, b) for a, b in zip(gs, gr))


def test_collectives_across_two_cards(cuda, tmp_path):  # noqa: F811
    """Two NCCL ranks, one a card: each collective's result on small
    integers, exactly."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from _torch_dist import run_world

    ranks = run_world(2, {"collectives_exact": {}}, tmp_path, device="cuda")
    for r in ranks:
        for name, (got, want) in r["collectives_exact"].items():
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_model_over_nccl_is_moe_ref_at_c2(nccl_one, dtype):
    """`loss_fn` of the reduced qwen2-moe (remat "block") through
    `moe_sharded` over an NCCL group of one: the loss and every gradient
    bitwise those through `moe_ref` at capacity C2. The backward, and with
    it each layer's recomputation, runs on autograd's device thread."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import moe as tmoe
    from repro_torch.models.config import ShapeSpec
    from repro_torch.parallel import parallel_ctx
    from repro_torch.train.data import make_batch

    mesh = nccl_one
    cfg = dataclasses.replace(configs.get_reduced("qwen2-moe-a2.7b"),
                              dtype=dtype, remat="block")
    params = init_params(cfg, 0, "cuda").requires_grad_(True)
    batch = make_batch(cfg, ShapeSpec("t", 40, 2, "train"), 0, device="cuda")
    N, k, cf = 80, cfg.experts_per_tok, cfg.capacity_factor
    C2 = tmoe._capacity(tmoe._capacity(N * k, 1, cf), cfg.expert_slots, cf)
    cf2 = (C2 - 0.5) * cfg.n_experts / (N * k)
    plist = list(params.parameters())
    with parallel_ctx(mesh):
        loss = loss_fn(params, batch, cfg)
        gs = torch.autograd.grad(loss, plist)
    ref = loss_fn(params, batch, dataclasses.replace(cfg, capacity_factor=cf2))
    gr = torch.autograd.grad(ref, plist)
    assert torch.equal(loss, ref)
    assert all(torch.equal(a, b) for a, b in zip(gs, gr))
