"""The port's multi-tenant serving (`repro_torch.traffic.multi_tenant`,
the merged extraction plan and the plain version of the multi-forest kernel
B4) against `repro.traffic.multi_tenant`.

The fixtures are the reference's own (`tests/test_multi_tenant.py`): the
zipf app-class set of 100 flows of up to 48 packets, seed 5, three tenants
over overlapping features at depths 8, 12 and 8, and their `tree-fast`
forests. Both sides serve the same forests, trained once by the reference.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.search_space import FeatureRep as JFeatureRep
from repro.core.search_space import SearchSpace as JSearchSpace
from repro.kernels.fused_pipeline import stack_multi_forests as j_stack
from repro.serve import runtime as jrt
from repro.traffic import TrafficProfiler as JProfiler
from repro.traffic import extract_features as j_extract
from repro.traffic import multi_tenant as jmt
from repro.traffic.extraction import merge_stats_plans as j_merge
from repro.traffic.models import train_traffic_model as j_train
from repro.traffic.synth import make_scenario_dataset as j_make_scenario

from _torch_parity import assert_straddle_parity, quantile_forest
from repro_torch.convert import forest_from_numpy, forest_tables, multi_forest_tables
from repro_torch.core.forest import train_forest
from repro_torch.core.search_space import FeatureRep, SearchSpace
from repro_torch.kernels.fused_pipeline import (
    SPEC_FIELDS,
    decode_merged_plan,
    encode_merged_plan,
    encode_plan,
    fused_forest_infer,
    fused_multi_forest_infer,
    stack_multi_forests,
)
from repro_torch.serve import runtime as prt
from repro_torch.traffic import TrafficProfiler
from repro_torch.traffic import multi_tenant as pmt
from repro_torch.traffic.extraction import (
    dataset_tensors,
    emit_merged_columns,
    extract_features,
    merge_stats_plans,
    stats_plan,
)
from repro_torch.traffic.features import FEATURE_NAMES
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_scenario_dataset

FEATURE_POOL = (
    "s_bytes_mean", "s_bytes_max", "s_iat_mean", "d_iat_std", "s_load",
    "d_load", "dur", "proto", "s_port", "s_ttl_mean", "d_pkt_cnt",
    "ack_cnt", "psh_cnt",
)
TENANT_REPS = (
    (("s_bytes_mean", "s_iat_mean", "proto", "s_load"), 8),
    (("s_bytes_mean", "s_bytes_max", "dur", "d_load"), 12),
    (("s_iat_mean", "s_load", "d_pkt_cnt", "ack_cnt"), 8),
)
REPS = tuple(FeatureRep(f, d) for f, d in TENANT_REPS)
J_REPS = tuple(JFeatureRep(f, d) for f, d in TENANT_REPS)
# the fixed clock constants of the reference's parity replays
SERVICE = dict(pkt_accum_ns=800.0, pkt_track_ns=200.0,
               bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5},
               gather_ns_per_flow=200.0, source="synthetic")
DS_KW = dict(n_flows=100, max_pkts=48, seed=5)


def _clip(ds, depth):
    """The (rows, depth) view a solo tenant's flow table would hold."""
    d = min(int(depth), ds.max_pkts)
    return dataclasses.replace(
        ds, ts=ds.ts[:, :d], size=ds.size[:, :d],
        direction=ds.direction[:, :d], ttl=ds.ttl[:, :d],
        winsize=ds.winsize[:, :d], flags=ds.flags[:, :d, :])


@pytest.fixture(scope="module")
def world():
    jds = j_make_scenario("app-class", "zipf", **DS_KW)
    ds = make_scenario_dataset("app-class", "zipf", **DS_KW)
    jforests, forests = [], []
    for t, rep in enumerate(J_REPS):
        X = np.asarray(j_extract(jds, rep.features, rep.depth))
        jf = j_train(X, jds.label, model="tree-fast", seed=t)[0]
        jforests.append(jf)
        forests.append(forest_from_numpy(jf.feature, jf.threshold, jf.leaf,
                                         jf.depth, jf.n_features, jf.classes))
    return jds, ds, tuple(jforests), tuple(forests)


def _j_merged_columns(merged, ds) -> np.ndarray:
    """The reference pipeline's merged extraction: `emit_merged_columns`
    under jit, where XLA contracts std's squares into FMAs as the port
    does (op-by-op dispatch would not)."""
    return np.asarray(jmt._merged_extract(
        ds.ts, ds.size, ds.direction, ds.ttl, ds.winsize,
        ds.flags.astype(np.float32), ds.flow_len, ds.proto, ds.s_port,
        ds.d_port, merged=merged))


def _merged_columns(merged, ds) -> np.ndarray:
    t = dataset_tensors(ds, torch.device("cpu"))
    return torch.stack(emit_merged_columns(merged, **t), dim=1).numpy()


def _random_reps(rng, max_depth):
    reps = []
    for _ in range(int(rng.integers(2, 5))):
        k = int(rng.integers(2, 6))
        feats = tuple(rng.choice(FEATURE_POOL, size=k, replace=False))
        reps.append(FeatureRep(feats, int(rng.integers(2, max_depth + 1))))
    return reps


# ---------------------------------------------------------------------------
# the merged plan
# ---------------------------------------------------------------------------

MERGE_CASES = {
    "tenants": [(f, d) for f, d in TENANT_REPS],
    "meta_across_depths": [(("proto",), 4), (("proto",), 16)],
    "registry_two_depths": [(FEATURE_NAMES, 50), (FEATURE_NAMES, 16)],
    "wide_three": [(FEATURE_NAMES, 50), (FEATURE_NAMES, 16),
                   (tuple(f for f in FEATURE_NAMES if not f.endswith("_med")),
                    50)],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_matches_reference(case):
    reps = MERGE_CASES[case]
    plans = [stats_plan(f) for f, _ in reps]
    depths = [d for _, d in reps]
    got = merge_stats_plans(plans, depths)
    assert got == j_merge(plans, depths)
    assert len(set(got[0])) == len(got[0])
    if case == "meta_across_depths":
        assert got == (((("meta", "proto"), 0),), ((0,), (0,)))
    if case.startswith(("registry", "wide")):
        # 64 window columns at each depth, the 3 meta columns once
        assert len(got[0]) == 131
    # the op table round-trips the merged plan
    assert decode_merged_plan(encode_merged_plan(got[0])) == got[0]


def test_merged_columns_equal_solo_extraction_bitwise(world):
    _, ds, _, _ = world
    rng = np.random.default_rng(7)
    sets = [list(REPS)] + [_random_reps(rng, 48) for _ in range(5)]
    sets.append([FeatureRep(FEATURE_NAMES, 50), FeatureRep(FEATURE_NAMES, 16)])
    for reps in sets:
        plans = [stats_plan(r.features) for r in reps]
        merged, cols = merge_stats_plans(plans, [r.depth for r in reps])
        X = _merged_columns(merged, _clip(ds, pmt.union_rep(reps).depth))
        for r, c in zip(reps, cols):
            solo = extract_features(_clip(ds, r.depth), r.features, r.depth,
                                    device="cpu")
            np.testing.assert_array_equal(
                X[:, list(c)], solo,
                err_msg=f"tenant {r.features}@{r.depth} columns differ")


@pytest.mark.parametrize("case", ["tenants", "random", "registry_50_16"])
def test_merged_columns_match_reference(world, case):
    """Bitwise where the window of a column's depth group is at most 32
    packets (XLA's CPU reduction adds in packet order there), float32
    rounding above it."""
    jds, ds, _, _ = world
    if case == "tenants":
        sets = [list(REPS)]
    elif case == "random":
        rng = np.random.default_rng(11)
        sets = [_random_reps(rng, 32) for _ in range(4)]
    else:
        sets = [[FeatureRep(FEATURE_NAMES, 50), FeatureRep(FEATURE_NAMES, 16)]]
    for reps in sets:
        plans = [stats_plan(r.features) for r in reps]
        merged, _ = merge_stats_plans(plans, [r.depth for r in reps])
        u = pmt.union_rep(reps).depth
        got = _merged_columns(merged, _clip(ds, u))
        want = _j_merged_columns(merged, _clip(jds, u))
        window = np.asarray([min(d, ds.max_pkts) for _, d in merged])
        small = window <= 32
        np.testing.assert_allclose(got[:, ~small], want[:, ~small],
                                   rtol=1e-5, atol=1e-6)
        if case != "registry_50_16":
            np.testing.assert_array_equal(got[:, small], want[:, small])
            continue
        assert (~small).sum() == 64 and small.sum() == 67
        # In the 67-feature program XLA leaves some of std's squares
        # uncontracted, where the port's explicit FMA rounds once: the
        # reference's own solo extraction at depth 16 gives the same values
        # as its merged one, and the port's differ from both by one ulp on
        # a few std values. Every other column is bitwise.
        std = np.asarray([e[0] == "stat" and e[3] == "std" for e, _ in merged])
        np.testing.assert_array_equal(got[:, small & ~std],
                                      want[:, small & ~std])
        ulps = (np.abs(got - want)[:, small & std]
                / np.spacing(np.abs(want[:, small & std])))
        assert ulps.max() <= 1 and (ulps > 0).sum() <= 0.01 * ulps.size


# ---------------------------------------------------------------------------
# stacked forests
# ---------------------------------------------------------------------------

def _stack_forests(ds):
    """Forests with ragged tree counts (padding), depths and class counts."""
    X = extract_features(ds, FEATURE_NAMES[:6], 8, device="cpu")
    out = []
    for n_trees, depth, k in ((12, 3, 3), (5, 4, 5), (25, 2, 2), (1, 5, 4)):
        out.append(train_forest(X, ds.label % k, n_trees=n_trees,
                                max_depth=depth,
                                rng=np.random.default_rng(n_trees)))
    cols = ((0, 1, 2, 3, 4, 5), (6, 1, 7, 8, 9, 10), (11, 12, 2, 13, 0, 14),
            (15, 16, 17, 18, 19, 20))
    return out, cols


@pytest.mark.parametrize("case", ["tenants", "ragged"])
def test_stacking_matches_reference(world, case):
    jds, ds, jforests, forests = world
    if case == "tenants":
        plans = [stats_plan(r.features) for r in REPS]
        _, cols = merge_stats_plans(plans, [r.depth for r in REPS])
        fs = forests
    else:
        fs, cols = _stack_forests(ds)
    feat, thr, leaf, tenants = stack_multi_forests(fs, cols)
    jfeat, jthr, jleaf, jtenants = j_stack(fs, cols)
    np.testing.assert_array_equal(feat.numpy(), np.asarray(jfeat))
    np.testing.assert_array_equal(thr.numpy(), np.asarray(jthr))
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    assert len(tenants) == len(jtenants)
    for got, want in zip(tenants, jtenants):
        assert len(got) == len(want) == 8
        for a, b in zip(got, want):
            assert type(a) is type(b) and a == b, (got, want)
    # the device tables: the same arrays, and the kernel's spec rows
    t = multi_forest_tables(fs, cols, device="cpu")
    for a, b in zip(t[:3], (feat, thr, leaf)):
        assert torch.equal(a, b)
    assert t[5] == tenants
    lane = 0
    for row, r, f, spec in zip(t[3].tolist(), t[4].tolist(), fs, tenants):
        s = dict(zip(SPEC_FIELDS, row))
        assert (s["offset"], s["trees_padded"], s["depth"], s["block_t"],
                s["classes"]) == (spec[0], spec[1], spec[2], spec[3], spec[6])
        assert s["trees"] == f.n_trees and s["lane"] == lane
        assert r == np.float32(spec[7])
        lane += s["classes"]


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes(world):
    jds, ds, jforests, forests = world
    return {
        "ref_unfused": jmt.build_multi_tenant_pipeline(J_REPS, jforests,
                                                       use_kernel=False),
        "ref_fused": jmt.build_multi_tenant_pipeline(J_REPS, jforests,
                                                     fused=True),
        "unfused": pmt.build_multi_tenant_pipeline(REPS, forests,
                                                   device="cpu"),
        "unfused_oracle": pmt.build_multi_tenant_pipeline(
            REPS, forests, use_kernel=False, device="cpu"),
        "fused": pmt.build_multi_tenant_pipeline(REPS, forests, fused=True,
                                                 device="cpu"),
    }


@pytest.mark.parametrize("port", ["fused", "unfused", "unfused_oracle"])
@pytest.mark.parametrize("ref", ["ref_unfused", "ref_fused"])
def test_pipeline_matches_reference(world, pipes, port, ref):
    jds, ds, _, forests = world
    pj, pp = pipes[ref], pipes[port]
    assert pp.merged == pj.merged and pp.tenant_cols == pj.tenant_cols
    assert pp.lanes == pj.lanes and pp.rep.key() == pj.rep.key()
    u = pp.rep.depth
    want = np.asarray(pj.probabilities(_clip(jds, u)))
    got = pp.probabilities(_clip(ds, u))
    assert got.shape == want.shape == (ds.n_flows, sum(f.n_out for f in forests))
    x_want = _j_merged_columns(pj.merged, _clip(jds, u))
    x_got = _merged_columns(pp.merged, _clip(ds, u))
    for (lo, hi), cols, f in zip(pp.lanes, pp.tenant_cols, forests):
        idx = list(cols)
        assert assert_straddle_parity(want[:, lo:hi], got[:, lo:hi],
                                      x_want[:, idx], x_got[:, idx], f) == 0
    np.testing.assert_array_equal(pp.finalize(torch.from_numpy(got)),
                                  np.asarray(pj.finalize(want)))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_each_lane_equals_the_solo_pipeline_bitwise(world, pipes, fused):
    _, ds, _, forests = world
    mt = pipes["fused" if fused else "unfused"]
    p = mt.probabilities(_clip(ds, mt.rep.depth))
    cls = mt.finalize(torch.from_numpy(p))
    assert cls.shape == (ds.n_flows, len(REPS))
    for t, ((lo, hi), rep, f) in enumerate(zip(mt.lanes, REPS, forests)):
        solo = build_pipeline(rep, f, max_pkts=rep.depth, fused=fused,
                              device="cpu")
        batch = _clip(ds, rep.depth)
        np.testing.assert_array_equal(p[:, lo:hi], solo.probabilities(batch),
                                      err_msg=f"tenant {t} lane")
        np.testing.assert_array_equal(cls[:, t], solo(batch))


def test_fused_equals_unfused_bitwise(world, pipes):
    _, ds, _, _ = world
    batch = _clip(ds, pipes["fused"].rep.depth)
    np.testing.assert_array_equal(pipes["fused"].probabilities(batch),
                                  pipes["unfused"].probabilities(batch))


def test_fused_columns_and_wide_window(world):
    """The plain B4 hands back its merged columns, and a window wider than
    the union depth changes nothing."""
    _, ds, _, forests = world
    mt = pmt.build_multi_tenant_pipeline(REPS, forests, fused=True,
                                         device="cpu")
    narrow = mt.probabilities(_clip(ds, mt.rep.depth))
    np.testing.assert_array_equal(mt.probabilities(ds), narrow)
    assert mt(ds).shape == (ds.n_flows, 3)


# four tenants over the whole registry at four depths: 3 meta columns and
# 4 x 64 windowed ones, above the 256 columns B4 once held a flow
WIDE_DEPTHS = (5, 10, 15, 20)


def test_plain_b4_at_259_columns_gives_solo_lanes():
    """The merged plan the card once refused (259 columns): B4's plain
    version serves each tenant the lanes of its solo B2 plain version."""
    ds = make_scenario_dataset("app-class", "zipf", n_flows=120, max_pkts=24,
                               seed=5)
    plans = [stats_plan(FEATURE_NAMES)] * len(WIDE_DEPTHS)
    merged, cols = merge_stats_plans(plans, WIDE_DEPTHS)
    assert len(merged) == 259
    assert (merged, cols) == j_merge(plans, WIDE_DEPTHS)
    rng = np.random.default_rng(259)
    t = dataset_tensors(ds, torch.device("cpu"))
    packets = [t[k] for k in ("ts", "size", "direction", "ttl", "winsize",
                              "flags", "flow_len", "proto", "s_port",
                              "d_port")]
    forests = [quantile_forest(extract_features(ds, FEATURE_NAMES, d,
                                                 device="cpu"), rng)
               for d in WIDE_DEPTHS]
    tables = multi_forest_tables(forests, cols, "cpu")[:5]
    x = torch.empty((ds.n_flows, len(merged)))
    lanes = fused_multi_forest_infer(
        *packets, *tables, op_table=torch.from_numpy(encode_merged_plan(merged)),
        depth=max(WIDE_DEPTHS), n_out=sum(f.n_out for f in forests),
        columns=x).numpy()
    lo = 0
    for plan, d, f, c in zip(plans, WIDE_DEPTHS, forests, cols):
        solo_x = torch.empty((ds.n_flows, len(plan)))
        solo = fused_forest_infer(
            *packets, *forest_tables(f, "cpu"),
            op_table=torch.from_numpy(encode_plan(plan)), depth=d,
            forest_depth=f.depth, columns=solo_x)
        np.testing.assert_array_equal(x.numpy()[:, list(c)], solo_x.numpy())
        np.testing.assert_array_equal(lanes[:, lo:lo + f.n_out], solo.numpy())
        lo += f.n_out


def _agg_rows(stream, depth):
    tbl = prt.FlowTable(256, depth, reuse=True, refresh_every=64,
                        agg_buffer=512)
    fid = stream.fid
    for lo in range(0, stream.n_events, 512):
        sl = slice(lo, lo + 512)
        f = fid[sl]
        tbl.observe_batch(stream.key[f], stream.base_t[sl],
                          stream.rel_ts32[sl], stream.size[sl],
                          stream.direction[sl], stream.ttl[sl],
                          stream.winsize[sl], stream.flags_byte[sl],
                          stream.proto[f], stream.s_port[f],
                          stream.d_port[f], f, stream.fin[sl])
    tbl.flush_agg()
    live = np.flatnonzero(tbl.ctrl["state"] != 0)
    return tbl.agg[live], tbl.proto[live], tbl.s_port[live], tbl.d_port[live]


def test_aggregate_entry_matches_reference(world, pipes):
    _, ds, _, forests = world
    pj, pp = pipes["ref_unfused"], pipes["fused"]
    assert pp.supports_agg and pj.supports_agg
    assert pp.drift_prob_slice == pj.drift_prob_slice == slice(*pp.lanes[0])
    assert pp.n_tenants == pj.n_tenants == 3
    rows = _agg_rows(prt.PacketStream.from_dataset(ds, seed=0), pp.rep.depth)
    assert len(rows[0]) > 16
    want = np.asarray(pj.predict_agg(*rows))
    got = pp.predict_agg(*rows).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pp.finalize(torch.from_numpy(got)),
                                  np.asarray(pj.finalize(want)))
    # the unfused pipeline's aggregate entry is the same route
    np.testing.assert_array_equal(pipes["unfused"].predict_agg(*rows).numpy(),
                                  got)
    # a median has no incremental form
    med = pmt.build_multi_tenant_pipeline(
        (FeatureRep(("s_bytes_med",), 8),) + REPS[1:],
        (train_forest(extract_features(ds, ("s_bytes_med",), 8, device="cpu"),
                      ds.label, n_trees=1, max_depth=3,
                      rng=np.random.default_rng(0)),) + forests[1:],
        device="cpu")
    assert not med.supports_agg
    with pytest.raises(ValueError, match="incremental"):
        med.predict_agg(*rows)


# ---------------------------------------------------------------------------
# serving: the shared fleet under eviction pressure
# ---------------------------------------------------------------------------

def _records(rt) -> list:
    return [[(r.bucket, r.reason, r.n_real, r.flush_ts, r.shard,
              tuple(r.flow_ids.tolist())) for r in s.dispatcher.records]
            for s in rt.shards]


def _fleet_replay(mod, pipe, stream):
    made = []

    def fleet():
        # capacity 64 < 100 flows forces table overflow and eviction
        made.append(mod.ShardedRuntime(pipe, n_shards=2, capacity=64,
                                       max_batch=32, flush_timeout_s=2e-4,
                                       execute=True))
        return made[-1]

    st = mod.replay(stream, fleet, stream.base_pps, mod.ServiceModel(**SERVICE),
                    ring_capacity=512)
    return st, made[0]


@pytest.fixture(scope="module")
def replays(world, pipes):
    jds, ds, _, forests = world
    jstream = jrt.PacketStream.from_dataset(jds, seed=0)
    stream = prt.PacketStream.from_dataset(ds, seed=0)
    out = {"ref": _fleet_replay(jrt, pipes["ref_unfused"], jstream),
           "fused": _fleet_replay(prt, pipes["fused"], stream),
           "unfused": _fleet_replay(prt, pipes["unfused"], stream)}
    out["solo"] = [
        _fleet_replay(prt, build_pipeline(r, f, max_pkts=r.depth, fused=True,
                                          device="cpu"), stream)[0]
        for r, f in zip(REPS, forests)]
    return out


@pytest.mark.parametrize("port", ["fused", "unfused"])
def test_shared_fleet_replay_matches_reference(replays, port):
    (want, rt_w), (got, rt_g) = replays["ref"], replays[port]
    assert len(got.predictions) > 0
    assert sorted(got.predictions) == sorted(want.predictions)
    for k, v in want.predictions.items():
        assert np.asarray(v).shape == (3,)
        np.testing.assert_array_equal(got.predictions[k], np.asarray(v))
    assert (got.drops, got.drops_ring, got.drops_table) == (
        want.drops, want.drops_ring, want.drops_table)
    assert got.drops_table > 0          # the tables do overflow
    m, mw = got.metrics, want.metrics
    assert m.tenant_predictions == mw.tenant_predictions == {
        t: m.flows_predicted for t in range(3)}
    assert {k: getattr(m, k) for k in m.counter_fields()} == {
        k: getattr(mw, k) for k in mw.counter_fields()}
    assert _records(rt_g) == _records(rt_w)
    assert got.stage_seconds == want.stage_seconds
    assert got.latency_p99_s == want.latency_p99_s


def test_shared_fleet_lanes_equal_solo_fleets(replays):
    got, _ = replays["fused"]
    for t, solo in enumerate(replays["solo"]):
        keys = sorted(got.predictions)
        assert keys == sorted(solo.predictions)
        np.testing.assert_array_equal(
            np.asarray([got.predictions[k][t] for k in keys]),
            np.asarray([solo.predictions[k] for k in keys]))


# ---------------------------------------------------------------------------
# the tuning half
# ---------------------------------------------------------------------------

def _spaces(mod_space):
    return tuple(mod_space(pool, max_depth=12) for pool in (
        FEATURE_POOL[:6], FEATURE_POOL[4:10], FEATURE_POOL[7:]))


def test_space_matches_reference():
    sp = pmt.MultiTenantSpace(_spaces(SearchSpace))
    sj = jmt.MultiTenantSpace(_spaces(JSearchSpace))
    assert (sp.dim, sp.size) == (sj.dim, sj.size)
    xs = sp.sample_uniform(np.random.default_rng(3), 16)
    xj = sj.sample_uniform(np.random.default_rng(3), 16)
    assert [x.key() for x in xs] == [x.key() for x in xj]
    np.testing.assert_array_equal(sp.encode_batch(xs), sj.encode_batch(xj))
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for a, b in zip(xs, xj):
        ma, mb = sp.mutate(ra, a), sj.mutate(rb, b)
        assert ma.key() == mb.key()
        assert ma.features == mb.features and ma.depth == mb.depth
        v = sp.encode(ma)
        assert sp.decode(v).key() == sj.decode(sj.encode(mb)).key()


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "independent"])
def test_joint_profiler_matches_reference(world, shared):
    jds, ds, _, _ = world
    pools = [f for f, _ in TENANT_REPS]
    jp = jmt.MultiTenantProfiler(
        [JProfiler(jds, pool, model="tree-fast", cost_mode="modeled")
         for pool in pools], shared=shared)
    pp = pmt.MultiTenantProfiler(
        [TrafficProfiler(ds, pool, model="tree-fast", cost_mode="modeled",
                         device="cpu") for pool in pools], shared=shared)
    for reps in (TENANT_REPS, [(f[:2], 4) for f, _ in TENANT_REPS]):
        got = pp(pmt.MultiTenantRep(tuple(FeatureRep(f, d) for f, d in reps)))
        want = jp(jmt.MultiTenantRep(tuple(JFeatureRep(f, d) for f, d in reps)))
        assert (got.cost, got.perf) == (want.cost, want.perf)
        assert got.aux == want.aux
    assert pp.n_profile_calls == jp.n_profile_calls == 2
