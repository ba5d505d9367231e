"""The port's streaming runtime (`repro_torch.serve.runtime`) against
`repro.serve.runtime`: packet streams, flow-table state, replays, the
zero-loss search, the modeled service constants and a mid-stream hot-swap.

The replay clock is a pure function of the stream and the service
constants, so under one fixed synthetic `ServiceModel` every drop, counter,
batch record and latency percentile must be exactly the reference's. The
predictions come from two pipelines whose columns agree to float32
rounding, so they follow the straddle rule.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.search_space import FeatureRep as JFeatureRep
from repro.serve import runtime as jrt
from repro.traffic import extract_features as j_extract
from repro.traffic import synth as jsynth
from repro.traffic.models import train_traffic_model as j_train
from repro.traffic.pipeline import build_pipeline as j_build

from _torch_parity import MAX_STRADDLED
from repro_torch.convert import forest_from_numpy
from repro_torch.core.search_space import FeatureRep
from repro_torch.kernels.ref import straddled_flows
from repro_torch.serve import runtime as prt
from repro_torch.traffic.extraction import extract_features
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_scenario_dataset

NAMES = ("dur", "s_load", "s_bytes_mean", "s_iat_mean", "ack_cnt")
DEPTH = 8
# the fixed clock constants of the reuse A/B's parity replays
# (benchmarks/bench_runtime.py), on both sides
SERVICE = dict(pkt_accum_ns=800.0, pkt_track_ns=200.0,
               bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5},
               gather_ns_per_flow=200.0, pkt_frozen_ns=100.0,
               source="synthetic")


@dataclasses.dataclass
class Side:
    """One implementation's module, pipeline, stream and service model."""
    rt: object
    pipe: object
    stream: object
    svc: object
    x: np.ndarray          # batch feature columns at DEPTH, for the straddle rule


@pytest.fixture(scope="module")
def world():
    kw = dict(n_flows=60, max_pkts=400, seed=3)
    jds = jsynth.make_scenario_dataset("app-class", "zipf", **kw)
    ds = make_scenario_dataset("app-class", "zipf", **kw)
    xj = np.asarray(j_extract(jds, NAMES, DEPTH))
    jf, _ = j_train(xj, jds.label, model="tree-fast", seed=0)
    tf = forest_from_numpy(jf.feature, jf.threshold, jf.leaf, jf.depth,
                           jf.n_features, jf.classes)
    ref = Side(jrt, j_build(JFeatureRep(NAMES, DEPTH), jf, DEPTH,
                            use_kernel=False),
               jrt.PacketStream.from_dataset(jds, seed=0),
               jrt.ServiceModel(**SERVICE), xj)
    port = Side(prt, build_pipeline(FeatureRep(NAMES, DEPTH), tf, DEPTH,
                                    fused=True, device="cpu"),
                prt.PacketStream.from_dataset(ds, seed=0),
                prt.ServiceModel(**SERVICE),
                extract_features(ds, NAMES, DEPTH, device="cpu"))
    return ref, port, tf


# ---------------------------------------------------------------------------
# packet streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario,arrivals", [("uniform", "uniform"),
                                               ("zipf", "uniform"),
                                               ("zipf", "burst")])
def test_packet_stream_matches_reference(scenario, arrivals):
    kw = dict(n_flows=40, max_pkts=96, seed=5)
    jds = jsynth.make_scenario_dataset("iot-class", scenario, **kw)
    ds = make_scenario_dataset("iot-class", scenario, **kw)
    want = jrt.PacketStream.from_dataset(jds, seed=2, scenario=arrivals)
    got = prt.PacketStream.from_dataset(ds, seed=2, scenario=arrivals)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# flow table
# ---------------------------------------------------------------------------

def _packets(n_flows, n_pkts, seed):
    """Zipf-skewed interleaved packets with double-FIN closes mid-stream on
    the hottest flows, which recycles their slots and re-tenants the key."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**63, n_flows).astype(np.uint64)
    w = 1.0 / np.arange(1, n_flows + 1) ** 1.1
    fidx = rng.choice(n_flows, n_pkts, p=w / w.sum())
    t = np.cumsum(rng.random(n_pkts) * 1e-4)
    fin = np.zeros(n_pkts, bool)
    dirn = rng.integers(0, 2, n_pkts)
    for f in range(n_flows // 4):
        hits = np.flatnonzero(fidx == f)
        if hits.size > 20:
            fin[hits[hits.size // 2]] = True
            dirn[hits[hits.size // 2]] = 0
            fin[hits[hits.size // 2 + 1]] = True
            dirn[hits[hits.size // 2 + 1]] = 1
    return (keys[fidx], t, t.astype(np.float32).astype(np.float64),
            rng.integers(40, 1500, n_pkts).astype(np.float64), dirn,
            rng.integers(30, 128, n_pkts).astype(np.float64),
            rng.integers(0, 65535, n_pkts).astype(np.float64),
            rng.integers(0, 256, n_pkts), np.full(n_pkts, 6.0),
            rng.integers(1024, 65535, n_pkts).astype(np.float64),
            np.full(n_pkts, 443.0), fidx.astype(np.int64), fin)


def _drive_table(mod, case, p):
    """Feed `p` through a fresh table of `mod` as `case` says; marks READY
    flows PREDICTED as the dispatcher would, and returns the table."""
    reuse = case != "plain"
    kw = dict(reuse=reuse, refresh_every=16 if reuse else 0,
              anchor_dim=3 if reuse else 0, agg_buffer=97,
              metrics=mod.RuntimeMetrics())
    cap = 24 if case == "overflow" else 256
    tbl = mod.FlowTable(cap, DEPTH, idle_timeout_s=0.01, **kw)
    n = len(p[0])
    chunk = {"scalar": 1, "overflow": 61}.get(case, 128)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        if case == "scalar":
            args = [a[lo] for a in p]
            st, sl = tbl.observe(int(args[0]), float(args[1]), float(args[2]),
                                 float(args[3]), int(args[4]), float(args[5]),
                                 float(args[6]), int(args[7]), float(args[8]),
                                 float(args[9]), float(args[10]), int(args[11]),
                                 bool(args[12]))
            st, sl = np.array([int(st)]), np.array([sl])
        else:
            st, sl, _ = tbl.observe_batch(*(a[lo:hi] for a in p))
        ready = (st == int(mod.FlowStatus.READY)) | (
            st == int(mod.FlowStatus.READY_EOF))
        if ready.any():
            tbl.mark_predicted(sl[ready])
        if reuse:
            due = tbl.take_refresh_due()
            if due:
                tbl.anchor[np.asarray(due)] = 1.5   # a refresh re-anchors
                tbl.anchor_valid[np.asarray(due)] = True
        if case == "evict" and lo // chunk % 7 == 6:
            tbl.evict_idle(float(p[1][hi - 1]))
    if case == "move":
        dst = mod.FlowTable(256, DEPTH, idle_timeout_s=0.01, **{
            **kw, "metrics": mod.RuntimeMetrics()})
        for s in np.flatnonzero(tbl.ctrl["state"] != 0):
            mod.move_slot(tbl, dst, int(s))
        tbl = dst
    if reuse:
        tbl.flush_agg()
    return tbl


@pytest.mark.parametrize("case", ["plain", "reuse", "scalar", "overflow",
                                  "evict", "move"])
def test_flow_table_state_bitwise(case):
    n = 300 if case == "scalar" else 3000
    p = _packets(40, n, seed=7)
    want = _drive_table(jrt, case, p)
    got = _drive_table(prt, case, p)
    arrays = {k: v for k, v in vars(want).items() if isinstance(v, np.ndarray)}
    must = {"ctrl", "ts", "size", "direction", "flags", "proto"}
    if case != "plain":
        must |= {"agg", "anchor", "anchor_valid", "refresh_pending"}
    assert must <= set(arrays)
    for k, a in arrays.items():
        b = getattr(got, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert _counters(got.metrics) == _counters(want.metrics)
    if case == "overflow":
        assert want.metrics.drops_table > 0
    if case == "evict":
        assert want.metrics.flows_evicted_idle > 0


def _counters(m) -> dict:
    return {k: getattr(m, k) for k in m.counter_fields()}


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def _runtime(side: Side, shards: int, capacity: int, reuse, execute=True):
    mod = side.rt
    ru = None if reuse is None else mod.ReuseConfig(
        drift_threshold=reuse[0], refresh_every=reuse[1])
    kw = dict(capacity=capacity, max_batch=8, flush_timeout_s=2e-4,
              execute=execute, reuse=ru)
    if shards == 1:
        return mod.StreamingRuntime(side.pipe, **kw)
    return mod.ShardedRuntime(side.pipe, n_shards=shards, **kw)


def _records(rt) -> list:
    disps = [s.dispatcher for s in getattr(rt, "shards", [rt])]
    return [[(r.bucket, r.reason, r.n_real, r.flush_ts, r.shard,
              r.n_checked, r.n_anchor, tuple(r.flow_ids.tolist()))
             for r in d.records] for d in disps]


def _replay(side: Side, rate_mult: float, **rt_kw):
    made = []

    def mk():
        made.append(_runtime(side, **rt_kw))
        return made[-1]

    st = side.rt.replay(side.stream, mk, side.stream.base_pps * rate_mult,
                        side.svc, ring_capacity=max(64, side.stream.n_events // 6))
    return st, made[0]


def assert_predictions(want: dict, got: dict, ref: Side, port: Side, forest):
    """Same flows predicted; flows that differ are straddled by the batch
    columns of the two sides, and at most 1% of flows straddle."""
    assert set(got) == set(want)
    s = straddled_flows(ref.x, port.x, forest.feature, forest.threshold,
                        forest.depth)
    assert s.sum() <= MAX_STRADDLED * len(s)
    differ = [k for k in want if not np.array_equal(want[k], got[k])]
    assert all(s[k] for k in differ), differ


@pytest.mark.parametrize("shards,capacity,rate_mult", [(1, 256, 3),
                                                       (1, 256, 1000),
                                                       (4, 32, 3000)])
@pytest.mark.parametrize("reuse", [None, (0.1, 64)], ids=["off", "reuse"])
def test_replay_matches_reference(world, shards, capacity, rate_mult, reuse):
    ref, port, forest = world
    kw = dict(shards=shards, capacity=capacity, reuse=reuse)
    want, rt_w = _replay(ref, rate_mult, **kw)
    got, rt_g = _replay(port, rate_mult, **kw)
    assert (got.drops, got.drops_ring, got.drops_table) == (
        want.drops, want.drops_ring, want.drops_table)
    if rate_mult >= 1000:
        assert want.drops > 0      # the case does exercise loss
    assert _counters(got.metrics) == _counters(want.metrics)
    assert got.metrics.batch_occupancy == want.metrics.batch_occupancy
    assert got.metrics.shapes_seen == want.metrics.shapes_seen
    assert _records(rt_g) == _records(rt_w)
    assert got.latency_p50_s == want.latency_p50_s
    assert got.latency_p99_s == want.latency_p99_s
    assert got.stage_seconds == want.stage_seconds
    assert got.load_imbalance == want.load_imbalance
    assert_predictions(want.predictions, got.predictions, ref, port, forest)


def test_zero_loss_rate_matches_reference(world):
    ref, port, forest = world
    out = []
    for side in (ref, port):
        def mk(execute, side=side):
            return _runtime(side, 4, 256, (0.1, 64), execute=execute)
        out.append(side.rt.find_zero_loss_rate(
            side.stream, mk, side.svc, iters=4,
            ring_capacity=max(64, side.stream.n_events // 6)))
    (r_w, want), (r_g, got) = out
    assert r_g == r_w
    assert got.drops == want.drops == 0
    assert _counters(got.metrics) == _counters(want.metrics)
    assert (got.latency_p50_s, got.latency_p99_s) == (
        want.latency_p50_s, want.latency_p99_s)
    assert_predictions(want.predictions, got.predictions, ref, port, forest)


@pytest.mark.parametrize("discount", [1.0, 0.4])
def test_modeled_service_matches_reference(world, discount):
    ref, port, _ = world
    want = jrt.ServiceModel.modeled(ref.pipe.rep, ref.pipe.forest,
                                    reuse_discount=discount)
    got = prt.ServiceModel.modeled(port.pipe.rep, port.pipe.forest,
                                   reuse_discount=discount)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    reps = [JFeatureRep(NAMES, DEPTH), JFeatureRep(("dur", "s_iat_med"), 12)]
    want = jrt.ServiceModel.modeled_multi_tenant(reps, [ref.pipe.forest] * 2)
    got = prt.ServiceModel.modeled_multi_tenant(
        [FeatureRep(r.features, r.depth) for r in reps], [port.pipe.forest] * 2)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_hot_swap_mid_stream_exactly_once(world):
    """Drain-and-swap onto a deeper pipeline halfway through the stream:
    every flow is predicted exactly once, as in the reference, by the same
    configuration, with the same counters and flush log."""
    ref, port, _ = world
    depth_b, names_b = 12, NAMES[:3] + ("s_bytes_std",)
    jds = jsynth.make_scenario_dataset("app-class", "zipf", n_flows=60,
                                       max_pkts=400, seed=3)
    jf, _ = j_train(np.asarray(j_extract(jds, names_b, depth_b)), jds.label,
                    model="tree-fast", seed=1)
    pipes_b = {
        "ref": j_build(JFeatureRep(names_b, depth_b), jf, depth_b,
                       use_kernel=False),
        "port": build_pipeline(
            FeatureRep(names_b, depth_b),
            forest_from_numpy(jf.feature, jf.threshold, jf.leaf, jf.depth,
                              jf.n_features, jf.classes),
            depth_b, fused=True, device="cpu"),
    }
    out = {}
    for tag, side in (("ref", ref), ("port", port)):
        s, mod = side.stream, side.rt
        rt = mod.StreamingRuntime(
            side.pipe, capacity=512, max_batch=16,
            reuse=mod.ReuseConfig(drift_threshold=0.1, refresh_every=32))
        E, cut, fid = s.n_events, s.n_events // 2, s.fid
        for lo in range(0, E, 512):
            sl = slice(lo, min(lo + 512, E))
            rt.ingest_packets(
                s.key[fid[sl]], s.base_t[sl], s.rel_ts32[sl], s.size[sl],
                s.direction[sl], s.ttl[sl], s.winsize[sl], s.flags_byte[sl],
                s.proto[fid[sl]], s.s_port[fid[sl]], s.d_port[fid[sl]],
                fid[sl], s.fin[sl])
            if lo <= cut < sl.stop:
                rt.hot_swap(pipes_b[tag], float(s.base_t[sl.stop - 1]))
                assert rt.pipeline is pipes_b[tag]
                assert rt.table.pkt_depth == depth_b
        rt.drain(float(s.base_t[-1]) + 1.0)
        m = rt.metrics
        assert m.drops == 0 and m.duplicate_predictions == 0
        assert len(rt.results) == s.n_flows
        assert m.flows_migrated_in == m.flows_migrated_out > 0
        out[tag] = ({k: int(v) for k, v in rt.results.items()},
                    _counters(m), _records(rt))
    # the columns of both configurations are bitwise equal to the
    # reference's at these depths (sums of up to 32 packets run in packet
    # order on both sides), so every prediction is the reference's
    assert out["port"] == out["ref"]
