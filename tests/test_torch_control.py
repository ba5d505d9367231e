"""The port's control plane (`repro_torch.serve.control`) against
`repro.serve.control`: the planners on the same inputs, and the three acts
of `examples/serve_control.py` at its own size (zipf app-class, 120 flows
of up to 256 packets) replayed by both packages under the example's fixed
synthetic `ServiceModel`.

The replay clock and the control plane are pure functions of the stream,
the service constants and the predictions' timing, so drops, zero-loss
rates, the `control` summary, the audit log's kinds and order, and every
counter must be exactly the reference's. The reference's pipelines are
its `use_kernel=False` ones, the port's run B2's plain version on the CPU
with the same forests; predictions follow the straddle rule.
"""
import dataclasses
import types

import numpy as np
import pytest

import repro.serve as jserve
from repro.core.search_space import FeatureRep as JFeatureRep
from repro.serve import control as jcontrol
from repro.traffic import extract_features as j_extract
from repro.traffic import synth as jsynth
from repro.traffic.models import train_traffic_model as j_train
from repro.traffic.pipeline import build_pipeline as j_build

import repro_torch.serve as tserve
from _torch_parity import MAX_STRADDLED
from repro_torch.convert import forest_from_numpy
from repro_torch.core.search_space import FeatureRep
from repro_torch.kernels.ref import straddled_flows
from repro_torch.serve import control as tcontrol
from repro_torch.traffic.extraction import extract_features
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_scenario_dataset

REP_A = (("dur", "s_load", "s_bytes_mean", "s_iat_mean", "ack_cnt"), 8)
REP_B = (("dur", "s_load", "s_pkt_cnt", "d_bytes_med", "psh_cnt"), 12)
SVC_A = dict(pkt_accum_ns=800.0, pkt_track_ns=200.0,
             bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5},
             gather_ns_per_flow=200.0, source="example")
SVC_B = dict(pkt_accum_ns=900.0, pkt_track_ns=200.0,
             bucket_ns={8: 4e4, 16: 5e4, 32: 7e4, 64: 1.2e5},
             gather_ns_per_flow=200.0, source="example")


def _side(serve, ds, pipes, xs):
    return types.SimpleNamespace(serve=serve, ds=ds, pipes=pipes, xs=xs,
                                 stream=serve.PacketStream.from_dataset(ds, seed=0))


@pytest.fixture(scope="module")
def sides():
    kw = dict(n_flows=120, max_pkts=256, seed=3)
    jds = jsynth.make_scenario_dataset("app-class", "zipf", **kw)
    ds = make_scenario_dataset("app-class", "zipf", **kw)
    jp, tp, jx, tx, forests = {}, {}, {}, {}, {}
    for tag, (names, depth) in (("a", REP_A), ("b", REP_B)):
        jx[tag] = np.asarray(j_extract(jds, names, depth))
        jf, _ = j_train(jx[tag], jds.label, model="tree-fast", seed=0)
        jp[tag] = j_build(JFeatureRep(names, depth), jf, depth, use_kernel=False)
        forests[tag] = forest_from_numpy(jf.feature, jf.threshold, jf.leaf,
                                         jf.depth, jf.n_features, jf.classes)
        tp[tag] = build_pipeline(FeatureRep(names, depth), forests[tag], depth,
                                 fused=True, device="cpu")
        tx[tag] = extract_features(ds, names, depth, device="cpu")
    return _side(jserve, jds, jp, jx), _side(tserve, ds, tp, tx), forests


def _acts(side) -> dict:
    """`examples/serve_control.py`'s three acts; every replay carries an
    `Observability` bundle, so its audit log can be compared (a bundle
    without tracer, drift or exporter changes nothing else)."""
    sv, stream = side.serve, side.stream
    svc_a, svc_b = sv.ServiceModel(**SVC_A), sv.ServiceModel(**SVC_B)
    ring = max(64, stream.n_events // 16)

    def session(cfg):
        return sv.ServeSession(control=cfg, obs=sv.Observability())

    def fleet(execute=False, shards=4, capacity=2048):
        return sv.ShardedRuntime(side.pipes["a"], n_shards=shards,
                                 capacity=capacity, max_batch=64,
                                 execute=execute)

    out = {}
    cfg = sv.ControlConfig(interval_pkts=512, imbalance_trigger=1.04)
    out["static"] = sv.find_zero_loss_rate(stream, fleet, svc_a, iters=8,
                                           ring_capacity=ring)
    s = session(cfg)
    out["dynamic"] = sv.find_zero_loss_rate(stream, fleet, svc_a, iters=8,
                                            ring_capacity=ring, session=s)
    out["dynamic_audit"] = s.resolve_audit()

    side.pipes["b"].warm([8, 16, 32, 64])
    swap_cfg = sv.ControlConfig(
        interval_pkts=512, imbalance_trigger=1.04,
        swap=sv.PipelineSwap(side.pipes["b"], svc_b,
                             after_pkts=stream.n_events // 2))
    s = session(swap_cfg)
    out["swap"] = sv.replay(stream, lambda: fleet(True), stream.base_pps,
                            svc_a, session=s)
    out["swap_audit"] = s.resolve_audit()

    elastic = sv.ControlConfig(interval_pkts=512,
                               headroom=sv.HeadroomPolicy(max_workers=8))
    for tag, rate in (("hot", 4e6), ("cold", 1e5)):
        s = session(elastic)
        out[tag] = sv.replay(stream, lambda: fleet(shards=2, capacity=4096),
                             rate, svc_a, session=s)
        out[tag + "_audit"] = s.resolve_audit()
    return out


@pytest.fixture(scope="module")
def acts(sides):
    ref, port, _ = sides
    return _acts(ref), _acts(port)


def _counters(m) -> dict:
    return {k: getattr(m, k) for k in m.counter_fields()}


def _stats_equal(got, want):
    assert (got.drops, got.drops_ring, got.drops_table) == (
        want.drops, want.drops_ring, want.drops_table)
    assert got.control == want.control
    assert got.load_imbalance == want.load_imbalance
    assert _counters(got.metrics) == _counters(want.metrics)
    assert got.latency_p50_s == want.latency_p50_s
    assert got.latency_p99_s == want.latency_p99_s
    assert got.stage_seconds == want.stage_seconds


def _straddled(sides):
    ref, port, forests = sides
    s = np.zeros(port.ds.n_flows, bool)
    for tag, f in forests.items():
        s |= straddled_flows(ref.xs[tag], port.xs[tag], f.feature,
                             f.threshold, f.depth)
    return s


def _assert_predictions(want, got, straddled):
    assert set(got) == set(want)
    assert straddled.sum() <= MAX_STRADDLED * len(straddled)
    differ = [k for k in want if not np.array_equal(want[k], got[k])]
    assert all(straddled[k] for k in differ), differ


def _audit(log) -> list:
    return [(e.seq, e.kind, e.now_pkts) for e in log.events]


@pytest.mark.parametrize("arm", ["static", "dynamic"])
def test_rebalancing_matches_reference(acts, arm):
    (r_w, want), (r_g, got) = acts[0][arm], acts[1][arm]
    assert r_g == r_w
    assert got.drops == want.drops == 0
    _stats_equal(got, want)
    if arm == "dynamic":
        assert _audit(acts[1]["dynamic_audit"]) == _audit(acts[0]["dynamic_audit"])
        # the control loop moved buckets and cut the imbalance, as the
        # example asserts
        assert got.control["buckets_moved"] > 0
        assert got.load_imbalance < acts[1]["static"][1].load_imbalance


def test_hot_swap_matches_reference_exactly_once(acts, sides):
    want, got = acts[0]["swap"], acts[1]["swap"]
    _stats_equal(got, want)
    assert got.drops == 0 and got.metrics.duplicate_predictions == 0
    assert len(got.predictions) == sides[1].ds.n_flows
    assert got.control["swaps"] == 1
    assert _audit(acts[1]["swap_audit"]) == _audit(acts[0]["swap_audit"])
    assert "hot_swap" in acts[1]["swap_audit"].summary()
    _assert_predictions(want.predictions, got.predictions, _straddled(sides))


@pytest.mark.parametrize("arm", ["hot", "cold"])
def test_elastic_sizing_matches_reference(acts, arm):
    want, got = acts[0][arm], acts[1][arm]
    _stats_equal(got, want)
    assert _audit(acts[1][arm + "_audit"]) == _audit(acts[0][arm + "_audit"])
    if arm == "hot":
        assert got.control["workers_added"] > 0 and got.drops == 0
    else:
        assert got.control["workers_retired"] > 0


def test_audit_documents_match_reference(acts):
    """Beyond kinds and order, each event's rationale and detail."""
    for key in ("dynamic_audit", "swap_audit", "hot_audit", "cold_audit"):
        want = [e.to_doc() for e in acts[0][key].events]
        got = [e.to_doc() for e in acts[1][key].events]
        assert got == want, key


# ---------------------------------------------------------------------------
# planners: pure functions of telemetry, on the same inputs
# ---------------------------------------------------------------------------

def _reta(rng, n_shards, size=128):
    return rng.integers(0, n_shards, size).astype(np.int64)


@pytest.mark.parametrize("seed,n_shards,max_moves,trigger", [
    (0, 4, 8, 1.05), (1, 8, 3, 1.04), (2, 2, 16, 1.10)])
def test_plan_rebalance_matches_reference(seed, n_shards, max_moves, trigger):
    rng = np.random.default_rng(seed)
    rates = rng.zipf(1.3, 128).astype(np.float64)
    reta = _reta(rng, n_shards)
    active = [True] * n_shards
    active[-1] = n_shards <= 2          # one worker retired where there are many
    kw = dict(max_moves=max_moves, trigger=trigger)
    want = jcontrol.plan_rebalance(rates, reta, active, **kw)
    got = tcontrol.plan_rebalance(rates, reta, active, **kw)
    assert got == want


@pytest.mark.parametrize("seed,n_shards", [(0, 4), (3, 6)])
def test_plan_retirement_matches_reference(seed, n_shards):
    rng = np.random.default_rng(seed)
    rates = rng.random(128)
    reta = _reta(rng, n_shards)
    active = [True] * n_shards
    for worker in (0, n_shards - 1):
        want = jcontrol.plan_retirement(rates, reta, worker, active)
        got = tcontrol.plan_retirement(rates, reta, worker, active)
        assert got == want and len(got) == int((reta == worker).sum())
    with pytest.raises(ValueError):
        tcontrol.plan_retirement(rates, reta, 0, [True] + [False] * (n_shards - 1))


def test_headroom_policy_matches_reference():
    jp, tp = jcontrol.HeadroomPolicy(), tcontrol.HeadroomPolicy()
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    for offered, per_worker, current in ((4e6, 1e6, 2), (1e5, 1e6, 4),
                                         (2.6e6, 1e6, 4), (1e9, 1e6, 2),
                                         (1e6, 0.0, 3)):
        assert (tp.desired_workers(offered, per_worker, current)
                == jp.desired_workers(offered, per_worker, current))


# ---------------------------------------------------------------------------
# the public serving namespace
# ---------------------------------------------------------------------------

def test_serve_exports_match_reference_and_resolve():
    assert set(tserve.__all__) >= set(jserve.__all__)
    for name in tserve.__all__:
        assert getattr(tserve, name) is not None, name
    assert set(tserve.__all__) <= set(dir(tserve))
    assert callable(tserve.deploy)      # the function, not its submodule
    with pytest.raises(AttributeError):
        tserve.no_such_export
    assert set(tcontrol.__all__) == set(jcontrol.__all__)
