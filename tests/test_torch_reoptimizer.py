"""The port's drift -> re-tune -> hot-swap loop
(`repro_torch.serve.control.reoptimizer`) against the reference's:
`examples/selftune_fleet.py` at its own size (drift app-class, 600 flows
of up to 32 packets, 2 shards, the example's fixed clock constants), run
by both packages. The port's fleet, shadow profiler and re-compiled front
run on the CPU (B2's plain version); the reference's use its
`use_kernel=False` pipelines.

The episode is a function of the replay packet clock, the drift monitor
and the optimizer's draws, all of which the port computes as the
reference does: it must fire once, at the same packet, pick the same new
knee, and leave the same predictions (the straddle rule), the same drops
and the same control summary but wall seconds.
"""
import numpy as np
import pytest

import repro.serve as jserve
from repro.core import FeatureRep as JFeatureRep
from repro.core import SearchSpace as JSearchSpace
from repro.serve.deploy import BundlePoint as JBundlePoint
from repro.traffic import FEATURE_NAMES as J_NAMES
from repro.traffic import TrafficProfiler as JProfiler
from repro.traffic import extract_features as j_extract
from repro.traffic.models import train_traffic_model as j_train
from repro.traffic.pipeline import build_pipeline as j_build
from repro.traffic.synth import make_scenario_dataset as j_scenario

import repro_torch.serve as tserve
from _torch_parity import MAX_STRADDLED
from repro_torch.convert import forest_from_numpy
from repro_torch.core import FeatureRep, SearchSpace
from repro_torch.kernels.ref import straddled_flows
from repro_torch.serve.deploy import BundlePoint
from repro_torch.traffic import FEATURE_NAMES, TrafficProfiler
from repro_torch.traffic.extraction import extract_features
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_scenario_dataset

STALE = JFeatureRep(("dur", "s_load", "s_bytes_mean", "s_iat_mean", "ack_cnt"),
                    depth=8)
SERVICE = dict(pkt_accum_ns=800.0, pkt_track_ns=200.0,
               bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5},
               gather_ns_per_flow=200.0, source="example")


def _macro_f1(y_true, y_pred):
    f1s = []
    for c in np.union1d(np.unique(y_true), np.unique(y_pred)):
        tp = float(np.sum((y_pred == c) & (y_true == c)))
        fp = float(np.sum((y_pred == c) & (y_true != c)))
        fn = float(np.sum((y_pred != c) & (y_true == c)))
        if tp + fp + fn:
            f1s.append(2 * tp / max(2 * tp + fp + fn, 1e-9))
    return float(np.mean(f1s)) if f1s else 0.0


def _selftune(port: bool) -> dict:
    """`examples/selftune_fleet.py` on one package; returns both arms, the
    audited episode, the new knee and the stale knee's forest."""
    kw = dict(n_flows=600, max_pkts=32, seed=3)
    jds = j_scenario("app-class", "drift", **kw)
    sv = tserve if port else jserve
    ds = make_scenario_dataset("app-class", "drift", **kw) if port else jds
    stream = sv.PacketStream.from_dataset(ds, seed=0)
    first_pkt = np.full(ds.n_flows, stream.n_events)
    np.minimum.at(first_pkt, stream.fid, np.arange(stream.n_events))
    pre = np.nonzero(first_pkt < 0.4 * stream.n_events)[0]
    # the stale knee: the reference's forest on both sides (a FeatureRep
    # sorts its features: the columns follow that order)
    X = np.asarray(j_extract(jds, STALE.features, STALE.depth))
    jf, _ = j_train(X[pre], jds.label[pre], model="tree-fast", seed=0)
    if port:
        rep = FeatureRep(STALE.features, depth=STALE.depth)
        forest = forest_from_numpy(jf.feature, jf.threshold, jf.leaf, jf.depth,
                                   jf.n_features, jf.classes)
        pipe = build_pipeline(rep, forest, max_pkts=8, fused=True,
                              device="cpu")
        stale = BundlePoint(rep=rep, cost=1.0, perf=0.0, fidelity="measured",
                            aux={}, compile_meta={"fused": True},
                            forest_doc=None, pipeline=pipe)
        space = SearchSpace(FEATURE_NAMES, max_depth=24)
    else:
        rep = STALE
        pipe = j_build(rep, jf, max_pkts=8, use_kernel=False)
        stale = JBundlePoint(rep=rep, cost=1.0, perf=0.0, fidelity="measured",
                             aux={}, compile_meta={"fused": False},
                             forest_doc=None, pipeline=pipe)
        space = JSearchSpace(J_NAMES, max_depth=24)
    service = sv.ServiceModel(**SERVICE)

    def fleet():
        return sv.ShardedRuntime(pipe, n_shards=2, capacity=2048,
                                 max_batch=16, execute=True)

    def control():
        return sv.ControlConfig(interval_pkts=256, rebalance=False)

    frozen = sv.replay(stream, fleet, 2e5, service,
                       session=sv.ServeSession(control=control()))

    triggers = []

    def make_profiler(trigger):
        triggers.append(trigger)
        if port:
            return TrafficProfiler(ds, FEATURE_NAMES, model="tree-fast",
                                   cost_mode="modeled", scenario="drift",
                                   n_shards=2, bisect_iters=4, seed=0,
                                   device=trigger["device"])
        return JProfiler(ds, J_NAMES, model="tree-fast", cost_mode="modeled",
                         scenario="drift", n_shards=2, bisect_iters=4, seed=0)

    outcomes = []
    retune = sv.cato_retuner(make_profiler, space, fidelities=("modeled",),
                             measure_budget=4, batch_size=4, n_init=3, seed=0,
                             baseline=stale,
                             # the reference's XLA path; the port's follows
                             # the device
                             **({} if port else {"use_kernel": False}))

    def recorded(trigger):
        outcomes.append(retune(trigger))
        return outcomes[-1]

    policy = sv.ReoptimizerPolicy(recorded, sv.ReoptimizerConfig(
        class_threshold=0.35, min_dwell_pkts=256, cooldown_pkts=1 << 20,
        max_episodes=1))
    session = sv.ServeSession(obs=sv.Observability(drift=sv.DriftMonitor()),
                              control=control(), reopt=policy)
    tuned = sv.replay(stream, fleet, 2e5, service, session=session)
    post = np.nonzero(first_pkt >= (2 / 3) * stream.n_events)[0]
    return dict(
        ds=ds, frozen=frozen, tuned=tuned, triggers=triggers,
        episodes=session.resolve_audit().of_kind("reopt"),
        knee=outcomes[0].point if outcomes else None, forest=jf,
        f1_frozen=_macro_f1(ds.label[post],
                            np.array([frozen.predictions[f] for f in post])),
        f1_tuned=_macro_f1(ds.label[post],
                           np.array([tuned.predictions[f] for f in post])))


@pytest.fixture(scope="module")
def runs():
    return _selftune(port=False), _selftune(port=True)


def _without_walls(x):
    if isinstance(x, dict):
        return {k: _without_walls(v) for k, v in x.items()
                if not k.endswith("wall_s")}
    return x


def test_one_episode_at_the_reference_packet(runs):
    want, got = runs
    assert len(got["episodes"]) == len(want["episodes"]) == 1
    assert got["triggers"][0]["device"] == "cpu"
    e_w, e_g = want["episodes"][0], got["episodes"][0]
    assert (e_g.seq, e_g.now_pkts) == (e_w.seq, e_w.now_pkts)
    assert e_g.rationale == e_w.rationale
    assert _without_walls(e_g.detail) == _without_walls(e_w.detail)
    assert e_g.detail["pkts_ingested"] == e_w.detail["pkts_ingested"]
    assert got["tuned"].control["swap_at_pkts"] == \
        want["tuned"].control["swap_at_pkts"]


def test_same_new_knee(runs):
    want, got = runs
    k_w, k_g = want["knee"], got["knee"]
    assert (k_g.rep.features, k_g.rep.depth) == (k_w.rep.features,
                                                   k_w.rep.depth)
    assert (k_g.cost, k_g.perf, k_g.fidelity) == (k_w.cost, k_w.perf,
                                                  k_w.fidelity)
    assert k_g.forest_doc == k_w.forest_doc
    assert k_g.pipeline.device.type == "cpu"


@pytest.mark.parametrize("arm", ["frozen", "tuned"])
def test_same_predictions_drops_and_control(runs, arm):
    want, got = runs
    w, g = want[arm], got[arm]
    assert g.drops == w.drops == 0
    assert len(g.predictions) == got["ds"].n_flows
    assert g.metrics.duplicate_predictions == 0
    assert _without_walls(g.control) == _without_walls(w.control)
    # flows that differ must be straddled by the stale or the new knee
    ds_j, ds_t = want["ds"], got["ds"]
    s = np.zeros(ds_t.n_flows, bool)
    jf = want["forest"]
    pairs = [((STALE.features, STALE.depth), (jf.feature, jf.threshold,
                                              jf.depth))]
    k = got["knee"]
    f = k.forest()
    pairs.append(((k.rep.features, k.rep.depth), (f.feature, f.threshold,
                                                  f.depth)))
    for (names, depth), (feat, thr, d) in pairs:
        s |= straddled_flows(np.asarray(j_extract(ds_j, names, depth)),
                             extract_features(ds_t, names, depth, device="cpu"),
                             feat, thr, d)
    assert s.sum() <= MAX_STRADDLED * len(s)
    differ = [fid for fid in w.predictions
              if w.predictions[fid] != g.predictions[fid]]
    assert all(s[fid] for fid in differ), differ


def test_retuned_f1_beats_the_frozen_knee(runs):
    want, got = runs
    assert got["f1_tuned"] > got["f1_frozen"]
    assert (got["f1_tuned"], got["f1_frozen"]) == (want["f1_tuned"],
                                                   want["f1_frozen"])
