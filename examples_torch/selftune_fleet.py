"""The loop closing itself: a self-optimizing serving fleet, on the port.

The port of `examples/selftune_fleet.py`, its pipelines the fused kernel
(B2) on the card. One drifting trace, two fleets, both deployed on a
*stale* knee, a pipeline optimized for the pre-drift traffic window:

1. **Frozen knee**: control plane, no reoptimizer. As the class mix slides
   away from the training window, the stale model keeps predicting the
   classes it knows and its post-drift accuracy collapses.
2. **Self-optimizing**: the same fleet with a `ReoptimizerPolicy`
   subscribed to the `DriftMonitor`: when the fast/slow class-mix gap
   crosses the trigger threshold and dwells, the policy runs a budgeted
   CATO re-tune on a *shadow* profiler on the fleet's device
   (`cato_retuner`: a fresh profiler and optimizer, never a cycle on the
   live fleet), compiles the new front there and hot-swaps its knee into
   the running replay: zero drops, every flow predicted exactly once, the
   episode one audited `reopt` event.

Everything runs on the deterministic replay clock, so the episode fires at
the same packet on every machine. `chip_smoke.py`'s `selftune` phase runs
these steps on the card.

    PYTHONPATH=src python examples_torch/selftune_fleet.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.search_space import FeatureRep, SearchSpace
from repro_torch.device import resolve_device
from repro_torch.serve import (
    BundlePoint,
    ControlConfig,
    DriftMonitor,
    Observability,
    PacketStream,
    ReoptimizerConfig,
    ReoptimizerPolicy,
    ServeSession,
    ServiceModel,
    ShardedRuntime,
    cato_retuner,
    replay,
)
from repro_torch.serve.deploy import _forest_to_doc
from repro_torch.traffic import TrafficProfiler
from repro_torch.traffic.extraction import extract_features
from repro_torch.traffic.features import FEATURE_NAMES
from repro_torch.traffic.models import train_traffic_model
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_scenario_dataset

REP_FEATURES = ("dur", "s_load", "s_bytes_mean", "s_iat_mean", "ack_cnt")
N_SHARDS = 2
OFFERED_PPS = 2e5
SERVICE = dict(pkt_accum_ns=800.0, pkt_track_ns=200.0,
               bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5},
               gather_ns_per_flow=200.0, source="example")


def macro_f1(y_true, y_pred):
    """Macro-F1 over the classes either side names."""
    f1s = []
    for c in np.union1d(np.unique(y_true), np.unique(y_pred)):
        tp = float(np.sum((y_pred == c) & (y_true == c)))
        fp = float(np.sum((y_pred == c) & (y_true != c)))
        fn = float(np.sum((y_pred != c) & (y_true == c)))
        if tp + fp + fn:
            f1s.append(2 * tp / max(2 * tp + fp + fn, 1e-9))
    return float(np.mean(f1s)) if f1s else 0.0


def deployment(device, n_flows=600, max_pkts=32, seed=3):
    """The drift trace and the stale knee: a `tree-fast` forest trained on
    the flows that start in the first 40% of the replay, compiled fused on
    `device`. Returns (dataset, stream, first packet of each flow, the
    training flows, the stale `BundlePoint`)."""
    ds = make_scenario_dataset("app-class", "drift", n_flows=n_flows,
                               max_pkts=max_pkts, seed=seed)
    stream = PacketStream.from_dataset(ds, seed=0)
    first_pkt = np.full(ds.n_flows, stream.n_events)
    np.minimum.at(first_pkt, stream.fid, np.arange(stream.n_events))
    rep = FeatureRep(REP_FEATURES, depth=8)
    pre = np.flatnonzero(first_pkt < 0.4 * stream.n_events)
    x = extract_features(ds, rep.features, rep.depth, device="cpu")
    forest, _ = train_traffic_model(x[pre], ds.label[pre], model="tree-fast",
                                    seed=0)
    pipe = build_pipeline(rep, forest, max_pkts=rep.depth, fused=True,
                          device=device)
    stale = BundlePoint(rep=rep, cost=1.0, perf=0.0, fidelity="measured",
                        aux={}, compile_meta={"fused": True},
                        forest_doc=_forest_to_doc(forest), pipeline=pipe)
    return ds, stream, first_pkt, pre, stale


def fleet_of(pipe):
    """Small micro-batches, so that predictions resolve (and feed the drift
    monitor) mid-run, not at drain."""
    def make():
        return ShardedRuntime(pipe, n_shards=N_SHARDS, capacity=2048,
                              max_batch=16, execute=True)
    return make


def _control():
    return ControlConfig(interval_pkts=256, rebalance=False)


def frozen_arm(stream, stale, service, pps=OFFERED_PPS):
    """Arm 1: the stale knee under the control plane alone."""
    return replay(stream, fleet_of(stale.pipeline), pps, service,
                  session=ServeSession(control=_control()))


def tuned_arm(ds, stream, stale, service, pps=OFFERED_PPS, on_trigger=None):
    """Arm 2: the same fleet with a reoptimizer whose re-tune is a budgeted
    CATO optimization on a shadow profiler over the up-to-date corpus, on
    the device the trigger names. `on_trigger(trigger)` sees each episode's
    trigger. Returns (stats, session)."""
    def make_profiler(trigger):
        if on_trigger is not None:
            on_trigger(trigger)
        return TrafficProfiler(ds, FEATURE_NAMES, model="tree-fast",
                               cost_mode="modeled", scenario="drift",
                               n_shards=N_SHARDS, bisect_iters=4, seed=0,
                               device=trigger["device"])

    space = SearchSpace(FEATURE_NAMES, max_depth=min(24, ds.max_pkts))
    retune = cato_retuner(make_profiler, space, fidelities=("modeled",),
                          measure_budget=4, batch_size=4, n_init=3, seed=0,
                          baseline=stale)
    session = ServeSession(
        obs=Observability(drift=DriftMonitor()), control=_control(),
        reopt=ReoptimizerPolicy(retune, ReoptimizerConfig(
            class_threshold=0.35, min_dwell_pkts=256, cooldown_pkts=1 << 20,
            max_episodes=1)))
    return replay(stream, fleet_of(stale.pipeline), pps, service,
                  session=session), session


def post_drift_f1(ds, stream, first_pkt, *arms):
    """Macro-F1 of each arm over the flows first seen in the last third of
    the trace. Returns (those flows, [F1 per arm])."""
    post = np.flatnonzero(first_pkt >= (2 / 3) * stream.n_events)
    return post, [macro_f1(ds.label[post],
                           np.array([st.predictions[f] for f in post]))
                  for st in arms]


def check(ds, frozen, tuned, episodes, f1_frozen, f1_tuned):
    """The reference example's own checks."""
    assert len(episodes) == 1 and tuned.control["reopt"]["episodes"] == 1
    assert tuned.drops == 0 and frozen.drops == 0
    assert len(tuned.predictions) == ds.n_flows
    assert tuned.metrics.duplicate_predictions == 0
    assert f1_tuned > f1_frozen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain version")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"== self-optimizing fleet: drift-triggered re-tune + hot-swap "
          f"({device}) ==")
    ds, stream, first_pkt, pre, stale = deployment(device)
    print(f"trace: {stream.n_flows} flows, {stream.n_events} packets; "
          "class mix slides across the replay (drift scenario)")
    print(f"deployed knee: depth={stale.rep.depth} "
          f"|F|={len(stale.rep.features)}, trained on the first "
          f"{len(pre)} flows (saw {np.unique(ds.label[pre]).size}/"
          f"{len(ds.class_names)} classes)")
    service = ServiceModel(**SERVICE)
    frozen = frozen_arm(stream, stale, service)
    devices = []

    def report(trigger):
        devices.append(str(trigger["device"]))
        print(f"  [reopt] episode trigger at replay "
              f"t={trigger['now_pkts']:.4f}s after "
              f"{trigger['pkts_ingested']} pkts: class_mix_shift="
              f"{trigger['verdict']['class_mix_shift']:.3f}")

    tuned, session = tuned_arm(ds, stream, stale, service, on_trigger=report)
    episodes = session.resolve_audit().of_kind("reopt")
    if episodes:
        ep = episodes[0]
        print(f"\naudited episode (seq {ep.seq}, replay t={ep.now_pkts:.4f}s):")
        print(f"  rationale: {ep.rationale}")
        print(f"  old knee (cost, perf): {ep.detail['old_knee']}")
        print(f"  new knee (cost, perf): {ep.detail['new_knee']}")
        print(f"  budget:    {ep.detail['budget']}  "
              f"retune wall {ep.detail['retune_wall_s']:.2f}s")
    print(f"swap executed at pkt {tuned.control.get('swap_at_pkts')}, "
          f"drops={tuned.drops}, "
          f"{len(tuned.predictions)}/{ds.n_flows} flows predicted")
    post, (f1_frozen, f1_tuned) = post_drift_f1(ds, stream, first_pkt, frozen,
                                                tuned)
    print(f"\npost-drift macro-F1 over {len(post)} tail flows:")
    print(f"  frozen knee     : {f1_frozen:.3f}")
    print(f"  self-optimizing : {f1_tuned:.3f}")
    check(ds, frozen, tuned, episodes, f1_frozen, f1_tuned)
    print("\nOK: the fleet noticed the drift, re-tuned itself, and "
          "hot-swapped the fix mid-replay")
    ep = episodes[0]
    return dict(
        flows=ds.n_flows, max_pkts=ds.max_pkts, events=stream.n_events,
        offered_pps=OFFERED_PPS, shards=N_SHARDS, episodes=len(episodes),
        episode_at_pkts=ep.detail.get("pkts_ingested"),
        episode_now_pkts=ep.now_pkts,
        swap_at_pkts=tuned.control.get("swap_at_pkts"),
        new_knee=ep.detail.get("new_knee"), budget=ep.detail.get("budget"),
        retune_wall_s=ep.detail.get("retune_wall_s"), retune_devices=devices,
        drops={"frozen": frozen.drops, "tuned": tuned.drops},
        flows_predicted={"frozen": len(frozen.predictions),
                         "tuned": len(tuned.predictions)},
        duplicate_predictions=tuned.metrics.duplicate_predictions,
        post_drift_flows=len(post),
        macro_f1={"frozen": f1_frozen, "tuned": f1_tuned})


if __name__ == "__main__":
    main()
