"""Adaptive serving control plane, end to end, on the port.

The port of `examples/serve_control.py`, its pipelines the fused kernel
(B2) on the card. Three acts on one Zipf elephant-flow trace (a handful of
flows carry most of the offered packets, so a handful of RETA buckets
overload whatever shard round-robin steering gave them):

1. **Dynamic RETA rebalancing**: the 4-shard zero-loss throughput twice,
   static indirection table against the closed control loop (per-bucket
   EWMA telemetry -> greedy bucket-migration planner -> quiescent
   flow-state migration): the imbalance drop and the rates.
2. **Zero-downtime pipeline hot-swap**: mid-replay, the fleet swaps onto a
   second (F, n) pipeline, warmed beforehand, with zero drops and every
   flow predicted exactly once; flows that start after the swap are
   predicted as a fleet of the new pipeline alone predicts them.
3. **Elastic scale-out/in**: the same trace at a high and a low offered
   rate under a target-headroom policy; the fleet grows and shrinks by
   RETA rewrite and migration.

Everything runs under the deterministic replay clock with the reference
example's fixed service constants, so the numbers do not depend on the
machine. `chip_smoke.py`'s `control` phase runs the same acts at the
benchmark's size under constants measured on the card.

    PYTHONPATH=src python examples_torch/serve_control.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.search_space import FeatureRep
from repro_torch.device import resolve_device
from repro_torch.serve import (
    ControlConfig,
    HeadroomPolicy,
    PacketStream,
    PipelineSwap,
    ServeSession,
    ServiceModel,
    ShardedRuntime,
    StreamingRuntime,
    find_zero_loss_rate,
    replay,
)
from repro_torch.traffic.extraction import extract_features
from repro_torch.traffic.models import train_traffic_model
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_scenario_dataset

N_SHARDS = 4
REP_A = (("dur", "s_load", "s_bytes_mean", "s_iat_mean", "ack_cnt"), 8)
REP_B = (("dur", "s_load", "s_pkt_cnt", "d_bytes_med", "psh_cnt"), 12)
# the reference example's deterministic service constants (realistic
# magnitudes), so the example reproduces anywhere
SVC_A = dict(pkt_accum_ns=800.0, pkt_track_ns=200.0,
             bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5},
             gather_ns_per_flow=200.0, source="example")
SVC_B = dict(pkt_accum_ns=900.0, pkt_track_ns=200.0,
             bucket_ns={8: 4e4, 16: 5e4, 32: 7e4, 64: 1.2e5},
             gather_ns_per_flow=200.0, source="example")
CONTROL = dict(interval_pkts=512, imbalance_trigger=1.04)


def deployment(device, n_flows=120, max_pkts=256, seed=3):
    """The zipf app-class trace and its two configurations, each with a
    `tree-fast` forest trained on the CPU. Returns (dataset, stream, reps,
    forests, pipe_a): reps and forests keyed "a" and "b", pipe_a the
    fused pipeline of "a" on `device`."""
    ds = make_scenario_dataset("app-class", "zipf", n_flows=n_flows,
                               max_pkts=max_pkts, seed=seed)
    reps, forests = {}, {}
    for tag, (names, depth) in (("a", REP_A), ("b", REP_B)):
        reps[tag] = FeatureRep(names, depth)
        x = extract_features(ds, reps[tag].features, depth, device="cpu")
        forests[tag] = train_traffic_model(x, ds.label, model="tree-fast",
                                           seed=0)[0]
    pipe_a = build_pipeline(reps["a"], forests["a"], max_pkts=reps["a"].depth,
                            fused=True, device=device)
    return ds, PacketStream.from_dataset(ds, seed=0), reps, forests, pipe_a


def fleet_of(pipe, shards=N_SHARDS, capacity=2048):
    """A fleet factory over `pipe`: ``make(execute=False)``."""
    def make(execute=False):
        return ShardedRuntime(pipe, n_shards=shards, capacity=capacity,
                              max_batch=64, execute=execute)
    return make


def rebalance(stream, make, service, iters=8, ring=4096, obs=None):
    """Act 1: the zero-loss rate of the static fleet and of one under the
    control loop (`obs`, an `Observability` bundle, rides the dynamic
    search). Returns (static rate, stats, dynamic rate, stats)."""
    r_st, s_st = find_zero_loss_rate(stream, make, service, iters=iters,
                                     ring_capacity=ring)
    r_dy, s_dy = find_zero_loss_rate(
        stream, make, service, iters=iters, ring_capacity=ring,
        session=ServeSession(control=ControlConfig(**CONTROL), obs=obs))
    return r_st, s_st, r_dy, s_dy


def hot_swap(ds, stream, make, swap, service, rate, only_new, ring=4096):
    """Act 2: replay at `rate` with `swap` (a `PipelineSwap`) armed at its
    packet, then the new pipeline alone (`only_new()`, a runtime factory,
    under the swap's service constants). Returns (swapped stats, the flows
    first seen after the swap that the new pipeline alone predicted, how
    many of them the swapped fleet predicted the same). The swap executes
    at the first control step at or after its packet (``swap_at_pkts``);
    a flow first seen before that started on the old pipeline."""
    swapped = replay(stream, lambda: make(True), rate, service,
                     ring_capacity=ring, session=ServeSession(
                         control=ControlConfig(**CONTROL, swap=swap)))
    alone = replay(stream, only_new, rate, swap.service, ring_capacity=ring)
    first_pkt = np.full(ds.n_flows, stream.n_events)
    np.minimum.at(first_pkt, stream.fid, np.arange(stream.n_events))
    at = swapped.control.get("swap_at_pkts", swap.after_pkts)
    post = [f for f in np.flatnonzero(first_pkt >= at)
            if f in alone.predictions]
    agree = sum(int(swapped.predictions[f] == alone.predictions[f])
                for f in post)
    return swapped, post, agree


def elastic(stream, make_small, service, rates):
    """Act 3: replays at each of `rates` ({name: packets/s}) of a small
    fleet under a target-headroom policy. Returns {name: stats}."""
    cfg = ControlConfig(interval_pkts=512,
                        headroom=HeadroomPolicy(max_workers=8))
    return {k: replay(stream, make_small, r, service,
                      session=ServeSession(control=cfg))
            for k, r in rates.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain version")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"== adaptive serving control plane: zipf elephant-flow trace "
          f"({device}) ==")
    ds, stream, reps, forests, pipe_a = deployment(device)
    top = np.sort(np.bincount(stream.fid))[::-1]
    print(f"trace: {stream.n_flows} flows, {stream.n_events} packets; "
          f"top-5 flows carry {top[:5].sum() / stream.n_events:.0%} "
          "of all packets")
    svc_a, svc_b = ServiceModel(**SVC_A), ServiceModel(**SVC_B)
    make = fleet_of(pipe_a)

    # -- act 1: static RETA vs dynamic rebalancing ---------------------------
    r_st, s_st, r_dy, s_dy = rebalance(stream, make, svc_a,
                                       ring=max(64, stream.n_events // 16))
    print(f"\nstatic RETA : zero-loss {r_st:12,.0f} pps  "
          f"load imbalance {s_st.load_imbalance:.2f}")
    print(f"dynamic RETA: zero-loss {r_dy:12,.0f} pps  "
          f"load imbalance {s_dy.load_imbalance:.2f}  "
          f"({s_dy.control['buckets_moved']} bucket moves, "
          f"{s_dy.control['flows_migrated']} flows migrated)")
    print(f"  -> {r_dy / r_st:.2f}x the static fleet's throughput, "
          f"zero drops both ways")
    assert s_st.drops == 0 and s_dy.drops == 0
    assert r_dy > r_st

    # -- act 2: zero-downtime pipeline hot-swap ------------------------------
    pipe_b = build_pipeline(reps["b"], forests["b"], max_pkts=reps["b"].depth,
                            fused=True, device=device)
    pipe_b.warm([8, 16, 32, 64])      # compiled beforehand: the swap pays none
    swap = PipelineSwap(pipe_b, svc_b, after_pkts=stream.n_events // 2)
    swapped, post, agree = hot_swap(
        ds, stream, make, swap, svc_a, stream.base_pps,
        lambda: StreamingRuntime(pipe_b, capacity=2048, max_batch=64))
    m = swapped.metrics
    print(f"\nhot-swap at mid-trace: drops {swapped.drops}, "
          f"{len(swapped.predictions)}/{ds.n_flows} flows predicted "
          f"exactly once (duplicates {m.duplicate_predictions}), "
          f"swap flushes {m.flushes_swap}")
    print(f"  {agree}/{len(post)} post-swap flows equal to a "
          "new-pipeline-only run")
    assert swapped.drops == 0
    assert len(swapped.predictions) == ds.n_flows
    assert m.duplicate_predictions == 0
    assert agree == len(post) > 0

    # -- act 3: elastic scale-out/in -----------------------------------------
    runs = elastic(stream, lambda: fleet_of(pipe_a, shards=2, capacity=4096)(),
                   svc_a, {"hot": 4e6, "cold": 1e5})
    hot, cold = runs["hot"], runs["cold"]
    print(f"\nelastic: at 4.0M pps the 2-worker fleet grew to "
          f"{hot.control['active_workers']} active workers "
          f"(+{hot.control['workers_added']}), zero drops: "
          f"{hot.drops == 0}")
    print(f"elastic: at 0.1M pps it shrank to "
          f"{cold.control['active_workers']} active worker(s) "
          f"(retired {cold.control['workers_retired']})")
    assert hot.control["workers_added"] > 0
    assert cold.control["workers_retired"] > 0
    print("\nOK")
    return dict(static_pps=r_st, dynamic_pps=r_dy,
                imbalance=(s_st.load_imbalance, s_dy.load_imbalance),
                swap_drops=swapped.drops, post_swap=(agree, len(post)),
                workers_added=hot.control["workers_added"],
                workers_retired=cold.control["workers_retired"])


if __name__ == "__main__":
    main()
