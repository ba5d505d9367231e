"""The closed loop on the port: measure -> optimize -> compile -> deploy.

The port of `examples/tune_serving.py`, its pipelines on the card:

1. **Measure/optimize**: batched multi-fidelity Bayesian optimization over
   (features x depth). Candidate batches are scored by greedy q-EHVI at
   the cheap `modeled` fidelity, and only points on the cheap Pareto front
   are promoted to the expensive `replayed_sharded` fidelity: a zero-loss
   bisection through the RSS-steered sharded runtime under a zipf
   elephant-flow scenario, each replay's pipeline the fused kernel (B2).
2. **Compile**: the measured Pareto set becomes a `ParetoBundle` (per
   point the exact seeded forest the measurement used and a pipeline
   warmed for the fleet's dispatch buckets), written to
   `results/pareto_bundle_torch.json` and read back.
3. **Deploy**: the bundle's knee is hot-swapped into a live sharded replay
   mid-stream: zero drops, every flow predicted exactly once, post-swap
   flows equal to a knee-only fleet's.

Everything runs under the deterministic replay clock (modeled
constants), so the numbers do not depend on the machine.

    PYTHONPATH=src python examples_torch/tune_serving.py [--scenario zipf]
"""
import argparse
import pathlib

import numpy as np

from repro_torch.core import CatoOptimizer, MemoizedEvaluator, SearchSpace
from repro_torch.core.priors import build_priors
from repro_torch.device import resolve_device
from repro_torch.serve import (
    ControlConfig,
    PacketStream,
    ParetoBundle,
    ServeSession,
    ServiceModel,
    ShardedRuntime,
    compile_front,
    make_swap,
    replay,
    warm_buckets_for,
)
from repro_torch.traffic import FEATURE_NAMES, TrafficProfiler, backend_suite
from repro_torch.traffic.synth import make_scenario_dataset

N_SHARDS = 4
RESULTS = pathlib.Path(__file__).resolve().parent.parent / "results"
BUNDLE = RESULTS / "pareto_bundle_torch.json"


def optimize(device, scenario="zipf", n_flows=240, max_pkts=96, budget=5,
             batch_size=4, bisect_iters=6, seed=0):
    """1. Batched multi-fidelity BO. Returns (dataset, profiler, result)."""
    ds = make_scenario_dataset("app-class", scenario, n_flows=n_flows,
                               max_pkts=max_pkts, seed=seed)
    prof = TrafficProfiler(ds, FEATURE_NAMES, model="tree-fast",
                           cost_mode="modeled", scenario=scenario,
                           n_shards=N_SHARDS, bisect_iters=bisect_iters,
                           seed=seed, device=device)
    space = SearchSpace(FEATURE_NAMES, max_depth=min(50, ds.max_pkts))
    X = prof.matrices_at_depth(space.max_depth)[0]
    priors = build_priors(space, X, prof.train_ds.label)
    ev = MemoizedEvaluator(backend_suite(prof, ("modeled", "replayed_sharded")))
    opt = CatoOptimizer(space, ev, priors, seed=seed, batch_size=batch_size)
    print(f"== optimize: batched multi-fidelity BO under {scenario} "
          f"({N_SHARDS}-shard measured fidelity, {device}) ==")
    res = opt.run_multi_fidelity(measure_budget=budget, verbose=True)
    print(f"\nfidelity spend: {res.fidelity_counts} "
          f"(surrogate fallbacks: {len(res.surrogate_fallbacks)})")
    front = res.pareto_observations()
    print(f"measured Pareto set ({len(front)} points):")
    for o in front:
        print(f"  depth={o.x.depth:3d} |F|={len(o.x.features):2d} "
              f"f1={o.perf:.3f} zero-loss={-o.cost:.3f} Gbps")
    return ds, prof, res


def compile_bundle(res, prof, path, device):
    """2. The measured front as a warmed bundle, saved and read back.
    Returns (bundle, reloaded)."""
    bundle = compile_front(res, prof, fused=True, device=device)
    path = bundle.save(path)
    reloaded = ParetoBundle.load(path)
    assert reloaded.to_doc() == bundle.to_doc(), "bundle round-trip drifted"
    knee = reloaded.knee()
    print(f"\n== compile: {len(bundle.points)} front points warmed "
          f"({sum(p.compile_meta['compile_s'] for p in bundle.points):.2f}s "
          f"compile) -> {path} ==")
    print(f"knee point: depth={knee.rep.depth} |F|={len(knee.rep.features)} "
          f"f1={knee.perf:.3f} zero-loss={-knee.cost:.3f} Gbps")
    return bundle, reloaded


def deploy(ds, reloaded, device, scenario="zipf", seed=0):
    """3. The fleet starts on the bundle's cheapest point and swaps to the
    knee mid-trace; asserts zero drops, exactly-once predictions and that
    post-swap flows equal a knee-only fleet's. Returns (swap replay's
    stats, post-swap flows, how many agree)."""
    start, knee = reloaded.best_by_cost(), reloaded.knee()
    start_pipe = start.build(warm=False, device=device)
    stream = PacketStream.from_dataset(ds, seed=seed, scenario=scenario)
    svc_start = ServiceModel.modeled(start.rep, start.forest())

    def fleet():
        return ShardedRuntime(start_pipe, n_shards=N_SHARDS, capacity=2048,
                              max_batch=64, execute=True)

    # warm both pipelines for the fleet's dispatch geometry (a throwaway
    # instance donates min_bucket/max_batch)
    template = fleet()
    start_pipe.warm(warm_buckets_for(template))
    swap = make_swap(knee, after_pkts=stream.n_events // 2, runtime=template,
                     device=device)
    cfg = ControlConfig(interval_pkts=256, rebalance=False, swap=swap)
    stats = replay(stream, fleet, stream.base_pps, svc_start,
                   session=ServeSession(control=cfg))
    m = stats.metrics
    print(f"\n== deploy: knee hot-swapped into a live {N_SHARDS}-shard "
          f"replay at mid-trace ==")
    print(f"drops={stats.drops}  predicted {len(stats.predictions)}/"
          f"{ds.n_flows} flows  duplicates={m.duplicate_predictions}  "
          f"swaps={stats.control['swaps']}")
    assert stats.drops == 0, "deployment dropped packets"
    assert len(stats.predictions) == ds.n_flows, "a flow went unpredicted"
    assert m.duplicate_predictions == 0, "a flow was predicted twice"
    assert stats.control["swaps"] == 1, "the scheduled swap never fired"

    # flows that started after the swap's actual fire point must equal a
    # knee-only fleet's (flows straddling the swap are exempt)
    knee_pipe = knee.build(device=device)
    svc_knee = ServiceModel.modeled(knee.rep, knee.forest())

    def knee_fleet():
        return ShardedRuntime(knee_pipe, n_shards=N_SHARDS, capacity=2048,
                              max_batch=64, execute=True)

    only_knee = replay(stream, knee_fleet, stream.base_pps, svc_knee)
    first_pkt = np.full(ds.n_flows, stream.n_events)
    np.minimum.at(first_pkt, stream.fid, np.arange(stream.n_events))
    post = np.nonzero(first_pkt >= stats.control["swap_at_pkts"])[0]
    agree = sum(stats.predictions[f] == only_knee.predictions[f] for f in post)
    print(f"{agree}/{len(post)} post-swap flows identical to a knee-only fleet")
    assert agree == len(post)
    return stats, post, agree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="zipf",
                    choices=("uniform", "zipf", "burst", "drift"))
    ap.add_argument("--budget", type=int, default=5,
                    help="measured-fidelity evaluations (zero-loss bisections)")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain version")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ds, prof, res = optimize(device, scenario=args.scenario, budget=args.budget,
                             batch_size=args.batch_size, seed=args.seed)
    _, reloaded = compile_bundle(res, prof, BUNDLE, device)
    deploy(ds, reloaded, device, scenario=args.scenario, seed=args.seed)
    print("\nOK: measured, optimized, compiled, deployed.")


if __name__ == "__main__":
    main()
