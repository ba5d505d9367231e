"""Multi-tenant co-optimization on the port: the optimizer sees the sharing.

The port of `examples/tune_multitenant.py`, all three steps. A vantage
point serving N tenants from one fleet pays for the *union* extraction
plan once per flow, not for N independent passes, so which joint
configurations are Pareto-optimal depends on how much the tenants
overlap:

1. **Per-tenant tuning (the baseline)**: each tenant's (F, n) space
   optimized alone, its front compiled with `compile_front`, its knee
   chosen.
2. **Joint tuning**: the same tenants as one `MultiTenantSpace` point
   evaluated by `MultiTenantProfiler` (the profilers' feature matrices on
   the card): perf the mean per-tenant macro-F1, cost the union-plan
   extraction plus every tenant's inference, and an ablation billed as
   independent fleets. Rescoring every configuration both runs visited
   under both cost models shows the overlap discount changes the front.
3. **Deploy**: the per-tenant knees fused into one
   `MultiTenantBundlePoint` and hot-swapped into a live sharded replay
   mid-stream: zero drops, every flow answered once for all tenants.

    PYTHONPATH=src python examples_torch/tune_multitenant.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import CatoOptimizer, pareto_mask
from repro_torch.core.search_space import SearchSpace
from repro_torch.device import resolve_device
from repro_torch.serve import (
    ControlConfig,
    PacketStream,
    ServeSession,
    ServiceModel,
    ShardedRuntime,
    compile_front,
    compile_multi_tenant,
    make_swap,
    replay,
    warm_buckets_for,
)
from repro_torch.traffic import TrafficProfiler
from repro_torch.traffic.multi_tenant import MultiTenantProfiler, MultiTenantSpace
from repro_torch.traffic.synth import make_scenario_dataset

N_SHARDS = 2
# shared core + per-tenant specialty features: the overlap is the point
_CORE = ("s_bytes_mean", "s_iat_mean", "s_load", "dur")
POOLS = (
    _CORE + ("proto", "ack_cnt"),
    _CORE + ("s_bytes_max", "psh_cnt"),
    _CORE + ("d_pkt_cnt", "d_iat_std"),
)


def tenants(device, n_flows=240, max_pkts=64, seed=0):
    """The zipf trace, each tenant's space and profiler."""
    ds = make_scenario_dataset("app-class", "zipf", n_flows=n_flows,
                               max_pkts=max_pkts, seed=seed)
    spaces = [SearchSpace(pool, max_depth=12) for pool in POOLS]
    profs = [TrafficProfiler(ds, pool, model="tree-fast", cost_mode="modeled",
                             seed=seed, device=device) for pool in POOLS]
    return ds, spaces, profs


def tune_alone(spaces, profs, device, iters=16, seed=0):
    """1. N independent optimizations; returns each tenant's bundle."""
    print(f"== per-tenant tuning: {len(profs)} independent fronts ==")
    bundles = []
    for t, (space, prof) in enumerate(zip(spaces, profs)):
        res = CatoOptimizer(space, prof, seed=seed + t,
                            batch_size=4).run(iters)
        bundle = compile_front(res, prof, fused=False, warm=False,
                               device=device)
        k = bundle.knee()
        print(f"tenant{t}: {len(bundle.points)} front points, knee "
              f"|F|={len(k.rep.features)} n={k.rep.depth} f1={k.perf:.3f}")
        bundles.append(bundle)
    return bundles


def tune_jointly(spaces, profs, iters=24, seed=0):
    """2. The joint space under shared and independent billing, rescored
    under both; asserts the discount moves some configuration across the
    front. Returns a summary dict."""
    joint = MultiTenantSpace(tuple(spaces))
    shared_prof = MultiTenantProfiler(profs, shared=True)
    indep_prof = MultiTenantProfiler(profs, shared=False)
    print(f"\n== joint tuning over {joint.size:.0f} configurations "
          f"(dim {joint.dim}) ==")
    res_shared = CatoOptimizer(joint, shared_prof, seed=seed,
                               batch_size=4).run(iters)
    res_indep = CatoOptimizer(joint, indep_prof, seed=seed,
                              batch_size=4).run(iters)
    xs = list({o.x.key(): o.x for o in
               res_shared.observations + res_indep.observations}.values())
    rows = [shared_prof(x) for x in xs]
    perf = np.array([r.perf for r in rows])
    cost_sh = np.array([r.aux["cost_shared_us"] for r in rows])
    cost_in = np.array([r.aux["cost_independent_us"] for r in rows])
    on_shared = pareto_mask(np.stack([cost_sh, -perf], axis=1))
    on_indep = pareto_mask(np.stack([cost_in, -perf], axis=1))
    moved = on_shared != on_indep
    disc = np.array([r.aux["overlap_discount"] for r in rows])
    print(f"{len(xs)} distinct joint configs rescored; Pareto-optimal: "
          f"{int(on_shared.sum())} shared-billed vs "
          f"{int(on_indep.sum())} independent-billed, "
          f"{int(moved.sum())} configs changed front membership")
    print(f"overlap discount across pool: mean {disc.mean():.1%}, "
          f"max {disc.max():.1%}")
    for i in np.nonzero(moved)[0][:4]:
        tag = "enters" if on_shared[i] else "leaves"
        feats = " | ".join(",".join(r.features) for r in xs[i].reps)
        print(f"  {tag} the front under shared billing "
              f"(discount {disc[i]:.1%}): {feats}")
    assert moved.any(), \
        "union-plan discount changed no Pareto-optimal configuration"
    return dict(configs=[x.key() for x in xs], perf=perf, cost_shared=cost_sh,
                cost_independent=cost_in, moved=int(moved.sum()))


def deploy(ds, bundles, device, seed=0):
    """3. The tenants' cheapest points fused into one fleet, swapped to
    the fused knees mid-trace; asserts zero drops, every flow answered
    once with one class per tenant. Returns the replay's stats."""
    start = compile_multi_tenant([b.best_by_cost() for b in bundles],
                                 fused=False, warm=False, device=device)
    knees = compile_multi_tenant([b.knee() for b in bundles],
                                 fused=False, warm=False, device=device)
    stream = PacketStream.from_dataset(ds, seed=seed, scenario="zipf")
    svc = ServiceModel.modeled_multi_tenant(start.tenant_reps,
                                            start.tenant_forests())
    start_pipe = start.pipeline

    def fleet():
        return ShardedRuntime(start_pipe, n_shards=N_SHARDS, capacity=2048,
                              max_batch=64, execute=True)

    template = fleet()
    start_pipe.warm(warm_buckets_for(template))
    swap = make_swap(knees, after_pkts=stream.n_events // 2, runtime=template,
                     device=device)
    cfg = ControlConfig(interval_pkts=256, rebalance=False, swap=swap)
    stats = replay(stream, fleet, stream.base_pps, svc,
                   session=ServeSession(control=cfg))
    n_t = len(bundles)
    widths = {np.asarray(v).shape for v in stats.predictions.values()}
    print(f"\n== deploy: {n_t}-tenant bundle hot-swapped into a live "
          f"{N_SHARDS}-shard replay ==")
    print(f"drops={stats.drops}  predicted {len(stats.predictions)}/"
          f"{ds.n_flows} flows x {n_t} tenants  "
          f"swaps={stats.control['swaps']}")
    assert stats.drops == 0, "deployment dropped packets"
    assert len(stats.predictions) == ds.n_flows, "a flow went unpredicted"
    assert widths == {(n_t,)}, f"prediction vectors not per-tenant: {widths}"
    assert stats.control["swaps"] == 1, "the scheduled swap never fired"
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=24,
                    help="joint-space evaluations per cost model")
    ap.add_argument("--solo-iters", type=int, default=16,
                    help="per-tenant evaluations for the baseline fronts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain version")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ds, spaces, profs = tenants(device, seed=args.seed)
    bundles = tune_alone(spaces, profs, device, args.solo_iters, args.seed)
    tune_jointly(spaces, profs, args.iters, args.seed)
    deploy(ds, bundles, device, args.seed)
    print("\nOK: tenants tuned jointly, sharing priced in, fleet swapped.")


if __name__ == "__main__":
    main()
