"""End to end on the port: optimize the app-class pipeline for
latency, then deploy the best Pareto point as a serving pipeline on the
card and classify a held-out traffic batch with it.

The port of `examples/optimize_app_class.py`.

    PYTHONPATH=src python examples_torch/optimize_app_class.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import CatoOptimizer, SearchSpace, build_priors
from repro_torch.device import resolve_device
from repro_torch.traffic import (
    FEATURE_NAMES, TrafficProfiler, extract_features, make_dataset,
)
from repro_torch.traffic.models import macro_f1, train_traffic_model
from repro_torch.traffic.pipeline import build_pipeline


def optimize(device, n_flows=2500, max_pkts=64, max_depth=50, iters=30):
    """CATO's search over all 67 features for modeled latency. Returns
    (dataset, profiler, Pareto front)."""
    ds = make_dataset("app-class", n_flows=n_flows, max_pkts=max_pkts, seed=1)
    prof = TrafficProfiler(ds, FEATURE_NAMES, model="tree-fast",
                           cost_metric="latency", cost_mode="modeled",
                           device=device)
    space = SearchSpace(FEATURE_NAMES, max_depth=max_depth)
    X = extract_features(ds, FEATURE_NAMES, max_depth, device=device)
    priors = build_priors(space, X, ds.label)
    res = CatoOptimizer(space, prof, priors, seed=0).run(iters)
    return ds, prof, res.pareto_observations()


def deploy(ds, prof, front, device):
    """The fastest point within 0.01 of the best F1, its forest retrained
    on the profiler's columns and served by a pipeline on `device`.
    Returns (choice, predictions on the held-out split, their F1)."""
    best_f1 = max(o.perf for o in front)
    choice = min((o for o in front if o.perf >= best_f1 - 0.01),
                 key=lambda o: o.cost)
    Xtr, _ = prof.columns(choice.x)
    forest, _ = train_traffic_model(Xtr, prof.train_ds.label, model="tree-fast")
    pipe = build_pipeline(choice.x, forest, ds.max_pkts, device=device)
    pred = pipe(prof.test_ds)
    return choice, pred, macro_f1(prof.test_ds.label, pred)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain version")
    device = resolve_device(ap.parse_args(argv).device)
    ds, prof, front = optimize(device)
    print("Pareto front (latency s vs F1):")
    for o in front:
        print(f"  {o.cost:8.4f}s  F1={o.perf:.3f}  n={o.x.depth}  "
              f"|F|={len(o.x.features)}")
    choice, pred, f1 = deploy(ds, prof, front, device)
    print(f"\ndeploying: depth={choice.x.depth} features={choice.x.features}")
    print(f"deployed pipeline hold-out F1: {f1:.3f} "
          f"(profiler measured {choice.perf:.3f})")
    names = np.array(ds.class_names)
    print("sample predictions:", names[pred[:8]].tolist())


if __name__ == "__main__":
    main()
