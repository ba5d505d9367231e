"""Quickstart: CATO end-to-end on the IoT use case, on the port.

The port of `examples/quickstart.py`: the profiler extracts its feature
matrices on the card, and the optimizer searches (features x depth) for
the Pareto front of per-flow execution time against macro-F1.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core import CatoOptimizer, SearchSpace, build_priors
from repro_torch.device import resolve_device
from repro_torch.traffic import (
    MINI_FEATURE_NAMES, TrafficProfiler, extract_features, make_dataset,
)


def optimize(device, n_flows=2000, max_pkts=64, max_depth=50, iters=25):
    """The iot-class set, its 6-feature space, the MI priors and CATO's
    search. Returns (priors, result)."""
    ds = make_dataset("iot-class", n_flows=n_flows, max_pkts=max_pkts, seed=0)
    prof = TrafficProfiler(ds, MINI_FEATURE_NAMES, model="rf-fast",
                           cost_metric="exec_time", cost_mode="modeled",
                           device=device)
    space = SearchSpace(MINI_FEATURE_NAMES, max_depth=max_depth)
    X = extract_features(ds, MINI_FEATURE_NAMES, max_depth, device=device)
    priors = build_priors(space, X, ds.label)
    result = CatoOptimizer(space, prof, priors, seed=0).run(iters, verbose=False)
    assert result.pareto_observations(), "the search found no Pareto point"
    return priors, result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain version")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"== CATO quickstart: iot-class, 6 candidate features ({device}) ==")
    priors, result = optimize(device)
    print("feature MI scores:",
          dict(zip(MINI_FEATURE_NAMES, priors.mi.round(2))))
    print("\nestimated Pareto front (cost = per-flow execution time):")
    for o in result.pareto_observations():
        print(f"  {o.cost:7.3f}us  F1={o.perf:.3f}  depth={o.x.depth:3d}  "
              f"features={list(o.x.features)}")


if __name__ == "__main__":
    main()
