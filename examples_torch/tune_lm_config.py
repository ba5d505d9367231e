"""CATO beyond the paper, on the port: tune an LM serving pipeline's
config with the same multi-objective BO the paper applies to traffic
pipelines, under the H100's roofline constants.

The port of `examples/tune_lm_config.py`. The cost is the analytic
roofline step time per generated token (no kernel runs), so `--device`
only checks that the card is there, as every drive does.

    PYTHONPATH=src python examples_torch/tune_lm_config.py [--arch qwen3-8b]
"""
import argparse

from repro_torch import configs
from repro_torch.core.tuner import PipelineTuner
from repro_torch.device import resolve_device


def tune(arch="qwen3-8b", iters=40, chips=1, seed=0):
    """The serving-config Pareto front of `arch` on `chips` cards. Returns
    (config, tuner, result); asserts the front trades cost for quality."""
    cfg = configs.get(arch)
    tuner = PipelineTuner(cfg, chips=chips)
    res = tuner.tune(iters, seed=seed)
    front = res.pareto_observations()
    assert len(front) >= 2, "the front holds no trade-off"
    return cfg, tuner, res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg, _, res = tune(args.arch, args.iters, args.chips)
    print(f"== serving-config Pareto front for {cfg.name} (cost = us per "
          f"generated token on {args.chips} H100, perf = quality proxy) ==")
    for o in res.pareto_observations():
        x = o.x
        print(f"  {o.cost:7.3f}us  q={o.perf:.3f}  kv={x.kv_dtype:4s} "
              f"window={x.window:6d} mb={x.microbatches} remat={x.remat:5s} "
              f"batch={x.decode_batch}")


if __name__ == "__main__":
    main()
