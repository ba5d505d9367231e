"""The stream phase's zero-loss rates at two bisection depths, in one
process on a card.

    python3 tools/stream_depth.py [--depths 6 5] [--out DIR]

It builds `chip_smoke.py`'s stream deployment as the script does (the zipf
app-class trace of STREAM_FLOWS flows of up to STREAM_PKTS packets, 59
incremental features at depth 50, the forest trained on the card's
columns, a fused pipeline on a 4-shard fleet) and runs both reuse arms'
searches (`find_zero_loss_rate`, service constants measured first) at
each depth, in the order given and then reversed (6, 5, 5, 6 by default),
so that each depth runs early and late. Each search prints one JSON line:
arm, depth, the zero-loss packets/s, drops at that rate, an upper bound
of the bisection's final bracket (the rate's resolution, rate / 2^depth),
the launches of the fused kernels and the seconds. A cut of the depth
keeps the phase's meaning when every rate found at the shallower depth
lies within the deeper search's spread across its runs widened by the
shallower resolution, and every replay at a reported rate drops nothing. Lines also go to
``DIR/stream_depth.jsonl`` (default ``build/stream_depth/``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="+", default=[6, 5])
    ap.add_argument("--out", default=str(ROOT / "build" / "stream_depth"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")

    import chip_smoke as c
    from repro_torch.core.search_space import FeatureRep
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_pipeline import (
        fused_agg_call,
        fused_pipeline_call,
    )
    from repro_torch.serve.runtime import (
        PacketStream,
        ReuseConfig,
        ServiceModel,
        ShardedRuntime,
        find_zero_loss_rate,
    )
    from repro_torch.traffic.extraction import extract_features
    from repro_torch.traffic.features import FEATURE_NAMES
    from repro_torch.traffic.models import train_traffic_model
    from repro_torch.traffic.pipeline import build_pipeline
    from repro_torch.traffic.synth import make_scenario_dataset

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    log = (out_dir / "stream_depth.jsonl").open("w")

    def emit(**fields):
        line = json.dumps(fields)
        print(line, flush=True)
        log.write(line + "\n")

    emit(card=c.nvidia_smi())
    _build.build_library()
    _build.load_library()
    conn_depth = 50
    ds_s = make_scenario_dataset("app-class", "zipf", n_flows=c.STREAM_FLOWS,
                                 max_pkts=c.STREAM_PKTS, seed=3)
    stream = PacketStream.from_dataset(ds_s, seed=0)
    inc_names = tuple(f for f in FEATURE_NAMES if not f.endswith("_med"))
    rep_s = FeatureRep(inc_names, depth=conn_depth)
    x_s = extract_features(ds_s, inc_names, conn_depth, device="cuda")
    forest_s, _ = train_traffic_model(x_s, ds_s.label, model="rf", seed=0)
    pipe_s = build_pipeline(rep_s, forest_s, max_pkts=conn_depth, fused=True)
    ring = max(64, min(6144, stream.n_events // 6))
    counters = {"fused_forest_infer": fused_pipeline_call,
                "fused_agg_infer": fused_agg_call}

    def fleet(reuse):
        def make(execute):
            return ShardedRuntime(pipe_s, n_shards=4, capacity=2048,
                                  max_batch=8, flush_timeout_s=2e-4,
                                  execute=execute, reuse=reuse)
        return make

    arms = (("off", None),
            ("on", ReuseConfig(drift_threshold=0.1, refresh_every=256)))
    for depth in args.depths + args.depths[::-1]:
        for tag, reuse in arms:
            t0 = time.perf_counter()
            make = fleet(reuse)
            svc = ServiceModel.measure(make(True), stream, n_pkt_sample=16000,
                                       reps=5, calibrate_warm=True)
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            pps, st = find_zero_loss_rate(stream, make, svc, iters=depth,
                                          ring_capacity=ring)
            torch.cuda.synchronize()
            # the bracket starts as [lo, 2 lo] with lo at most the rate
            # found, and each step halves it
            emit(arm=tag, depth=depth, zero_loss_pps=pps, drops=st.drops,
                 resolution_pps=pps / 2 ** depth,
                 launches={k: fn.launches for k, fn in counters.items()},
                 seconds=time.perf_counter() - t0)
    log.close()


if __name__ == "__main__":
    main()
