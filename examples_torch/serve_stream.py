"""Sustained streaming classification through the port's serving runtime.

The port of `examples/serve_stream.py`: replays a synthetic app-class
trace as a live packet stream through the vectorized ingest path,
micro-batched dispatch with reused staging arenas, and the single-launch
fused extract+infer kernel (B2, `csrc/fused_pipeline.cu`) on the card;
measures the zero-loss throughput point (highest offered load with zero
drops, Fig. 5c), and checks that the streaming path's predictions equal
the batch `ServingPipeline`'s on the same flows.

With `--shards N` the pipeline is replicated across N workers behind
RSS-style symmetric flow steering (`ShardedRuntime`): the zero-loss
bisection runs over the aggregate offered load, per-shard shares and
drops are printed, and the prediction parity still holds exactly.

    PYTHONPATH=src python examples_torch/serve_stream.py [--shards 4]
    PYTHONPATH=src python examples_torch/serve_stream.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import FeatureRep
from repro_torch.device import resolve_device
from repro_torch.serve import (
    PacketStream, ServiceModel, ShardedRuntime, StreamingRuntime,
    find_zero_loss_rate,
)
from repro_torch.traffic import extract_features, make_dataset
from repro_torch.traffic.models import macro_f1, train_traffic_model
from repro_torch.traffic.pipeline import build_pipeline

# a CATO-style compact representation: 8 features at depth 12
REP = FeatureRep(
    ("dur", "s_load", "s_pkt_cnt", "s_bytes_sum", "s_bytes_mean",
     "s_iat_mean", "ack_cnt", "d_bytes_med"),
    depth=12,
)


def deployment(device, n_flows=1200, max_pkts=48, seed=7):
    """The held-out half of the trace and REP's fused pipeline, its forest
    trained on the other half."""
    ds = make_dataset("app-class", n_flows=n_flows, max_pkts=max_pkts,
                      seed=seed)
    train_ds, test_ds = ds.split(test_frac=0.5, seed=0)
    X = extract_features(train_ds, REP.features, REP.depth, device=device)
    forest, _ = train_traffic_model(X, train_ds.label, model="rf-fast", seed=0)
    # fused=True: one launch of B2 per micro-batch (extract+infer)
    pipeline = build_pipeline(REP, forest, max_pkts=REP.depth, fused=True,
                              device=device)
    return test_ds, pipeline


def runtime_factory(pipeline, n_shards):
    def make_runtime(execute: bool = True):
        if n_shards > 1:
            return ShardedRuntime(
                pipeline, n_shards=n_shards, capacity=2048, max_batch=128,
                min_bucket=8, flush_timeout_s=0.05, idle_timeout_s=60.0,
                execute=execute,
            )
        return StreamingRuntime(
            pipeline, capacity=2048, max_batch=128, min_bucket=8,
            flush_timeout_s=0.05, idle_timeout_s=60.0, execute=execute,
        )
    return make_runtime


def serve(test_ds, pipeline, n_shards=1, service=None, iters=10):
    """Calibrate the replay clock (wall-clock timings on this machine,
    unless `service` is given), then bisect the zero-loss rate; asserts
    zero drops there. Returns (rate_pps, ReplayStats, service)."""
    stream = PacketStream.from_dataset(test_ds, seed=0)
    print(f"trace: {stream.n_flows} flows, {stream.n_events} packets, "
          f"{stream.total_bytes / 1e6:.1f} MB")
    # hardware-RSS buffer provisioning: every worker queue owns a
    # full-size descriptor ring
    ring_capacity = max(64, min(4096, stream.n_events // 8))
    make_runtime = runtime_factory(pipeline, n_shards)
    if service is None:
        print("calibrating service model (measured)...")
        service = ServiceModel.measure(make_runtime(True), stream)
    print(f"  ingest {service.pkt_accum_ns:,.0f} ns/pkt, "
          f"batch-64 {service.bucket_ns.get(64, 0) / 1e3:,.1f} us")

    rate_pps, stats = find_zero_loss_rate(
        stream, make_runtime, service, iters=iters,
        ring_capacity=ring_capacity, verbose=False,
    )
    m = stats.metrics
    print(f"\nzero-loss throughput: {stats.offered_gbps:.4f} Gbit/s "
          f"({rate_pps:,.0f} pkts/s offered, aggregate)")
    print(f"  drops at reported rate: {stats.drops} "
          f"(ring {stats.drops_ring}, table {stats.drops_table})")
    print(f"  flow latency p50 {stats.latency_p50_s * 1e3:.3f} ms, "
          f"p99 {stats.latency_p99_s * 1e3:.3f} ms (enqueue -> prediction)")
    if stats.n_shards > 1:
        print(f"  load imbalance {stats.load_imbalance:.3f} "
              f"(max shard share / mean share)")
        for p in stats.per_shard:
            share = p["pkts_total"] / max(m.pkts_total, 1)
            print(f"    shard {p['shard']}: {share * 100:5.1f}% of packets, "
                  f"{p['batches']} batches, drops {p['drops_ring']}+"
                  f"{p['drops_table']}, p99 "
                  f"{p['latency_p99_s'] * 1e3:.3f} ms")
    print("  latency histogram:")
    for lo, hi, n in m.latency.rows():
        print(f"    [{lo * 1e3:9.3f}, {hi * 1e3:9.3f}) ms  {'#' * min(n, 60)} {n}")
    print(f"  batches {m.batches}, occupancy {m.occupancy_stats()['mean']:.2f}, "
          f"distinct dispatch shapes {m.compile_count()} "
          f"(buckets {sorted(b for b, _ in m.shapes_seen)})")
    assert stats.drops == 0, "drops at the reported zero-loss rate"
    return rate_pps, stats, service


def parity(test_ds, pipeline, stats):
    """Streaming vs batch: the same prediction for every flow. Returns the
    streamed predictions and their held-out macro-F1."""
    batch_preds = pipeline(test_ds.truncate(REP.depth))
    stream_preds = np.array(
        [stats.predictions[i] for i in range(test_ds.n_flows)]
    )
    n_match = int((stream_preds == batch_preds).sum())
    print(f"\nstreaming vs batch predictions: {n_match}/{test_ds.n_flows} identical")
    assert n_match == test_ds.n_flows, "streaming path diverged from batch pipeline"
    f1 = macro_f1(test_ds.label, stream_preds)
    print(f"held-out macro-F1 through the streaming path: {f1:.3f}")
    return stream_preds, f1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shards", type=int, default=1,
                    help="RSS-steered worker count (1 = single runtime)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain version")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"== streaming serving runtime: app-class ({args.shards} worker(s), "
          f"{device}) ==")
    test_ds, pipeline = deployment(device)
    _, stats, _ = serve(test_ds, pipeline, n_shards=args.shards)
    parity(test_ds, pipeline, stats)
    print("OK")


if __name__ == "__main__":
    main()
