"""The port's profiler (`repro_torch.traffic.profiler`) and its backends
against `repro.traffic.profiler` on the reference's `mini_profiler`
fixture (iot-class, 300 flows of up to 12 packets, seed 0, the mini
feature set, `tree-fast`).

The modeled fidelities are arithmetic over the same feature matrices and
trained forests, so they must equal the reference's exactly; so must the
replayed fidelities under the modeled service constants, whose replay
clock the port computes as the reference does. The measured fidelities
time this machine, so only their invariants are tested.
"""
import math

import numpy as np
import pytest

from repro.core.search_space import FeatureRep as JFeatureRep
from repro.traffic import MINI_FEATURE_NAMES as J_MINI
from repro.traffic import TrafficProfiler as JProfiler
from repro.traffic import make_dataset as j_make

from repro_torch.core.search_space import FeatureRep
from repro_torch.traffic import (
    MINI_FEATURE_NAMES,
    ProfilerBackend,
    TrafficProfiler,
    backend_suite,
)
from repro_torch.traffic.synth import make_dataset

DS_KW = dict(n_flows=300, max_pkts=12, seed=0)
PROF_KW = dict(model="tree-fast", cost_metric="exec_time", cost_mode="modeled",
               seed=0)
REPS = ((MINI_FEATURE_NAMES[:3], 6), (MINI_FEATURE_NAMES[2:7], 12),
        (MINI_FEATURE_NAMES, 1), (MINI_FEATURE_NAMES[1:2], 4))
METRICS = ("exec_time", "latency", "throughput", "naive_cost",
           "model_inf_cost", "pkt_depth_cost", "naive_perf",
           "throughput_replayed", "throughput_replayed_sharded",
           "latency_p99_replayed")


@pytest.fixture(scope="module")
def mini():
    return (TrafficProfiler(make_dataset("iot-class", **DS_KW),
                            MINI_FEATURE_NAMES, device="cpu", n_shards=2,
                            bisect_iters=6, **PROF_KW),
            JProfiler(j_make("iot-class", **DS_KW), J_MINI, n_shards=2,
                      bisect_iters=6, **PROF_KW))


def test_feature_matrices_match_reference(mini):
    port, ref = mini
    for depth in (1, 6, 12):
        for a, b in zip(port.matrices_at_depth(depth),
                        ref.matrices_at_depth(depth)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", METRICS)
def test_modeled_metrics_match_reference(mini, metric):
    port, ref = mini
    for feats, depth in REPS:
        got = port(FeatureRep(feats, depth), metric)
        want = ref(JFeatureRep(feats, depth), metric)
        assert (got.cost, got.perf, got.aux) == (want.cost, want.perf,
                                                 want.aux), (feats, depth)
        assert math.isfinite(got.cost)


def test_true_metrics_and_perf_cache(mini):
    port, ref = mini
    x = FeatureRep(MINI_FEATURE_NAMES[:3], 6)
    got, want = port.true_metrics(x), ref.true_metrics(
        JFeatureRep(MINI_FEATURE_NAMES[:3], 6))
    assert (got.cost, got.perf) == (want.cost, want.perf)
    f1_a, forest_a = port.perf_f1(x)
    f1_b, forest_b = port.perf_f1(FeatureRep(MINI_FEATURE_NAMES[:3], 6))
    assert f1_a == f1_b and forest_a is forest_b


def test_backend_suite_ordering_and_metrics(mini):
    port, _ = mini
    suite = backend_suite(port, ("modeled", "replayed"))
    assert list(suite) == ["modeled", "replayed"]
    assert isinstance(suite["modeled"], ProfilerBackend)
    assert suite["modeled"].metric == "throughput"
    assert suite["replayed"].metric == "throughput_replayed"
    x = FeatureRep(MINI_FEATURE_NAMES[:3], 6)
    assert suite["modeled"](x) is port(x, "throughput")
    with pytest.raises(ValueError, match="cheap -> expensive"):
        backend_suite(port, ("replayed", "modeled"))
    with pytest.raises(ValueError, match="unknown fidelities"):
        backend_suite(port, ("modeled", "live_nic"))


def test_measured_fidelities_invariants():
    """Measured on this machine: finite, and zero drops at the rate the
    replayed fidelity reports."""
    prof = TrafficProfiler(make_dataset("iot-class", **DS_KW),
                           MINI_FEATURE_NAMES, model="tree-fast",
                           cost_mode="measured", bisect_iters=4,
                           device="cpu")
    x = FeatureRep(MINI_FEATURE_NAMES[:4], 8)
    _, forest = prof.perf_f1(x)
    us = prof.measured_exec_us(x, forest)
    assert math.isfinite(us) and us > 0
    for shards in (1, 2):
        gbps, stats = prof.replayed_throughput_gbps(x, forest, n_shards=shards)
        assert math.isfinite(gbps) and gbps > 0
        assert stats.drops == 0
        assert len(stats.predictions) == prof.test_ds.n_flows
    p99, stats = prof.replayed_latency_p99(x, forest)
    assert math.isfinite(p99) and p99 > 0 and stats.drops == 0


@pytest.mark.parametrize("shards", [1, 2])
def test_attachments_match_reference(mini, shards):
    """`control=` and `obs=` reach a `ServeSession`, as in the reference:
    the replayed throughput under the modeled clock, with a control plane
    (sharded) and an observability bundle on the final replay, equals the
    reference's, and the bundle saw exactly that one replay."""
    from repro.serve import control as jcontrol
    from repro.serve import obs as jobs

    from repro_torch.serve import control as tcontrol
    from repro_torch.serve import obs as tobs

    port, ref = mini
    names, depth = MINI_FEATURE_NAMES[:3], 6
    _, f_t = port.perf_f1(FeatureRep(names, depth))
    _, f_j = ref.perf_f1(JFeatureRep(J_MINI[:3], depth))
    out = []
    for prof, x, forest, ctl, obs in (
            (port, FeatureRep(names, depth), f_t, tcontrol, tobs),
            (ref, JFeatureRep(J_MINI[:3], depth), f_j, jcontrol, jobs)):
        bundle = obs.Observability(drift=obs.DriftMonitor())
        kw = dict(obs=bundle)
        if shards > 1:
            kw["control"] = ctl.ControlConfig(interval_pkts=256,
                                              imbalance_trigger=1.04)
        gbps, stats = prof.replayed_throughput_gbps(x, forest, n_shards=shards,
                                                    **kw)
        p99, st99 = prof.replayed_latency_p99(x, forest, obs=bundle)
        out.append((gbps, stats.drops, stats.control, p99,
                    bundle.drift.signal()["n_flows"],
                    [e.kind for e in bundle.audit.events]))
    assert out[0] == out[1]
    assert out[0][1] == 0 and math.isfinite(out[0][0])
    if shards > 1:
        assert out[0][2] is not None and out[0][2]["steps"] > 0
