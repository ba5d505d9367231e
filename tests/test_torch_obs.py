"""The port's observability (`repro_torch.serve.obs`: audit log, drift
monitor, SLO tracker, Prometheus exporter and the `Observability` bundle)
against `repro.serve.obs`.

The pieces are host numpy, so the same inputs must give the same outputs:
for the same batches the drift verdicts, SLO verdicts and Prometheus text
equal the reference's, and audit logs round-trip through JSONL, also from
one package to the other. End to end, a controlled replay instrumented
with a whole bundle (tracer, drift, latency sketches, SLO, exporter) under
fixed clock constants leaves the same exported series, Prometheus text,
audit log, drift signal and trace summary in both packages.
"""
import json

import numpy as np
import pytest

import repro.serve as jserve
from repro.core.search_space import FeatureRep as JFeatureRep
from repro.serve import obs as jobs
from repro.serve.runtime.metrics import LatencyHistogram as JHist
from repro.traffic import extract_features as j_extract
from repro.traffic import synth as jsynth
from repro.traffic.models import train_traffic_model as j_train
from repro.traffic.pipeline import build_pipeline as j_build

import repro_torch.serve as tserve
from repro_torch.convert import forest_from_numpy
from repro_torch.core.search_space import FeatureRep
from repro_torch.serve import obs as tobs
from repro_torch.serve.runtime.metrics import LatencyHistogram as THist
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_scenario_dataset

NAMES, DEPTH = ("dur", "s_load", "s_bytes_mean", "s_iat_mean", "ack_cnt"), 8
SERVICE = dict(pkt_accum_ns=800.0, pkt_track_ns=200.0,
               bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5},
               gather_ns_per_flow=200.0, source="synthetic")


# ---------------------------------------------------------------------------
# audit log
# ---------------------------------------------------------------------------

def _log(obs):
    log = obs.AuditLog()
    log.record("rebalance", 1.0, "imbalance", {"moves": 3, "x": np.int64(4)},
               before={"imbalance": 1.8}, after={"imbalance": 1.1})
    log.record("deploy", 2.0, "knee point", {"depth": 8, "f": np.float32(0.5)})
    log.record("slo", 3.5, "burn", {"burn_fast": 2.0})
    return log


def test_audit_roundtrips_and_crosses_packages(tmp_path):
    want, got = _log(jobs), _log(tobs)
    assert [e.to_doc() for e in got.events] == [e.to_doc() for e in want.events]
    assert got.summary() == want.summary()
    with pytest.raises(ValueError, match="unknown audit kind"):
        got.record("reboot", 0.0, "nope")
    for writer, reader in ((got, tobs), (want, tobs), (got, jobs)):
        path = writer.save(tmp_path / "audit.jsonl")
        back = reader.AuditLog.load(path)
        assert [e.to_doc() for e in back.events] == \
            [e.to_doc() for e in writer.events]
        path.unlink()


# ---------------------------------------------------------------------------
# drift: the same batches, the same verdicts
# ---------------------------------------------------------------------------

def _drift_batches(kind, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(40):
        if kind == "stationary" or i < 20:
            preds = rng.choice(3, size=64, p=[0.6, 0.3, 0.1])
        else:
            preds = np.where(rng.random(64) < 0.8, 2, rng.choice(3, size=64))
        conf = rng.random(64)
        feats = rng.normal(size=(64, 4)) + (3.0 * (kind == "features" and i >= 20))
        yield preds, conf, feats


@pytest.mark.parametrize("kind", ["stationary", "classes", "features"])
def test_drift_verdicts_match_reference(kind):
    kw = dict(alpha_fast=0.25, alpha_slow=0.02, min_batches=4)
    dj, dt = jobs.DriftMonitor(**kw), tobs.DriftMonitor(**kw)
    fired = 0
    for i, (preds, conf, feats) in enumerate(_drift_batches(kind)):
        for dm in (dj, dt):
            dm.note_predictions(preds, conf)
            dm.note_features(feats)
        for thr in ((0.25, np.inf), (0.1, 2.0)):
            want = dj.check(*thr, release_frac=0.5)
            got = dt.check(*thr, release_frac=0.5)
            assert got.to_doc() == want.to_doc()
            fired += got.triggered
        assert dt.signal() == dj.signal()
        if i == 30:
            dj.rebaseline()
            dt.rebaseline()
    assert dt.confidence() == dj.confidence()
    assert (fired > 0) == (kind != "stationary")


def test_streaming_moments_match_reference():
    X = np.random.default_rng(0).normal(size=(500, 3)) * [1.0, 5.0, 0.1]
    sj, st = jobs.StreamingMoments(3), tobs.StreamingMoments(3)
    for lo in range(0, 500, 64):
        sj.update(X[lo:lo + 64])
        st.update(X[lo:lo + 64])
    assert st.n == sj.n == 500
    np.testing.assert_array_equal(st.mean, sj.mean)
    np.testing.assert_array_equal(st.var(), sj.var())


# ---------------------------------------------------------------------------
# SLO: the same notes, the same verdicts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target_s", [2e-4, 1e-3, 10.0])
def test_slo_verdicts_match_reference(target_s):
    kw = dict(target_s=target_s, objective=0.99, window_s=0.01,
              slow_windows=4)
    tj, tt = jobs.SLOTracker(jobs.SLOConfig(**kw)), tobs.SLOTracker(
        tobs.SLOConfig(**kw))
    rng = np.random.default_rng(1)
    t = 0.0
    for step in range(60):
        t += rng.random() * 4e-3
        lat = rng.exponential(3e-4 * (1 + (step > 30)), size=rng.integers(0, 40))
        tj.note(t, lat)
        tt.note(t, lat)
        if step % 3 == 0:
            assert tt.check(t).to_doc() == tj.check(t).to_doc()
    assert tt.signal() == tj.signal()
    assert tt.attainment == tj.attainment
    assert (tt.to_registry().snapshot() == tj.to_registry().snapshot())
    with pytest.raises(ValueError):
        tobs.SLOConfig(target_s=1e-3, objective=1.5)


# ---------------------------------------------------------------------------
# Prometheus text
# ---------------------------------------------------------------------------

def _registry(obs, hist_cls):
    reg = obs.MetricsRegistry()
    reg.inc("ingest.pkts_total", 100)
    reg.inc("shard0.ingest.pkts_total", 60)
    reg.inc("shard1.tenant1.dispatch.flows_predicted", 40)
    reg.set_gauge("flow_table.load_factor", 0.5, reduce="max")
    reg.union("dispatch.shapes_seen", [(8, 5)])
    reg.extend_samples("dispatch.batch_occupancy", [3, 9])
    h = hist_cls()
    h.record_many(np.array([1e-3, 2e-3, 4e-3]))
    reg.attach_hist("dispatch.latency", h)
    sk = obs.LatencySketch()
    sk.record_many(np.array([1e-4, 2e-4]))
    reg.attach_sketch("latency.total", sk)
    return reg


def test_prometheus_text_matches_reference():
    want = jobs.render_prometheus(_registry(jobs, JHist))
    got = tobs.render_prometheus(_registry(tobs, THist))
    assert got == want
    assert tobs.check_prometheus(got) == []
    for bad in ("# HELP a x\n# HELP a x\n# TYPE a counter\na 1\n",
                "what is this\n", "orphan_sample 1\n",
                "# TYPE a counter\na 1\n# HELP a late\n"):
        assert tobs.check_prometheus(bad) == jobs.check_prometheus(bad) != []


def test_exporter_requires_bind():
    ex = tobs.MetricsExporter()
    with pytest.raises(RuntimeError, match="bind"):
        ex.collect(0.0)
    ex.bind(tobs.MetricsRegistry)
    doc = ex.step(1.25)
    assert doc["now_pkts"] == 1.25 and ex.steps == 1 and ex.last is doc


# ---------------------------------------------------------------------------
# the whole bundle on a controlled replay
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes():
    kw = dict(n_flows=120, max_pkts=256, seed=3)
    jds = jsynth.make_scenario_dataset("app-class", "zipf", **kw)
    ds = make_scenario_dataset("app-class", "zipf", **kw)
    jf, _ = j_train(np.asarray(j_extract(jds, NAMES, DEPTH)), jds.label,
                    model="tree-fast", seed=0)
    tf = forest_from_numpy(jf.feature, jf.threshold, jf.leaf, jf.depth,
                           jf.n_features, jf.classes)
    return ((jserve, jds, j_build(JFeatureRep(NAMES, DEPTH), jf, DEPTH,
                                  use_kernel=False)),
            (tserve, ds, build_pipeline(FeatureRep(NAMES, DEPTH), tf, DEPTH,
                                        fused=True, device="cpu")))


def _instrumented(sv, ds, pipe, path, target_s):
    stream = sv.PacketStream.from_dataset(ds, seed=0)
    obs = sv.Observability(
        tracer=sv.Tracer(capacity=4096, sample=0.25, seed=1),
        drift=sv.DriftMonitor(), latency=sv.LatencyConfig(),
        slo=sv.SLOTracker(sv.SLOConfig(target_s=target_s, objective=0.99,
                                       window_s=0.02, slow_windows=4)),
        exporter=sv.MetricsExporter(jsonl_path=str(path)))
    session = sv.ServeSession(obs=obs, control=sv.ControlConfig(
        interval_pkts=512, imbalance_trigger=1.04))
    stats = sv.replay(
        stream, lambda: sv.ShardedRuntime(pipe, n_shards=4, capacity=2048,
                                          max_batch=64, execute=True),
        2e5, sv.ServiceModel(**SERVICE), session=session)
    return stats, obs


@pytest.mark.parametrize("target_s", [1e-9, 10.0], ids=["breach", "met"])
def test_instrumented_replay_matches_reference(pipes, tmp_path, target_s):
    out = []
    for i, (sv, ds, pipe) in enumerate(pipes):
        path = tmp_path / f"series{i}.jsonl"
        stats, obs = _instrumented(sv, ds, pipe, path, target_s)
        out.append(dict(
            drops=stats.drops, control=stats.control,
            series=[json.loads(s) for s in path.read_text().splitlines()],
            prometheus=obs.exporter.prometheus(),
            audit=[e.to_doc() for e in obs.audit.events],
            drift=obs.drift.signal(), slo=obs.slo.signal(),
            trace=obs.tracer.summary(),
            ))
    want, got = out[0], out[1]
    for key in ("drops", "control", "series", "prometheus", "audit", "drift",
                "slo", "trace"):
        assert got[key] == want[key], key
    assert got["drops"] == 0 and len(got["series"]) >= 1
    assert tobs.check_prometheus(got["prometheus"]) == []
    assert ('cato_latency_total{quantile="0.99"}' in got["prometheus"])
    breaches = [a for a in got["audit"] if a["kind"] == "slo"]
    assert (len(breaches) > 0) == (target_s < 1.0)
