"""The port's compile-to-deploy layer (`repro_torch.serve.deploy`) against
`repro.serve.deploy`.

`compile_front` over the ported optimizer's result must give the
reference's points (configurations, objectives, forests, metadata but
compile wall time); a `ParetoBundle` saved by either package loads in the
other and serves the same classes on the CPU (the reference's
`use_kernel=False` pipeline, the port's B2 plain version; the straddle
rule); `make_swap` hot-swaps a bundle point into a live fleet with every
flow predicted exactly once, as in the reference; `deploy` swaps at once.
"""
import importlib

import numpy as np
import pytest

import repro.core as jcore
from repro.serve import ServeSession as JServeSession
from repro.serve.control import ControlConfig as JControlConfig
from repro.serve import runtime as jrt
from repro.serve.obs import AuditLog as JAuditLog
from repro.traffic import MINI_FEATURE_NAMES as J_MINI
from repro.traffic import TrafficProfiler as JProfiler
from repro.traffic import extract_features as j_extract
from repro.traffic import make_dataset as j_make

import repro_torch.core as pcore
from repro_torch.core.search_space import FeatureRep
from _torch_parity import MAX_STRADDLED
from repro_torch.kernels.ref import straddled_flows
from repro_torch.serve import runtime as prt
from repro_torch.serve.control import ControlConfig
from repro_torch.serve.obs import AuditLog
from repro_torch.serve.session import ServeSession
from repro_torch.traffic import MINI_FEATURE_NAMES, TrafficProfiler
from repro_torch.traffic.extraction import extract_features
from repro_torch.traffic.synth import make_dataset

# the submodules (``serve.deploy`` is also the name of the function)
jdeploy = importlib.import_module("repro.serve.deploy")
tdeploy = importlib.import_module("repro_torch.serve.deploy")

DS_KW = dict(n_flows=300, max_pkts=12, seed=0)
PROF_KW = dict(model="tree-fast", cost_metric="exec_time", cost_mode="modeled",
               seed=0)
SERVICE = dict(pkt_accum_ns=800.0, pkt_track_ns=200.0,
               bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5},
               gather_ns_per_flow=200.0, source="synthetic")


@pytest.fixture(scope="module")
def fronts():
    """Both optimizers over the reference's mini profiler, each front
    compiled by its own package (the port's on the CPU)."""
    port = TrafficProfiler(make_dataset("iot-class", **DS_KW),
                           MINI_FEATURE_NAMES, device="cpu", **PROF_KW)
    ref = JProfiler(j_make("iot-class", **DS_KW), J_MINI, **PROF_KW)
    res_t = pcore.CatoOptimizer(pcore.SearchSpace(MINI_FEATURE_NAMES,
                                                  max_depth=12),
                                port, seed=3, batch_size=4).run(16)
    res_j = jcore.CatoOptimizer(jcore.SearchSpace(J_MINI, max_depth=12),
                                ref, seed=3, batch_size=4).run(16)
    got = tdeploy.compile_front(res_t, port, fused=True, device="cpu",
                                max_points=5, meta={"run": "port"})
    # the reference's XLA warm-up of every bucket is its own affair
    want = jdeploy.compile_front(res_j, ref, fused=False, use_kernel=False,
                                 warm=False, max_points=5, meta={"run": "port"})
    return port, ref, got, want


def _point_doc(p) -> dict:
    d = p.to_doc()
    meta = dict(d["compile_meta"])
    meta.pop("compile_s")
    meta.pop("buckets")
    meta.pop("fused")                  # each side compiled its own path
    meta.pop("use_kernel", None)       # the reference's alone
    return {**d, "compile_meta": meta}


def test_compile_front_matches_reference(fronts):
    _, _, got, want = fronts
    assert len(got.points) == len(want.points) >= 3
    assert [_point_doc(p) for p in got.points] == \
        [_point_doc(p) for p in want.points]
    # the budget's wall seconds are each machine's own
    walls = [{k: v.pop("wall_s") for k, v in b.meta["budget"].items()}
             for b in (got, want)]
    assert got.meta == want.meta
    for b, w in zip((got, want), walls):
        for k, v in w.items():
            b.meta["budget"][k]["wall_s"] = v
    assert _point_doc(got.knee()) == _point_doc(want.knee())
    assert got.best_by_cost().cost == want.best_by_cost().cost
    assert got.best_by_perf().perf == want.best_by_perf().perf
    for p in got.points:
        assert p.pipeline is not None and p.pipeline.device.type == "cpu"
        assert p.compile_meta["buckets"] == tdeploy.warm_buckets_for()


def _classes(point, which, ds_j, ds_t):
    if which == "ref":
        return np.asarray(point.build(warm=False)(ds_j))
    return point.build(warm=False, device="cpu")(ds_t)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_bundle_crosses_packages_and_serves_same_classes(fronts, tmp_path,
                                                         direction):
    port, ref, got, want = fronts
    src, dst = ((want, tdeploy) if direction == "ref_to_port"
                else (got, jdeploy))
    path = src.save(tmp_path / "bundle.json")
    back = dst.ParetoBundle.load(path)
    assert [p.to_doc() for p in back.points] == [p.to_doc() for p in src.points]
    ds_t = make_dataset("iot-class", n_flows=257, max_pkts=12, seed=9)
    ds_j = j_make("iot-class", n_flows=257, max_pkts=12, seed=9)
    bundles = {"ref": back if dst is jdeploy else src,
               "port": back if dst is tdeploy else src}
    for i in range(len(src.points)):
        pj, pt = bundles["ref"].points[i], bundles["port"].points[i]
        cj, ct = _classes(pj, "ref", ds_j, ds_t), _classes(pt, "port", ds_j, ds_t)
        f = pt.forest()
        s = straddled_flows(np.asarray(j_extract(ds_j, pj.rep.features, pj.rep.depth)),
                            extract_features(ds_t, pt.rep.features, pt.rep.depth,
                                             device="cpu"),
                            f.feature, f.threshold, f.depth)
        assert s.sum() <= MAX_STRADDLED * len(s)
        assert np.array_equal(cj[~s], ct[~s])


def test_bundle_rejects_other_documents(tmp_path):
    with pytest.raises(ValueError, match="not a ParetoBundle"):
        tdeploy.ParetoBundle.from_doc({"kind": "something_else"})


def test_make_swap_is_exactly_once_and_matches_reference(fronts):
    _, _, got, want = fronts
    out = []
    for mod, dep, bundle, cfg_mod, sess_mod, ds in (
            (prt, tdeploy, got, ControlConfig, ServeSession,
             make_dataset("app-class", n_flows=80, max_pkts=12, seed=3)),
            (jrt, jdeploy, want, JControlConfig, JServeSession,
             j_make("app-class", n_flows=80, max_pkts=12, seed=3))):
        stream = mod.PacketStream.from_dataset(ds, seed=0)
        svc = mod.ServiceModel(**SERVICE)
        old, new = bundle.best_by_cost(), bundle.best_by_perf()
        log = AuditLog() if dep is tdeploy else JAuditLog()
        kw = {"device": "cpu"} if dep is tdeploy else {}
        swap = dep.make_swap(new, after_pkts=stream.n_events // 2, service=svc,
                             session=sess_mod(audit=log), now_pkts=0.5, **kw)
        assert swap.pipeline is new.pipeline
        st = mod.replay(
            stream, lambda: mod.ShardedRuntime(old.pipeline, n_shards=2,
                                               capacity=1024, max_batch=16,
                                               execute=True),
            stream.base_pps, svc,
            session=sess_mod(control=cfg_mod(interval_pkts=256,
                                             rebalance=False, swap=swap)))
        assert st.drops == 0 and st.metrics.duplicate_predictions == 0
        assert len(st.predictions) == ds.n_flows
        assert st.control["swaps"] == 1
        out.append((st.control, [e.kind for e in log.events],
                    log.events[0].detail, st.metrics.flushes_swap))
    assert out[0] == out[1]


def test_deploy_hot_swaps_at_once(fronts):
    """`deploy` mid-stream on a single worker, in both packages: the swap
    drains in-flight flows under the old pipeline, so every flow is
    predicted exactly once, by the same pipeline as in the reference."""
    _, _, got, want = fronts
    out = []
    for mod, bundle, log, ds, kw in (
            (prt, got, AuditLog(),
             make_dataset("app-class", n_flows=40, max_pkts=12, seed=4),
             {"device": "cpu"}),
            (jrt, want, JAuditLog(),
             j_make("app-class", n_flows=40, max_pkts=12, seed=4), {})):
        s = mod.PacketStream.from_dataset(ds, seed=0)
        old, new = bundle.best_by_cost(), bundle.best_by_perf()
        rt = mod.StreamingRuntime(old.pipeline, capacity=512, max_batch=16)
        E, fid = s.n_events, s.fid
        for lo, hi in ((0, E // 2), (E // 2, E)):
            sl = slice(lo, hi)
            rt.ingest_packets(
                s.key[fid[sl]], s.base_t[sl], s.rel_ts32[sl], s.size[sl],
                s.direction[sl], s.ttl[sl], s.winsize[sl], s.flags_byte[sl],
                s.proto[fid[sl]], s.s_port[fid[sl]], s.d_port[fid[sl]],
                fid[sl], s.fin[sl])
            if lo == 0:
                dep = tdeploy if mod is prt else jdeploy
                sess = (ServeSession if mod is prt else JServeSession)(audit=log)
                recs = dep.deploy(new, rt, float(s.base_t[hi - 1]),
                                  session=sess, **kw)
                assert rt.pipeline is new.pipeline
        rt.drain(float(s.base_t[-1]) + 1.0)
        assert rt.metrics.duplicate_predictions == 0
        assert len(rt.results) == ds.n_flows
        out.append(({k: int(v) for k, v in rt.results.items()}, len(recs),
                    [(e.kind, e.detail) for e in log.events]))
    assert out[0] == out[1]


def test_multi_tenant_point_round_trips_and_builds(fronts, tmp_path):
    _, _, got, want = fronts
    pts_t, pts_j = got.points[:2], want.points[:2]
    mt_t = tdeploy.compile_multi_tenant(pts_t, device="cpu")
    mt_j = jdeploy.compile_multi_tenant(pts_j, fused=True, use_kernel=False)
    assert mt_t.rep == FeatureRep(mt_j.rep.features, mt_j.rep.depth)
    assert (mt_t.cost, mt_t.perf, mt_t.tenant_docs, mt_t.aux) == (
        mt_j.cost, mt_j.perf, mt_j.tenant_docs, mt_j.aux)
    doc = mt_t.to_doc()
    back = tdeploy.MultiTenantBundlePoint.from_doc(doc)
    assert back.to_doc() == doc
    ds_t = make_dataset("iot-class", n_flows=64, max_pkts=12, seed=5)
    ds_j = j_make("iot-class", n_flows=64, max_pkts=12, seed=5)
    got_cls = back.build(warm=False, device="cpu")(ds_t)
    want_cls = np.asarray(mt_j.pipeline(ds_j))
    assert got_cls.shape == want_cls.shape == (64, 2)
    # each lane serves its tenant as that tenant's solo point does
    for t, p in enumerate(pts_t):
        np.testing.assert_array_equal(got_cls[:, t], p.pipeline(ds_t))


def test_warm_buckets_for_matches_reference():
    assert tdeploy.warm_buckets_for() == jdeploy.warm_buckets_for()
    assert tdeploy.warm_buckets_for(lo=4, hi=64) == [4, 8, 16, 32, 64]
