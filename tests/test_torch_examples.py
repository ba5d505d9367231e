"""The port's example drives (`examples_torch/*.py`) at a reduced size on
the CPU: each drive's own step functions must pass the drive's own checks,
and match the same steps composed from `repro` where the clock is modeled
or synthetic (the reference's pipelines are its `use_kernel=False` ones).
The drives' headline runs at full size are on the card (PERF.md)."""
import importlib.util
import pathlib

import numpy as np
import pytest

import repro.core as jcore
import repro.serve as jserve
from repro.core import tuner as jtuner
from repro.traffic import FEATURE_NAMES as J_NAMES
from repro.traffic import MINI_FEATURE_NAMES as J_MINI
from repro.traffic import TrafficProfiler as JProfiler
from repro.traffic import extract_features as j_extract
from repro.traffic import make_dataset as j_make
from repro.traffic.models import macro_f1 as j_f1
from repro.traffic.models import train_traffic_model as j_train
from repro.traffic.pipeline import build_pipeline as j_build

ROOT = pathlib.Path(__file__).resolve().parents[1]
SVC = dict(pkt_accum_ns=800.0, pkt_track_ns=200.0,
           bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5, 128: 1.8e5},
           gather_ns_per_flow=200.0, source="synthetic")


def drive(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(res):
    return [(o.x.key(), o.cost, o.perf, o.iteration, o.fidelity)
            for o in res.observations]


@pytest.mark.parametrize("shards", [1, 2])
def test_serve_stream(shards):
    """Zero drops at the zero-loss rate and streaming = batch predictions,
    under fixed clock constants: the rate, drops, latency tail and every
    prediction equal the reference's."""
    d = drive("serve_stream")
    kw = dict(n_flows=160, max_pkts=24, seed=7)
    test_ds, pipe = d.deployment("cpu", **kw)
    rate, st, _ = d.serve(test_ds, pipe, n_shards=shards,
                          service=d.ServiceModel(**SVC), iters=6)
    preds, f1 = d.parity(test_ds, pipe, st)

    ds = j_make("app-class", **kw)
    train, test = ds.split(test_frac=0.5, seed=0)
    X = j_extract(train, d.REP.features, d.REP.depth)
    forest, _ = j_train(np.asarray(X), train.label, model="rf-fast", seed=0)
    jpipe = j_build(jcore.FeatureRep(d.REP.features, d.REP.depth), forest,
                    d.REP.depth, fused=True, use_kernel=False)
    stream = jserve.PacketStream.from_dataset(test, seed=0)

    def make(execute=True):
        kw = dict(capacity=2048, max_batch=128, min_bucket=8,
                  flush_timeout_s=0.05, idle_timeout_s=60.0, execute=execute)
        if shards > 1:
            return jserve.ShardedRuntime(jpipe, n_shards=shards, **kw)
        return jserve.StreamingRuntime(jpipe, **kw)

    jrate, jst = jserve.find_zero_loss_rate(
        stream, make, jserve.ServiceModel(**SVC), iters=6,
        ring_capacity=max(64, min(4096, stream.n_events // 8)))
    assert (rate, st.drops, st.latency_p50_s, st.latency_p99_s) == \
        (jrate, jst.drops, jst.latency_p50_s, jst.latency_p99_s)
    jpreds = np.array([jst.predictions[i] for i in range(test.n_flows)])
    np.testing.assert_array_equal(preds, jpreds)
    assert f1 == j_f1(test.label, jpreds)


def test_quickstart():
    d = drive("quickstart")
    kw = dict(n_flows=300, max_pkts=24, max_depth=12, iters=8)
    priors, res = d.optimize("cpu", **kw)
    ds = j_make("iot-class", n_flows=300, max_pkts=24, seed=0)
    prof = JProfiler(ds, J_MINI, model="rf-fast", cost_metric="exec_time",
                     cost_mode="modeled")
    space = jcore.SearchSpace(J_MINI, max_depth=12)
    jpri = jcore.build_priors(space, np.asarray(j_extract(ds, J_MINI, 12)),
                              ds.label)
    jres = jcore.CatoOptimizer(space, prof, jpri, seed=0).run(8, verbose=False)
    np.testing.assert_array_equal(priors.mi, jpri.mi)
    assert _trace(res) == _trace(jres)


def test_optimize_app_class():
    d = drive("optimize_app_class")
    ds, prof, front = d.optimize("cpu", n_flows=300, max_pkts=16,
                                 max_depth=12, iters=8)
    choice, pred, f1 = d.deploy(ds, prof, front, "cpu")

    jds = j_make("app-class", n_flows=300, max_pkts=16, seed=1)
    jprof = JProfiler(jds, J_NAMES, model="tree-fast", cost_metric="latency",
                      cost_mode="modeled")
    space = jcore.SearchSpace(J_NAMES, max_depth=12)
    pri = jcore.build_priors(space, np.asarray(j_extract(jds, J_NAMES, 12)),
                             jds.label)
    jfront = jcore.CatoOptimizer(space, jprof, pri, seed=0).run(8) \
        .pareto_observations()
    assert [(o.x.key(), o.cost, o.perf) for o in front] == \
        [(o.x.key(), o.cost, o.perf) for o in jfront]
    best = max(o.perf for o in jfront)
    jchoice = min((o for o in jfront if o.perf >= best - 0.01),
                  key=lambda o: o.cost)
    assert choice.x.key() == jchoice.x.key()
    Xtr, _ = jprof.columns(jchoice.x)
    forest, _ = j_train(Xtr, jprof.train_ds.label, model="tree-fast")
    jpred = j_build(jchoice.x, forest, jds.max_pkts, use_kernel=False)(
        jprof.test_ds)
    np.testing.assert_array_equal(pred, jpred)
    assert f1 == j_f1(jprof.test_ds.label, jpred)


def test_tune_serving(tmp_path):
    """The closed loop at 120 flows of up to 48 packets, budget 3: the same
    multi-fidelity observations, bundle knee and hot-swap as the
    reference; the drive's own checks hold (round trip, zero drops,
    exactly once, post-swap flows equal a knee-only fleet's)."""
    d = drive("tune_serving")
    kw = dict(scenario="zipf", n_flows=120, max_pkts=48, budget=3,
              batch_size=4, bisect_iters=4, seed=0)
    ds, prof, res = d.optimize("cpu", **kw)
    bundle, reloaded = d.compile_bundle(res, prof, tmp_path / "b.json", "cpu")
    st, post, agree = d.deploy(ds, reloaded, "cpu", scenario="zipf", seed=0)
    assert agree == len(post) > 0

    from repro.traffic import backend_suite
    from repro.traffic.synth import make_scenario_dataset

    jds = make_scenario_dataset("app-class", "zipf", n_flows=120, max_pkts=48,
                                seed=0)
    jprof = JProfiler(jds, J_NAMES, model="tree-fast", cost_mode="modeled",
                      scenario="zipf", n_shards=d.N_SHARDS, bisect_iters=4,
                      seed=0)
    space = jcore.SearchSpace(J_NAMES, max_depth=min(50, jds.max_pkts))
    pri = jcore.build_priors(space, jprof.matrices_at_depth(space.max_depth)[0],
                             jprof.train_ds.label)
    ev = jcore.MemoizedEvaluator(backend_suite(jprof, ("modeled",
                                                       "replayed_sharded")))
    jres = jcore.CatoOptimizer(space, ev, pri, seed=0, batch_size=4) \
        .run_multi_fidelity(measure_budget=3)
    assert _trace(res) == _trace(jres)
    assert res.fidelity_counts == jres.fidelity_counts
    jbundle = jserve.compile_front(jres, jprof, fused=True, use_kernel=False,
                                   warm=False)
    assert [(p.rep.key(), p.cost, p.perf) for p in bundle.points] == \
        [(p.rep.key(), p.cost, p.perf) for p in jbundle.points]
    knee, jknee = reloaded.knee(), jbundle.knee()
    assert knee.rep.key() == jknee.rep.key()

    start = jbundle.best_by_cost()
    jstream = jserve.PacketStream.from_dataset(jds, seed=0, scenario="zipf")
    jpipe = start.pipeline

    def fleet():
        return jserve.ShardedRuntime(jpipe, n_shards=d.N_SHARDS, capacity=2048,
                                     max_batch=64, execute=True)

    swap = jserve.make_swap(jknee, after_pkts=jstream.n_events // 2,
                            runtime=fleet())
    jst = jserve.replay(jstream, fleet, jstream.base_pps,
                        jserve.ServiceModel.modeled(start.rep, start.forest()),
                        session=jserve.ServeSession(control=jserve.ControlConfig(
                            interval_pkts=256, rebalance=False, swap=swap)))
    for k in ("swaps", "swap_at_pkts"):
        assert st.control[k] == jst.control[k]
    assert (st.drops, len(st.predictions)) == (jst.drops, len(jst.predictions))


def test_tune_multitenant():
    """All three steps at 120 flows of up to 32 packets: the same tenant
    knees, joint rescoring and front moves as the reference; the deploy
    answers every flow once for all tenants with zero drops."""
    d = drive("tune_multitenant")
    ds, spaces, profs = d.tenants("cpu", n_flows=120, max_pkts=32)
    bundles = d.tune_alone(spaces, profs, "cpu", iters=6)
    joint = d.tune_jointly(spaces, profs, iters=8)
    st = d.deploy(ds, bundles, "cpu")

    from repro.traffic.multi_tenant import MultiTenantProfiler, MultiTenantSpace
    from repro.traffic.synth import make_scenario_dataset

    jds = make_scenario_dataset("app-class", "zipf", n_flows=120, max_pkts=32,
                                seed=0)
    jspaces = [jcore.SearchSpace(p, max_depth=12) for p in d.POOLS]
    jprofs = [JProfiler(jds, p, model="tree-fast", cost_mode="modeled", seed=0)
              for p in d.POOLS]
    for t, (space, prof) in enumerate(zip(jspaces, jprofs)):
        jb = jserve.compile_front(
            jcore.CatoOptimizer(space, prof, seed=t, batch_size=4).run(6),
            prof, fused=False, use_kernel=False, warm=False)
        assert bundles[t].knee().rep.key() == jb.knee().rep.key()
        assert [(p.cost, p.perf) for p in bundles[t].points] == \
            [(p.cost, p.perf) for p in jb.points]
    jsh = MultiTenantProfiler(jprofs, shared=True)
    jin = MultiTenantProfiler(jprofs, shared=False)
    space = MultiTenantSpace(tuple(jspaces))
    obs = (jcore.CatoOptimizer(space, jsh, seed=0, batch_size=4).run(8)
           .observations
           + jcore.CatoOptimizer(space, jin, seed=0, batch_size=4).run(8)
           .observations)
    xs = list({o.x.key(): o.x for o in obs}.values())
    assert [x.key() for x in xs] == joint["configs"]
    rows = [jsh(x) for x in xs]
    np.testing.assert_array_equal(joint["perf"], [r.perf for r in rows])
    np.testing.assert_array_equal(joint["cost_shared"],
                                  [r.aux["cost_shared_us"] for r in rows])
    assert st.drops == 0 and st.control["swaps"] == 1


def test_tune_lm_config(monkeypatch):
    """On one card under the H100's constants the front trades cost for
    quality; under the reference's constants on 256 chips the drive's
    front is the reference example's."""
    d = drive("tune_lm_config")
    cfg, tuner, res = d.tune("qwen3-8b", iters=12, chips=1)
    assert tuner.chips == 1 and tuner.PEAK == 989e12
    J = jtuner.PipelineTuner
    for k in ("PEAK", "HBM", "LINK"):
        monkeypatch.setattr(d.PipelineTuner, k, getattr(J, k))
    _, _, res = d.tune("qwen3-8b", iters=12, chips=256)
    from repro import configs as jconfigs

    jres = J(jconfigs.get("qwen3-8b"), chips=256).tune(12, seed=0)
    assert [(o.x.key(), o.cost, o.perf) for o in res.pareto_observations()] == \
        [(o.x.key(), o.cost, o.perf) for o in jres.pareto_observations()]


def test_serve_lm():
    """The drive's generate on its default architecture, reduced, with the
    reference's parameters carried across: the reference example's greedy
    tokens."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import init_cache as j_init_cache
    from repro.models import init_params as j_init_params
    from repro.serve import make_serve_step as j_make_serve_step
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_numpy

    d = drive("serve_lm")
    assert d.DEFAULT_ARCH == "qwen3-8b"        # examples/serve_lm.py's
    jcfg = jconfigs.get_reduced(d.DEFAULT_ARCH)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.get_reduced(d.DEFAULT_ARCH)
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                  device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (2, 8)).astype(np.int32)
    n = 6
    got = d.generate(cfg, params, prompt, n, "cpu")

    step = jax.jit(j_make_serve_step(jcfg))
    cache = j_init_cache(jcfg, 2, 8 + n + 1)
    tok = jnp.asarray(prompt[:, 0])
    for t in range(1, 8):
        _, cache = step(jp, cache, tok)
        tok = jnp.asarray(prompt[:, t])
    want = []
    for _ in range(n):
        tok, cache = step(jp, cache, tok)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(got, np.stack(want, 1))
