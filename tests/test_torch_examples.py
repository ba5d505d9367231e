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


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2-moe-a2.7b",
                                  "whisper-small"])
def test_serve_lm(arch):
    """The drive's generate on its default architecture, a MoE and the
    audio family, reduced, with the reference's parameters carried across:
    the reference example's greedy tokens (`--arch` as the reference's)."""
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
    jcfg = jconfigs.get_reduced(arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.get_reduced(arch)
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


def test_serve_control():
    """The drive's three acts at the reference example's size (120 zipf
    flows of up to 256 packets; 6 bisection steps where it takes 8) under
    its fixed constants, against the same acts composed from `repro` (its
    `use_kernel=False` pipelines): zero-loss rates, drops, imbalance and
    control summaries equal; the swap exactly once, its post-swap flows the
    new pipeline's; the fleet grown and shrunk as the reference's."""
    from repro.core import FeatureRep as JRep
    from repro.traffic.synth import make_scenario_dataset as j_scenario

    d = drive("serve_control")
    kw = dict(n_flows=120, max_pkts=256, seed=3)
    rates = {"hot": 4e6, "cold": 1e5}

    def acts(sv, ds, pipes, fleet_of):
        stream = sv.PacketStream.from_dataset(ds, seed=0)
        svc_a, svc_b = sv.ServiceModel(**d.SVC_A), sv.ServiceModel(**d.SVC_B)
        make = fleet_of(pipes["a"])
        ring = max(64, stream.n_events // 16)
        r_st, s_st = sv.find_zero_loss_rate(stream, make, svc_a, iters=6,
                                            ring_capacity=ring)
        r_dy, s_dy = sv.find_zero_loss_rate(
            stream, make, svc_a, iters=6, ring_capacity=ring,
            session=sv.ServeSession(control=sv.ControlConfig(**d.CONTROL)))
        swap = sv.PipelineSwap(pipes["b"], svc_b,
                               after_pkts=stream.n_events // 2)
        swapped = sv.replay(stream, lambda: make(True), stream.base_pps, svc_a,
                            session=sv.ServeSession(control=sv.ControlConfig(
                                **d.CONTROL, swap=swap)))
        cfg = sv.ControlConfig(interval_pkts=512,
                               headroom=sv.HeadroomPolicy(max_workers=8))
        small = fleet_of(pipes["a"], shards=2, capacity=4096)
        runs = {k: sv.replay(stream, small, r, svc_a,
                             session=sv.ServeSession(control=cfg))
                for k, r in rates.items()}
        return r_st, s_st, r_dy, s_dy, swapped, runs

    jds = j_scenario("app-class", "zipf", **kw)
    jpipes = {}
    for tag, (names, depth) in (("a", d.REP_A), ("b", d.REP_B)):
        jf, _ = j_train(np.asarray(j_extract(jds, names, depth)), jds.label,
                        model="tree-fast", seed=0)
        jpipes[tag] = j_build(JRep(names, depth), jf, depth, use_kernel=False)

    def j_fleet_of(pipe, shards=4, capacity=2048):
        return lambda execute=False: jserve.ShardedRuntime(
            pipe, n_shards=shards, capacity=capacity, max_batch=64,
            execute=execute)

    want = acts(jserve, jds, jpipes, j_fleet_of)

    ds, stream, reps, forests, pipe_a = d.deployment("cpu", **kw)
    svc_a, svc_b = d.ServiceModel(**d.SVC_A), d.ServiceModel(**d.SVC_B)
    make = d.fleet_of(pipe_a)
    r_st, s_st, r_dy, s_dy = d.rebalance(stream, make, svc_a, iters=6,
                                         ring=max(64, stream.n_events // 16))
    pipe_b = d.build_pipeline(reps["b"], forests["b"], max_pkts=reps["b"].depth,
                              fused=True, device="cpu")
    swap = d.PipelineSwap(pipe_b, svc_b, after_pkts=stream.n_events // 2)
    swapped, post, agree = d.hot_swap(
        ds, stream, make, swap, svc_a, stream.base_pps,
        lambda: d.StreamingRuntime(pipe_b, capacity=2048, max_batch=64))
    runs = d.elastic(stream, lambda: d.fleet_of(pipe_a, shards=2,
                                                capacity=4096)(), svc_a, rates)

    jr_st, js_st, jr_dy, js_dy, jswapped, jruns = want
    assert (r_st, r_dy) == (jr_st, jr_dy)
    for got, ref in ((s_st, js_st), (s_dy, js_dy), (swapped, jswapped),
                     *((runs[k], jruns[k]) for k in rates)):
        assert got.drops == ref.drops
        assert got.load_imbalance == ref.load_imbalance
        assert got.control == ref.control
    assert s_st.drops == s_dy.drops == swapped.drops == 0
    assert swapped.control["swaps"] == 1
    assert len(swapped.predictions) == ds.n_flows
    assert swapped.metrics.duplicate_predictions == 0
    assert agree == len(post) > 0
    assert runs["hot"].control["workers_added"] > 0
    assert runs["cold"].control["workers_retired"] > 0


def test_selftune_fleet():
    """The drive's steps on the CPU at the reference example's size pass
    its own checks (one episode, 0 drops, every flow once, the re-tuned
    F1 above the frozen one); its stale forest is the reference trainer's
    (thresholds to 1e-6 relative: the trainer's quantile edges come from
    columns equal to float32 rounding), and its frozen arm replays as the
    reference's: drops and control summary equal, predictions on all but
    1% of flows."""
    from repro.core import FeatureRep as JRep
    from repro.traffic.synth import make_scenario_dataset as j_scenario

    d = drive("selftune_fleet")
    ds, stream, first_pkt, pre, stale = d.deployment("cpu")
    service = d.ServiceModel(**d.SERVICE)
    frozen = d.frozen_arm(stream, stale, service)
    triggers = []
    tuned, session = d.tuned_arm(ds, stream, stale, service,
                                 on_trigger=triggers.append)
    episodes = session.resolve_audit().of_kind("reopt")
    _, (f1_frozen, f1_tuned) = d.post_drift_f1(ds, stream, first_pkt, frozen,
                                               tuned)
    d.check(ds, frozen, tuned, episodes, f1_frozen, f1_tuned)
    assert [t["device"] for t in triggers] == ["cpu"]

    jds = j_scenario("app-class", "drift", n_flows=600, max_pkts=32, seed=3)
    rep = JRep(d.REP_FEATURES, depth=8)
    X = np.asarray(j_extract(jds, rep.features, rep.depth))
    jf, _ = j_train(X[pre], jds.label[pre], model="tree-fast", seed=0)
    forest = stale.pipeline.forest
    np.testing.assert_array_equal(forest.feature, jf.feature)
    np.testing.assert_array_equal(forest.leaf, jf.leaf)
    np.testing.assert_allclose(forest.threshold, jf.threshold, rtol=1e-6)
    jpipe = j_build(rep, jf, max_pkts=8, use_kernel=False)
    jstream = jserve.PacketStream.from_dataset(jds, seed=0)
    jfrozen = jserve.replay(
        jstream, lambda: jserve.ShardedRuntime(jpipe, n_shards=2,
                                               capacity=2048, max_batch=16,
                                               execute=True),
        d.OFFERED_PPS, jserve.ServiceModel(**d.SERVICE),
        session=jserve.ServeSession(control=jserve.ControlConfig(
            interval_pkts=256, rebalance=False)))
    assert (frozen.drops, frozen.control) == (jfrozen.drops, jfrozen.control)
    assert set(frozen.predictions) == set(jfrozen.predictions)
    differ = sum(int(frozen.predictions[k] != jfrozen.predictions[k])
                 for k in frozen.predictions)
    assert differ <= 0.01 * ds.n_flows


def test_serve_control_post_swap_flows_start_at_the_swap():
    """The swap executes at the first control step at or after its packet:
    at 300 flows of up to 128 packets that step (5632) lies past the armed
    packet (5186), and flows first seen in between start on the old
    pipeline. The hot-swap act holds to the new pipeline's own replay only
    the flows first seen at or after the executed swap (all of them
    agree); counting from the armed packet took in the flows between."""
    d = drive("serve_control")
    ds, stream, reps, forests, pipe_a = d.deployment("cpu", n_flows=300,
                                                      max_pkts=128)
    make = d.fleet_of(pipe_a)
    pipe_b = d.build_pipeline(reps["b"], forests["b"], max_pkts=reps["b"].depth,
                              fused=True, device="cpu")
    swap = d.PipelineSwap(pipe_b, d.ServiceModel(**d.SVC_B),
                          after_pkts=stream.n_events // 2)
    swapped, post, agree = d.hot_swap(
        ds, stream, make, swap, d.ServiceModel(**d.SVC_A), stream.base_pps,
        lambda: d.fleet_of(pipe_b)(True))
    at = swapped.control["swap_at_pkts"]
    first = np.full(ds.n_flows, stream.n_events)
    np.minimum.at(first, stream.fid, np.arange(stream.n_events))
    between = np.flatnonzero((first >= swap.after_pkts) & (first < at))
    assert (swap.after_pkts, at) == (5186, 5632) and len(between) > 0
    assert agree == len(post) > 0
    assert not set(between) & set(post)


def test_train_lm():
    """The drive at the example's size (reduced qwen3-8b, 40 steps, batch
    8, sequence 64, lr 3e-3, a checkpoint every 20 steps) with `--device
    cpu`, next to the reference's `examples/train_lm.py` main: both losses
    fall (each main asserts it) and the first losses agree to 2% (the
    weights differ: torch's generator draws the port's, jax.random the
    reference's, from the same distributions and seed 0; measured 0.9%)."""
    spec = importlib.util.spec_from_file_location(
        "ref_train_lm", ROOT / "examples" / "train_lm.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    from repro.launch import train as jtrain

    seen = {}
    real = jtrain.main

    def spy(argv=None):
        seen["losses"] = real(argv)
        return seen["losses"]

    ref.train_main = spy
    ref.main()
    losses = drive("train_lm").main(["--device", "cpu"])
    assert len(losses) == len(seen["losses"]) == 40
    assert losses[-1] < losses[0] and seen["losses"][-1] < seen["losses"][0]
    np.testing.assert_allclose(losses[0], seen["losses"][0], rtol=2e-2)
