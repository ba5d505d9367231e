"""The port's baselines (`repro_torch.core.baselines`) against
`repro.core.baselines`, draw for draw: the search baselines and the feature
selectors on the reference tests' own cases, then the paper's Fig. 5c as
`chip_smoke.py` measures it (`fig5_replayed`) against
`benchmarks/fig5_serving_perf.py:run_replayed` at a small size on the CPU,
under the modeled clock, where both packages' replays are exact."""
import importlib.util
import pathlib

import numpy as np
import pytest

import repro.core as jcore
from repro.core import baselines as jbase
from repro.traffic import MINI_FEATURE_NAMES as J_MINI
from repro.traffic import TrafficProfiler as JProfiler
from repro.traffic import extract_features as j_extract
from repro.traffic import make_dataset as j_make

import repro_torch.core as pcore
from repro_torch.core import baselines as pbase
from repro_torch.traffic import MINI_FEATURE_NAMES, TrafficProfiler
from repro_torch.traffic.extraction import extract_features
from repro_torch.traffic.synth import make_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]

# tests/test_optimizer_bo.py's toy problem
NAMES = tuple(f"f{i}" for i in range(6))
VALUE = np.array([0.6, 0.35, 0.15, 0.05, 0.0, 0.0])
COST = np.array([1.0, 6.0, 0.3, 3.0, 10.0, 0.5])


def profiler(x):
    idx = [NAMES.index(f) for f in x.features]
    perf = 1 - np.exp(-VALUE[idx].sum() * (1 + 0.5 * min(x.depth, 6) / 6))
    cost = COST[idx].sum() * (1 + 0.08 * x.depth)
    return cost, perf


def _trace(res):
    return [(o.x.key(), o.cost, o.perf, o.iteration, o.fidelity)
            for o in res.observations]


def _both(run):
    """`run(core, baselines)` on the port and on the reference."""
    return run(pcore, pbase), run(jcore, jbase)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_search_matches_reference(seed):
    """test_bo_beats_random_at_equal_budget's random arm: 30 draws."""
    got, want = _both(lambda core, b: b.run_random_search(
        core.SearchSpace(NAMES, max_depth=20), profiler, 30, seed=seed))
    assert _trace(got) == _trace(want)


@pytest.mark.parametrize("algo", ["random", "iterate_all", "annealing"])
def test_search_algorithms_match_reference(algo):
    """test_all_search_algorithms_return_valid_results on both packages:
    the same observations, and the reference test's own checks."""
    def run(core, b):
        space = core.SearchSpace(NAMES, max_depth=20)
        if algo == "random":
            return b.run_random_search(space, profiler, 10, seed=1)
        if algo == "iterate_all":
            return b.run_iterate_all(space, profiler, 10)
        return b.run_simulated_annealing(space, profiler, 10, seed=1)

    got, want = _both(run)
    assert _trace(got) == _trace(want)
    assert len(got.observations) == 10
    front = got.pareto_points()
    np.testing.assert_array_equal(front, want.pareto_points())
    assert front.shape[1] == 2
    assert (np.diff(front[:, 0]) >= 0).all()
    assert (np.diff(front[:, 1]) >= 0).all()


def test_point_selectors_match_reference():
    """test_point_selectors: the same FeatureReps from ALL, MI-top-k and
    RFE on the same seeded columns, and the reference test's checks."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 800)
    X = np.stack([y * VALUE[i] * 3 + rng.normal(0, 1, 800) for i in range(6)], 1)
    got, want = _both(lambda core, b: (
        b.select_all(core.SearchSpace(NAMES, max_depth=20), 10),
        b.select_mi_topk(core.SearchSpace(NAMES, max_depth=20), 10, X, y, k=2),
        b.select_rfe_topk(core.SearchSpace(NAMES, max_depth=20), 10, X, y, k=3)))
    assert [r.key() for r in got] == [r.key() for r in want]
    sel_all, mi, rfe = got
    assert len(sel_all.features) == 6
    assert len(mi.features) == 2 and "f0" in mi.features
    assert len(rfe.features) == 3


def test_rfe_elimination_order_matches_reference():
    """RFE down to k of 12 seeded columns, for k 5, 3 and 1: the same
    survivors as the reference, so every elimination step agreed."""
    rng = np.random.default_rng(7)
    names = tuple(f"g{i}" for i in range(12))
    y = rng.integers(0, 3, 400)
    X = np.stack([y * rng.random() + rng.normal(0, 1, 400)
                  for _ in names], 1).astype(np.float32)
    for k in (5, 3, 1):
        got, want = _both(lambda core, b: b.select_rfe_topk(
            core.SearchSpace(names, max_depth=8), 4, X, y, k=k, seed=k))
        assert got.key() == want.key()


@pytest.fixture(scope="module")
def mini():
    """tests/test_multi_fidelity.py's `mini_profiler`, on both sides."""
    kw = dict(n_flows=300, max_pkts=12, seed=0)
    prof_kw = dict(model="tree-fast", cost_metric="exec_time",
                   cost_mode="modeled", seed=0)
    return (TrafficProfiler(make_dataset("iot-class", **kw),
                            MINI_FEATURE_NAMES, device="cpu", **prof_kw),
            JProfiler(j_make("iot-class", **kw), J_MINI, **prof_kw))


def test_memoized_iterate_all_matches_reference(mini):
    """test_memoization_is_bit_identical_across_algorithms on both packages:
    ITERATEALL twice through one memoized evaluator."""
    out = []
    for core, b, prof, names in ((pcore, pbase, mini[0], MINI_FEATURE_NAMES),
                                 (jcore, jbase, mini[1], J_MINI)):
        space = core.SearchSpace(names, max_depth=12)
        ev = core.MemoizedEvaluator(prof)
        res_a = b.run_iterate_all(space, ev, 6)
        res_b = b.run_iterate_all(space, ev, 6)
        assert _trace(res_a) == _trace(res_b)
        r1, _ = ev.profile(res_a.observations[0].x)
        r2, _ = ev.profile(res_a.observations[0].x)
        assert r1 is r2
        assert ev.n_calls[ev.measured] == 6
        out.append((_trace(res_a), dict(ev.n_calls), dict(ev.n_hits)))
    assert out[0] == out[1]


def test_cato_against_all_at_10_matches_reference():
    """test_cato_dominates_fixed_depth_all_features on both packages: the
    same search, ALL@10 scored the same, and the reference's claim."""
    kw = dict(n_flows=1200, max_pkts=64, seed=5)
    prof_kw = dict(model="rf-fast", cost_metric="exec_time",
                   cost_mode="modeled", seed=0)
    side = {}
    for tag, core, b, prof, names in (
            ("port", pcore, pbase,
             TrafficProfiler(make_dataset("iot-class", **kw),
                             MINI_FEATURE_NAMES, device="cpu", **prof_kw),
             MINI_FEATURE_NAMES),
            ("ref", jcore, jbase,
             JProfiler(j_make("iot-class", **kw), J_MINI, **prof_kw),
             J_MINI)):
        space = core.SearchSpace(names, max_depth=24)
        ds = prof.dataset
        X = (extract_features(ds, names, 24, device="cpu") if tag == "port"
             else np.asarray(j_extract(ds, names, 24)))
        res = core.CatoOptimizer(space, prof, core.build_priors(
            space, X, ds.label), seed=0).run(25)
        base = prof(b.select_all(space, 10))
        side[tag] = (res, base)
    (res, base), (jres, jbase_r) = side["port"], side["ref"]
    assert _trace(res) == _trace(jres)
    assert (base.cost, base.perf) == (jbase_r.cost, jbase_r.perf)
    front = res.pareto_observations()
    assert len(front) >= 2
    assert any(o.cost <= base.cost * 1.05 and o.perf >= base.perf - 0.06
               for o in front)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fig5_replayed_matches_reference(monkeypatch):
    """chip_smoke.py's Fig. 5c phase at a small size on the CPU under the
    modeled clock against the benchmark it ports: the same methods,
    depths, |F|, F1s, zero-loss rates and drops; p50 and p99 to 1e-6."""
    from benchmarks import fig5_serving_perf as jfig5

    monkeypatch.setattr(jfig5, "emit", lambda *a, **k: None)
    kw = dict(use_case="app", iters=6, n_flows=300, max_pkts=24, depths=(10,),
              bisect_iters=4, cost_mode="modeled", model="tree-fast", seed=1)
    cs = _chip_smoke()
    assert cs.FIG5_HEADER == jfig5.REPLAYED_HEADER
    got, _ = cs.fig5_replayed("cpu", **kw)
    want = [tuple(r) for r in jfig5.run_replayed(verbose=False, **kw)]
    assert len(got) == len(want) and any(r[0] == "CATO" for r in got)
    h = jfig5.REPLAYED_HEADER
    loose = {h.index("p50_s"), h.index("p99_s")}
    for g, w in zip(got, want):
        assert len(g) == len(h)
        assert [v for i, v in enumerate(g) if i not in loose] == \
            [v for i, v in enumerate(w) if i not in loose], (g, w)
        np.testing.assert_allclose([g[i] for i in sorted(loose)],
                                   [w[i] for i in sorted(loose)], rtol=1e-6)
    assert cs.fig5_summarize(got) == jfig5.summarize(want)
