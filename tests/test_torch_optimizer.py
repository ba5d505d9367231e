"""The port's copies of CATO's optimizer (`repro_torch.core`) against
`repro.core`: the Pareto utilities, the acquisition, the priors, the
surrogate and the optimizer's draw-for-draw sequence.

The optimizer's sequence is the pin of `tests/test_multi_fidelity.py`
(`CatoOptimizer(space, profile, priors, seed=3, batch_size=1).run(18)`)
applied across packages: with the same seeds and the same evaluations, the
port must propose, in order, the configurations the reference proposes.
"""
import numpy as np
import pytest

import repro.core as jcore
from repro.core import acquisition as jacq
from repro.core import forest as jforest
from repro.core import pareto as jpareto
from repro.core.mutual_info import mi_scores as j_mi
from repro.traffic import MINI_FEATURE_NAMES as J_MINI
from repro.traffic import TrafficProfiler as JProfiler
from repro.traffic import backend_suite as j_suite
from repro.traffic import make_dataset as j_make

import repro_torch.core as pcore
from repro_torch.core import acquisition as pacq
from repro_torch.core import forest as pforest
from repro_torch.core import pareto as ppareto
from repro_torch.core.mutual_info import mi_scores as p_mi
from repro_torch.traffic import MINI_FEATURE_NAMES, TrafficProfiler, backend_suite
from repro_torch.traffic.synth import make_dataset

NAMES = tuple(f"f{i}" for i in range(6))
VALUE = np.array([0.6, 0.35, 0.15, 0.05, 0.0, 0.0])
COST = np.array([1.0, 6.0, 0.3, 3.0, 10.0, 0.5])


def expensive(x):
    """The toy objective of the reference's sequential pin."""
    idx = [NAMES.index(f) for f in x.features]
    perf = 1 - np.exp(-VALUE[idx].sum() * (1 + 0.5 * min(x.depth, 6) / 6))
    cost = COST[idx].sum() * (1 + 0.08 * x.depth)
    return cost, perf


def cheap(x):
    c, p = expensive(x)
    return 0.9 * c + 0.2, 0.95 * p


def _toy_xy():
    rng = np.random.default_rng(42)
    y = rng.integers(0, 2, 1500)
    X = np.stack(
        [y * VALUE[i] * 3 + rng.normal(0, 1, 1500) for i in range(6)], 1)
    return X, y


def _trace(res):
    return [(o.x.key(), o.cost, o.perf, o.iteration, o.fidelity)
            for o in res.observations]


# ---------------------------------------------------------------------------
# building blocks on seeded inputs
# ---------------------------------------------------------------------------

def test_pareto_utilities_match_reference():
    rng = np.random.default_rng(0)
    for n in (1, 7, 64):
        Y = rng.random((n, 2))
        Y[rng.integers(n, size=n // 3)] = Y[0]      # ties
        np.testing.assert_array_equal(ppareto.pareto_mask(Y),
                                      jpareto.pareto_mask(Y))
        np.testing.assert_array_equal(ppareto.pareto_front(Y),
                                      jpareto.pareto_front(Y))
        assert ppareto.knee_index(Y) == jpareto.knee_index(Y)
        assert ppareto.hypervolume_2d(Y, (1.5, 1.5)) == \
            jpareto.hypervolume_2d(Y, (1.5, 1.5))
        for a, b in zip(ppareto.normalize_objectives(Y),
                        jpareto.normalize_objectives(Y)):
            np.testing.assert_array_equal(a, b)
    Y2 = rng.random((20, 2))
    assert ppareto.hvi_ratio(Y[:10], Y2) == jpareto.hvi_ratio(Y[:10], Y2)


def test_acquisition_matches_reference():
    rng = np.random.default_rng(7)
    post = rng.random((16, 40, 2))
    front = np.array([[0.2, 0.8], [0.5, 0.4], [0.9, 0.1]])
    np.testing.assert_array_equal(pacq.ehvi(post, front),
                                  jacq.ehvi(post, front))
    assert pacq.qehvi_greedy(post, front, 5) == jacq.qehvi_greedy(post, front, 5)
    Yn = rng.random((12, 2))
    np.testing.assert_array_equal(pacq.scalarized_ei(post, Yn, 0.3),
                                  jacq.scalarized_ei(post, Yn, 0.3))
    lp = rng.normal(size=40)
    np.testing.assert_array_equal(pacq.apply_pibo(pacq.ehvi(post, front), lp,
                                                  4, 3.0),
                                  jacq.apply_pibo(jacq.ehvi(post, front), lp,
                                                  4, 3.0))


def test_priors_and_mutual_information_match_reference():
    X, y = _toy_xy()
    np.testing.assert_array_equal(p_mi(X, y, seed=0), j_mi(X, y, seed=0))
    got = pcore.build_priors(pcore.SearchSpace(NAMES, max_depth=20), X, y)
    want = jcore.build_priors(jcore.SearchSpace(NAMES, max_depth=20), X, y)
    np.testing.assert_array_equal(got.feature_probs, want.feature_probs)
    np.testing.assert_array_equal(got.depth_pmf, want.depth_pmf)
    np.testing.assert_array_equal(got.mi, want.mi)


def test_surrogate_helpers_match_reference():
    rng = np.random.default_rng(5)
    X = rng.random((200, 5)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 3] + rng.normal(0, 0.1, 200)).astype(np.float32)
    got = pforest.train_tree(X, y, max_depth=5, classification=False,
                             rng=np.random.default_rng(1))
    want = jforest.train_tree(X, y, max_depth=5, classification=False,
                              rng=np.random.default_rng(1))
    for a in ("feature", "threshold", "leaf"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    np.testing.assert_array_equal(pforest.forest_predict_value(got, X),
                                  jforest.forest_predict_value(want, X))
    np.testing.assert_array_equal(pforest.forest_predict_per_tree(got, X),
                                  jforest.forest_predict_per_tree(want, X))
    sp, sj = pcore.RFSurrogate(seed=2), jcore.RFSurrogate(seed=2)
    Y = np.stack([y, -y], 1)
    sp.fit(X, Y)
    sj.fit(X, Y)
    np.testing.assert_array_equal(sp.posterior_samples(X[:30]),
                                  sj.posterior_samples(X[:30]))


# ---------------------------------------------------------------------------
# the optimizer, draw for draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_priors", [True, False])
def test_sequential_pin_matches_reference(use_priors):
    X, y = _toy_xy()
    sp, sj = pcore.SearchSpace(NAMES, max_depth=20), jcore.SearchSpace(
        NAMES, max_depth=20)
    pp = pcore.build_priors(sp, X, y) if use_priors else None
    pj = jcore.build_priors(sj, X, y) if use_priors else None
    got = pcore.CatoOptimizer(sp, expensive, pp, seed=3, batch_size=1).run(18)
    want = jcore.CatoOptimizer(sj, expensive, pj, seed=3, batch_size=1).run(18)
    assert _trace(got) == _trace(want)
    assert len(got.observations) == 18


def test_batched_multi_fidelity_matches_reference():
    X, y = _toy_xy()
    sp, sj = pcore.SearchSpace(NAMES, max_depth=20), jcore.SearchSpace(
        NAMES, max_depth=20)
    fid = {"modeled": cheap, "measured": expensive}
    got = pcore.CatoOptimizer(sp, pcore.MemoizedEvaluator(fid),
                              pcore.build_priors(sp, X, y), seed=0,
                              batch_size=4).run_multi_fidelity(measure_budget=6)
    want = jcore.CatoOptimizer(sj, jcore.MemoizedEvaluator(fid),
                               jcore.build_priors(sj, X, y), seed=0,
                               batch_size=4).run_multi_fidelity(measure_budget=6)
    assert _trace(got) == _trace(want)
    assert got.fidelity_counts == want.fidelity_counts
    assert got.measured_fidelity == want.measured_fidelity == "measured"


@pytest.fixture(scope="module")
def mini():
    """The reference's `mini_profiler` fixture, on both sides."""
    kw = dict(n_flows=300, max_pkts=12, seed=0)
    prof_kw = dict(model="tree-fast", cost_metric="exec_time",
                   cost_mode="modeled", seed=0)
    return (TrafficProfiler(make_dataset("iot-class", **kw),
                            MINI_FEATURE_NAMES, device="cpu", **prof_kw),
            JProfiler(j_make("iot-class", **kw), J_MINI, **prof_kw))


def test_profiled_pin_matches_reference(mini):
    port, ref = mini
    got = pcore.CatoOptimizer(pcore.SearchSpace(MINI_FEATURE_NAMES,
                                                max_depth=12),
                              port, seed=3, batch_size=1).run(18)
    want = jcore.CatoOptimizer(jcore.SearchSpace(J_MINI, max_depth=12),
                               ref, seed=3, batch_size=1).run(18)
    assert _trace(got) == _trace(want)


def test_multi_fidelity_over_backends_matches_reference(mini):
    """Cheap: the modeled drain rate; measured: the replayed zero-loss rate
    under the modeled service constants, whose replay clock the port
    computes exactly as the reference does."""
    port, ref = mini
    res = []
    for core, prof, suite, names in ((pcore, port, backend_suite, MINI_FEATURE_NAMES),
                                     (jcore, ref, j_suite, J_MINI)):
        ev = core.MemoizedEvaluator(suite(prof, ("modeled", "replayed")))
        opt = core.CatoOptimizer(core.SearchSpace(names, max_depth=12), ev,
                                 seed=1, batch_size=3)
        res.append(opt.run_multi_fidelity(measure_budget=3, max_rounds=4))
    got, want = res
    assert got.fidelity_counts == want.fidelity_counts
    assert got.fidelity_counts.get("replayed", 0) > 0
    assert _trace(got) == _trace(want)
    assert ([o.x.key() for o in got.pareto_observations()]
            == [o.x.key() for o in want.pareto_observations()])
