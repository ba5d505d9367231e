"""The port's numpy copies draw the reference's arrays from the same seed:
datasets, the feature registry, stats plans and trained forests."""
import dataclasses

import numpy as np
import pytest

import repro.core.forest as jforest
import repro.traffic.extraction as jext
import repro.traffic.models as jmodels
import repro.traffic.synth as jsynth
from repro.core.search_space import FeatureRep as JFeatureRep
from repro.traffic.features import FEATURE_NAMES as J_FEATURE_NAMES

import repro_torch.core.forest as tforest
import repro_torch.traffic.extraction as text
import repro_torch.traffic.models as tmodels
import repro_torch.traffic.synth as tsynth
from repro_torch.core.search_space import FeatureRep
from repro_torch.traffic.features import FEATURE_NAMES


def _assert_same_dataset(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("use_case,n,P,seed", [
    ("app-class", 257, 16, 11), ("iot-class", 300, 64, 0)])
def test_make_dataset_identical(use_case, n, P, seed):
    _assert_same_dataset(
        jsynth.make_dataset(use_case, n_flows=n, max_pkts=P, seed=seed),
        tsynth.make_dataset(use_case, n_flows=n, max_pkts=P, seed=seed))


@pytest.mark.parametrize("scenario", ["zipf", "drift"])
def test_scenario_dataset_identical(scenario):
    kw = dict(n_flows=200, max_pkts=32, seed=5)
    _assert_same_dataset(
        jsynth.make_scenario_dataset("iot-class", scenario, **kw),
        tsynth.make_scenario_dataset("iot-class", scenario, **kw))
    R1, R2 = np.random.default_rng(9), np.random.default_rng(9)
    np.testing.assert_array_equal(
        jsynth.scenario_flow_starts(R1, 300, 0.01, "burst"),
        tsynth.scenario_flow_starts(R2, 300, 0.01, "burst"))


def test_registry_and_plans_identical():
    assert tuple(FEATURE_NAMES) == tuple(J_FEATURE_NAMES)
    assert len(FEATURE_NAMES) == 67
    assert text.stats_plan(FEATURE_NAMES) == jext.stats_plan(J_FEATURE_NAMES)
    for names in (FEATURE_NAMES, ("dur", "s_bytes_mean"), ("d_iat_med",)):
        plan = text.stats_plan(names)
        assert text.plan_is_incremental(plan) == jext.plan_is_incremental(plan)
    np.testing.assert_array_equal(text.agg_init(), jext.agg_init())
    assert text.AGG_WIDTH == jext.AGG_WIDTH
    rep, jrep = FeatureRep(("s_load", "dur"), 7), JFeatureRep(("s_load", "dur"), 7)
    assert rep.key() == jrep.key()


def _assert_same_forest(a, b):
    for name in ("feature", "threshold", "leaf"):
        va, vb = getattr(a, name), getattr(b, name)
        assert va.dtype == vb.dtype, name
        np.testing.assert_array_equal(va, vb, err_msg=name)
    assert (a.depth, a.n_features) == (b.depth, b.n_features)
    if a.classes is None:
        assert b.classes is None
    else:
        np.testing.assert_array_equal(a.classes, b.classes)


@pytest.mark.parametrize("max_features,bootstrap", [("sqrt", True), (None, False)])
def test_train_forest_identical(max_features, bootstrap):
    R = np.random.default_rng(4)
    X = R.standard_normal((300, 9)).astype(np.float32)
    y = R.integers(0, 5, 300)
    kw = dict(n_trees=6, max_depth=5, max_features=max_features,
              bootstrap=bootstrap)
    _assert_same_forest(
        jforest.train_forest(X, y, rng=np.random.default_rng(2), **kw),
        tforest.train_forest(X, y, rng=np.random.default_rng(2), **kw))


@pytest.mark.parametrize("model", ["rf-fast", "tree"])
def test_train_traffic_model_identical(model):
    ds = tsynth.make_dataset("app-class", n_flows=257, max_pkts=16, seed=11)
    X = text.extract_features(ds, ("dur", "s_bytes_mean", "d_iat_std",
                                   "s_pkt_cnt"), 8, device="cpu")
    jf, jf1 = jmodels.train_traffic_model(X, ds.label, model=model, seed=0)
    tf, tf1 = tmodels.train_traffic_model(X, ds.label, model=model, seed=0)
    _assert_same_forest(jf, tf)
    assert jf1 == tf1
    pred = tforest.forest_predict_class(tf, X)
    np.testing.assert_array_equal(pred, jforest.forest_predict_class(jf, X))
    assert tmodels.macro_f1(ds.label, pred) == jmodels.macro_f1(ds.label, pred)
