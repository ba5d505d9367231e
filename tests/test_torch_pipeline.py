"""The port's `build_pipeline`, two-launch and one-launch, against
`repro.traffic.pipeline.build_pipeline` on the 257-flow fixture."""
import numpy as np
import pytest
import torch

from repro.core.search_space import FeatureRep as JFeatureRep
from repro.traffic import extraction as jext
from repro.traffic import synth as jsynth
from repro.traffic.models import train_traffic_model as j_train
from repro.traffic.pipeline import build_pipeline as j_build

from _torch_parity import PROB_ATOL, assert_straddle_parity
from repro_torch.convert import forest_from_numpy
from repro_torch.core.search_space import FeatureRep
from repro_torch.traffic.extraction import extract_features
from repro_torch.traffic.features import FEATURE_NAMES
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_dataset

REPS = {
    "all67-d10": (tuple(FEATURE_NAMES), 10, "rf-fast"),
    "mixed-d8": (("dur", "s_load", "s_bytes_mean", "d_iat_std", "ack_cnt",
                  "s_winsize_med", "tcp_rtt"), 8, "rf"),
}


@pytest.fixture(scope="module", params=sorted(REPS))
def case(request):
    names, depth, model = REPS[request.param]
    kw = dict(n_flows=257, max_pkts=16, seed=11)
    ds, jds = make_dataset("app-class", **kw), jsynth.make_dataset("app-class", **kw)
    jrep = JFeatureRep(names, depth)
    xj = jext.extract_features(jds, jrep.features, depth)
    jf, _ = j_train(xj, jds.label, model=model, seed=0)
    want = {fused: j_build(jrep, jf, jds.max_pkts, use_kernel=True, fused=fused)
            for fused in (False, True)}
    want = {k: (p.probabilities(jds), p(jds)) for k, p in want.items()}
    rep = FeatureRep(names, depth)
    tf = forest_from_numpy(jf.feature, jf.threshold, jf.leaf, jf.depth,
                           jf.n_features, jf.classes)
    return ds, rep, tf, xj, want


@pytest.mark.parametrize("fused", [False, True])
def test_pipeline_matches_reference(case, fused):
    ds, rep, tf, xj, want = case
    pipe = build_pipeline(rep, tf, ds.max_pkts, fused=fused, device="cpu")
    assert pipe.fused == fused and pipe.device.type == "cpu"
    xt = extract_features(ds, rep.features, rep.depth, device="cpu")
    got = pipe.probabilities(ds)
    for jfused in (False, True):
        p_ref, cls_ref = want[jfused]
        n = assert_straddle_parity(p_ref, got, xj, xt, tf)
        cls = pipe(ds)
        assert cls.dtype == cls_ref.dtype
        if n == 0:
            np.testing.assert_array_equal(cls, cls_ref)


def test_fused_and_unfused_agree_on_every_flow(case):
    ds, rep, tf, _, _ = case
    kw = dict(device="cpu")
    pu = build_pipeline(rep, tf, ds.max_pkts, fused=False, **kw)
    pf = build_pipeline(rep, tf, ds.max_pkts, fused=True, **kw)
    ref = build_pipeline(rep, tf, ds.max_pkts, use_kernel=False, **kw)
    a, b, c = pu.probabilities(ds), pf.probabilities(ds), ref.probabilities(ds)
    np.testing.assert_allclose(b, a, rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(c, a, rtol=0, atol=PROB_ATOL)
    np.testing.assert_array_equal(pu(ds), pf(ds))
    # an async submission resolves like a direct call, and on a batch of one
    sub = ds.take(np.arange(1))
    np.testing.assert_array_equal(pf.finalize(pf.predict_async(sub)), pu(sub))


def test_warm_and_class_mapping(case):
    ds, rep, tf, _, _ = case
    pipe = build_pipeline(rep, tf, ds.max_pkts, fused=True, device="cpu")
    pipe.warm([1, 2, 4])
    probs = torch.zeros((3, tf.n_out))
    probs[0, 2] = probs[0, 4] = 0.5          # a tie takes the first class
    probs[1, -1] = 1.0
    np.testing.assert_array_equal(pipe.finalize(probs),
                                  tf.classes[[2, tf.n_out - 1, 0]])
