"""The port's LM serving-config tuner (`repro_torch.core.tuner`) against
`repro.core.tuner`: tests/test_collectives_tuner.py's cases on both
packages. The port's roofline constants are the H100's; for parity each
tuner instance is given the reference class's constants, read here."""
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import tuner as jtuner

from repro_torch import configs
from repro_torch.core import tuner as ptuner


def _tuner(mod, cfg):
    t = mod.PipelineTuner(cfg, chips=256)
    ref = jtuner.PipelineTuner
    t.PEAK, t.HBM, t.LINK = ref.PEAK, ref.HBM, ref.LINK
    return t


def _front(res):
    return [(o.x.key(), o.cost, o.perf) for o in res.pareto_observations()]


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-1.2b"])
def test_tuner_front_matches_reference(arch):
    """test_tuner_finds_tradeoff_front: the same observations and Pareto
    configurations, costs and perfs to 1e-12, and the reference's checks."""
    got = _tuner(ptuner, configs.get(arch))
    want = _tuner(jtuner, jconfigs.get(arch))
    res, jres = got.tune(25, seed=0), want.tune(25, seed=0)
    assert [o.x.key() for o in res.observations] == \
        [o.x.key() for o in jres.observations]
    front, jfront = _front(res), _front(jres)
    assert [k for k, _, _ in front] == [k for k, _, _ in jfront]
    np.testing.assert_allclose([c for _, c, _ in front],
                               [c for _, c, _ in jfront], rtol=1e-12)
    np.testing.assert_allclose([p for _, _, p in front],
                               [p for _, _, p in jfront], rtol=1e-12)
    if arch == "qwen3-8b":
        fo = res.pareto_observations()
        assert len(fo) >= 2
        best_q = max(fo, key=lambda o: o.perf)
        assert best_q.x.window == 32768 and best_q.perf >= 0.97
        cheapest = min(fo, key=lambda o: o.cost)
        assert cheapest.x.window < 32768 or cheapest.x.kv_dtype == "int8"
    for kv in ("bf16", "int8"):
        x = ptuner.ServingConfig(kv_dtype=kv, window=32768)
        jx = jtuner.ServingConfig(kv_dtype=kv, window=32768)
        np.testing.assert_allclose(got.profile(x), want.profile(jx), rtol=1e-12)
    c_bf = got.profile(ptuner.ServingConfig(kv_dtype="bf16", window=32768))[0]
    c_i8 = got.profile(ptuner.ServingConfig(kv_dtype="int8", window=32768))[0]
    assert c_i8 <= c_bf


def test_config_space_matches_reference():
    """test_config_space_protocol on both packages: the same draws,
    encodings, mutations and prior log-densities."""
    sp, jsp = ptuner.ConfigSpace(), jtuner.ConfigSpace()
    xs = sp.sample_uniform(np.random.default_rng(0), 20)
    jxs = jsp.sample_uniform(np.random.default_rng(0), 20)
    assert [x.key() for x in xs] == [x.key() for x in jxs]
    assert len({x.key() for x in xs}) > 5
    pri, jpri = ptuner.ConfigPriors(sp), jtuner.ConfigPriors(jsp)
    rng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    for x, jx in zip(xs, jxs):
        v = sp.encode(x)
        assert v.shape == (5,)
        np.testing.assert_array_equal(v, jsp.encode(jx))
        assert pri.pi_log(sp, x) == jpri.pi_log(jsp, jx)
        assert sp.mutate(rng, x).key() == jsp.mutate(jrng, jx).key()


def test_port_constants_are_the_h100s():
    """The port's own roofline constants: H100 SXM dense bf16, HBM3 and one
    direction of NVLink 4; none of them is the reference's."""
    P, J = ptuner.PipelineTuner, jtuner.PipelineTuner
    assert (P.PEAK, P.HBM, P.LINK) == (989e12, 3.35e12, 450e9)
    assert not {P.PEAK, P.HBM, P.LINK} & {J.PEAK, J.HBM, J.LINK}
