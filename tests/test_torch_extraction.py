"""The port's torch extraction against `repro.traffic.extraction`: all 67
registry features, at the connection depths the reference tests use."""
import numpy as np
import pytest

from repro.traffic import extraction as jext
from repro.traffic import synth as jsynth

from repro_torch.traffic.extraction import extract_features
from repro_torch.traffic.features import FEATURE_NAMES
from repro_torch.traffic.synth import make_dataset

# columns that are a count, the protocol, a port, or a min or max of one
# field: no rounding happens in them, so they must be equal
EXACT = [i for i, n in enumerate(FEATURE_NAMES)
         if n.endswith(("_cnt", "_min", "_max")) or n in ("proto", "s_port", "d_port")]


@pytest.fixture(scope="module")
def app():
    return make_dataset("app-class", n_flows=257, max_pkts=16, seed=11)


@pytest.fixture(scope="module")
def iot():
    return make_dataset("iot-class", n_flows=600, max_pkts=64, seed=11)


def _check(ds, jds, depth):
    want = jext.extract_features(jds, FEATURE_NAMES, depth)
    got = extract_features(ds, FEATURE_NAMES, depth, device="cpu")
    assert got.shape == want.shape == (ds.n_flows, 67)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:, EXACT], want[:, EXACT])
    # sums, means, loads and stds reduce in another order than XLA's, so
    # they agree to float32 rounding
    for j, name in enumerate(FEATURE_NAMES):
        np.testing.assert_allclose(got[:, j], want[:, j], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("depth", [1, 4, 10, 16])
def test_extraction_matches_reference_app(app, depth):
    jds = jsynth.make_dataset("app-class", n_flows=257, max_pkts=16, seed=11)
    _check(app, jds, depth)


def test_extraction_matches_reference_iot_depth50(iot):
    jds = jsynth.make_dataset("iot-class", n_flows=600, max_pkts=64, seed=11)
    _check(iot, jds, 50)


def test_exact_columns_cover_the_families():
    names = {FEATURE_NAMES[i] for i in EXACT}
    assert {"s_pkt_cnt", "ack_cnt", "proto", "d_port", "s_bytes_min",
            "d_iat_max", "s_ttl_max"} <= names
    assert "s_bytes_mean" not in names and "dur" not in names


def test_std_root_is_correctly_rounded():
    """The std root is numpy's correctly rounded float32 root, bit for bit,
    on variances where the CPU's vectorized float32 `torch.sqrt` is one ulp
    off (torch 2.13's is on about 0.7% of values). The variance is the
    port's own arithmetic, written out as `_masked_std` computes it."""
    import torch

    from repro_torch.traffic import extraction as ext

    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.random((20000, 4)) * 1e4).astype(np.float32))
    m = torch.from_numpy(rng.random((20000, 4)) < 0.9)
    c = m.sum(dim=1)
    mean = ext._masked_sum(v, m) / c.clamp(min=1)
    d = torch.where(m, v - mean[:, None], 0.0)
    var = (ext._seq_sum(d, square=True) / c.clamp(min=1)).numpy()
    want = np.where(c.numpy() > 0, np.sqrt(var), np.float32(0.0))
    got = ext._masked_std(v, m).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_iot_std_columns_at_depth8_match_reference_roots(iot, monkeypatch):
    """At depth 8 of the iot-class set every column but the six stds equals
    `repro`'s bitwise (both packages add in packet order there), and each
    of the eight std columns is the reference's own root, `jnp.sqrt`, of the port's
    variance, bit for bit. The variances themselves may differ by an ulp:
    the port contracts std's squares into FMAs, as the kernels do, and
    this CPU build of XLA does not."""
    import jax.numpy as jnp

    from repro_torch.traffic import extraction as ext

    jds = jsynth.make_dataset("iot-class", n_flows=600, max_pkts=64, seed=11)
    want = np.asarray(jext.extract_features(jds, FEATURE_NAMES, 8))
    seen = []
    root = ext._sqrt_f32

    def record(var):
        seen.append(var.numpy().copy())
        return root(var)

    monkeypatch.setattr(ext, "_sqrt_f32", record)
    got = extract_features(iot, FEATURE_NAMES, 8, device="cpu")
    std = [j for j, n in enumerate(FEATURE_NAMES) if n.endswith("_std")]
    rest = [j for j in range(len(FEATURE_NAMES)) if j not in std]
    np.testing.assert_array_equal(got[:, rest], want[:, rest])
    assert len(seen) == len(std)
    for j, var in zip(std, seen):
        ref_root = np.asarray(jnp.sqrt(var))  # a flow with no packet: 0
        np.testing.assert_array_equal(got[:, j].view(np.int32),
                                      ref_root.view(np.int32),
                                      err_msg=FEATURE_NAMES[j])
