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
