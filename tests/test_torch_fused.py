"""Fused extract+infer (B2) against `repro.kernels.fused_pipeline`, by the
straddle rule, and against the port's own two-launch path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.search_space import FeatureRep as JFeatureRep
from repro.kernels.fused_pipeline import fused_forest_infer as j_fused
from repro.traffic import extraction as jext
from repro.traffic import synth as jsynth
from repro.traffic.models import train_traffic_model as j_train

from _torch_parity import PROB_ATOL, assert_straddle_parity
from repro_torch.convert import forest_from_numpy, forest_tables
from repro_torch.kernels import ops
from repro_torch.kernels.fused_pipeline import (
    decode_plan,
    encode_plan,
    fused_forest_infer,
)
from repro_torch.traffic.extraction import dataset_tensors, stats_plan
from repro_torch.traffic.features import FEATURE_NAMES
from repro_torch.traffic.synth import make_dataset

# one representative per op family, as tests/test_fused_pipeline.py has them
FEATURE_SUBSETS = [
    ("dur", "proto", "s_port", "d_port"),
    ("s_load", "d_load", "s_pkt_cnt", "d_pkt_cnt"),
    ("tcp_rtt", "syn_ack", "ack_dat", "syn_cnt", "ack_cnt", "fin_cnt"),
    ("s_bytes_sum", "s_bytes_mean", "s_bytes_min", "s_bytes_max",
     "s_bytes_med", "s_bytes_std"),
    ("d_iat_mean", "d_iat_std", "d_iat_med", "s_iat_min", "s_iat_max"),
    ("s_winsize_mean", "d_winsize_std", "s_ttl_min", "d_ttl_max",
     "d_winsize_med"),
]
CASES = ([(f, d) for f in FEATURE_SUBSETS for d in (4, 12)]
         + [(tuple(FEATURE_NAMES), 10)])


@pytest.fixture(scope="module")
def data():
    kw = dict(n_flows=257, max_pkts=16, seed=11)
    return make_dataset("app-class", **kw), jsynth.make_dataset("app-class", **kw)


def _port_args(ds, forest):
    t = dataset_tensors(ds, torch.device("cpu"))
    return ((t["ts"], t["size"], t["direction"], t["ttl"], t["winsize"],
             t["flags"], t["flow_len"], t["proto"], t["s_port"], t["d_port"],
             *forest_tables(forest, "cpu")))


@pytest.mark.parametrize("features,depth", CASES,
                         ids=[f"{len(f)}f-{f[0]}-d{d}" for f, d in CASES])
def test_fused_matches_reference(data, features, depth):
    ds, jds = data
    jrep = JFeatureRep(features, depth)
    xj = jext.extract_features(jds, jrep.features, depth)
    model = "tree-fast" if len(features) == 67 else "rf-fast"
    jf, _ = j_train(xj, jds.label, model=model, seed=0)
    plan = stats_plan(jrep.features)
    assert plan == jext.stats_plan(jrep.features)
    want = np.asarray(j_fused(
        jnp.asarray(jds.ts), jnp.asarray(jds.size), jnp.asarray(jds.direction),
        jnp.asarray(jds.ttl), jnp.asarray(jds.winsize), jnp.asarray(jds.flags),
        jnp.asarray(jds.flow_len), jnp.asarray(jds.proto),
        jnp.asarray(jds.s_port), jnp.asarray(jds.d_port),
        jnp.asarray(jf.feature), jnp.asarray(jf.threshold), jnp.asarray(jf.leaf),
        plan=plan, depth=depth, forest_depth=jf.depth))

    tf = forest_from_numpy(jf.feature, jf.threshold, jf.leaf, jf.depth,
                           jf.n_features, jf.classes)
    args = _port_args(ds, tf)
    cols = torch.empty((ds.n_flows, len(plan)))
    op_table = torch.from_numpy(encode_plan(plan))
    got = fused_forest_infer(*args, op_table=op_table, depth=depth,
                             forest_depth=tf.depth, columns=cols)
    assert got.shape == (ds.n_flows, jf.n_out)
    np.testing.assert_allclose(cols.numpy(), xj, rtol=1e-5, atol=1e-6)
    assert_straddle_parity(want, got.numpy(), xj, cols.numpy(), jf)
    # the port's one launch equals its two launches on its own columns
    two = ops.forest_infer(cols, *args[10:], tf.depth)
    np.testing.assert_allclose(got.numpy(), two.numpy(), rtol=0, atol=PROB_ATOL)


def test_op_table_round_trips_every_feature():
    for names in [tuple(FEATURE_NAMES)] + FEATURE_SUBSETS:
        plan = stats_plan(names)
        table = encode_plan(plan)
        assert table.shape == (len(plan), 4) and table.dtype == np.int32
        assert decode_plan(table) == plan
    # every row of the full registry is a distinct op
    full = encode_plan(stats_plan(FEATURE_NAMES))
    assert len({tuple(r) for r in full}) == 67


# a plan in which every stat family has a median, at windows above the
# kernel's shared-memory chunk (MAX_WINDOW = 128 packets)
WINDOW_FEATURES = ("dur", "s_load", "ack_cnt", "tcp_rtt", "s_bytes_mean",
                   "s_bytes_med", "s_bytes_std", "d_iat_sum", "d_iat_med",
                   "s_winsize_med", "d_ttl_med")


@pytest.fixture(scope="module")
def long_flows():
    kw = dict(n_flows=96, max_pkts=300, seed=11)
    return make_dataset("app-class", **kw), jsynth.make_dataset("app-class", **kw)


@pytest.mark.parametrize("depth", [129, 256])
def test_fused_serves_windows_above_the_buffer(long_flows, depth):
    """The fused entry takes any window, as the reference does; the card's
    kernel moves a longer window's samples to a scratch (checked bitwise
    against this plain version by tests/test_torch_card.py)."""
    ds, jds = long_flows
    assert (ds.flow_len > 128).sum() >= 8
    jrep = JFeatureRep(WINDOW_FEATURES, depth)
    plan = stats_plan(jrep.features)
    xj = jext.extract_features(jds, jrep.features, depth)
    jf, _ = j_train(xj, jds.label, model="rf-fast", seed=0)
    want = np.asarray(j_fused(
        jnp.asarray(jds.ts), jnp.asarray(jds.size), jnp.asarray(jds.direction),
        jnp.asarray(jds.ttl), jnp.asarray(jds.winsize), jnp.asarray(jds.flags),
        jnp.asarray(jds.flow_len), jnp.asarray(jds.proto),
        jnp.asarray(jds.s_port), jnp.asarray(jds.d_port),
        jnp.asarray(jf.feature), jnp.asarray(jf.threshold), jnp.asarray(jf.leaf),
        plan=plan, depth=depth, forest_depth=jf.depth))
    tf = forest_from_numpy(jf.feature, jf.threshold, jf.leaf, jf.depth,
                           jf.n_features, jf.classes)
    cols = torch.empty((ds.n_flows, len(plan)))
    got = fused_forest_infer(*_port_args(ds, tf),
                             op_table=torch.from_numpy(encode_plan(plan)),
                             depth=depth, forest_depth=tf.depth, columns=cols)
    x = cols.numpy()
    # XLA adds rows above 32 packets in another order than packet order
    np.testing.assert_allclose(x, xj, rtol=1e-5, atol=1e-6)
    med = [i for i, e in enumerate(plan) if e[-1] == "med"]
    assert len(med) == 4
    np.testing.assert_array_equal(x[:, med], xj[:, med])
    assert_straddle_parity(want, got.numpy(), xj, x, jf)
