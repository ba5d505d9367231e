"""The port's reuse path against `repro`: the aggregate emitter (numpy and
torch), the plain version of the aggregate kernel B3 against the
reference's Pallas kernel in interpret mode, the pipelines' `predict_agg`,
and drift-gated reuse in a replay (DESIGN.md §12).

The aggregate rows come from a flow table that ingested a zipf trace, plus
pristine and all-zero rows (the sentinels and the padding rows).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_pipeline import fused_agg_infer as j_fused_agg_infer
from repro.traffic import extraction as jext
from repro.traffic.pipeline import _agg_extract as j_agg_extract

from _torch_parity import PROB_ATOL, assert_straddle_parity
from repro_torch.convert import forest_from_numpy, forest_tables
from repro_torch.core.search_space import FeatureRep
from repro_torch.kernels.fused_pipeline import (
    agg_op_table,
    encode_plan,
    fused_agg_call,
    fused_agg_infer,
    fused_agg_infer_plain,
)
from repro_torch.serve import runtime as prt
from repro_torch.traffic.extraction import (
    AGG_INIT,
    AGG_WIDTH,
    emit_agg_features,
    stats_plan,
)
from repro_torch.traffic.features import FEATURE_NAMES
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_scenario_dataset

from test_torch_runtime import DEPTH, NAMES, _counters, _runtime, world  # noqa: F401

INCREMENTAL = tuple(f for f in FEATURE_NAMES if not f.endswith("_med"))
# one plan per op family of the incremental plan, then all 59 columns
PLANS = {
    "dur-meta": ("dur", "proto", "s_port", "d_port"),
    "load-count": ("s_load", "d_load", "s_pkt_cnt", "d_pkt_cnt"),
    "handshake-flags": ("tcp_rtt", "syn_ack", "ack_dat", "syn_cnt", "ack_cnt",
                        "fin_cnt", "cwr_cnt"),
    "bytes": ("s_bytes_sum", "s_bytes_mean", "s_bytes_min", "s_bytes_max",
              "s_bytes_std", "d_bytes_std"),
    "iat": ("s_iat_sum", "d_iat_mean", "d_iat_std", "s_iat_min", "s_iat_max",
            "s_iat_std"),
    "win-ttl": ("s_winsize_mean", "d_winsize_std", "s_ttl_min", "d_ttl_max",
                "d_winsize_sum", "s_ttl_std"),
    "all59": INCREMENTAL,
}


@pytest.fixture(scope="module")
def rows():
    """float64 aggregate rows of live flows of a table that ingested the
    first 3000 packets of a zipf trace, then two pristine and two zero rows;
    and their float32 meta."""
    ds = make_scenario_dataset("app-class", "zipf", n_flows=60, max_pkts=400,
                               seed=3)
    s = prt.PacketStream.from_dataset(ds, seed=0)
    tbl = prt.FlowTable(256, DEPTH, reuse=True, refresh_every=64,
                        agg_buffer=128)
    fid = s.fid[:3000]
    tbl.observe_batch(s.key[fid], s.base_t[:3000], s.rel_ts32[:3000],
                      s.size[:3000], s.direction[:3000], s.ttl[:3000],
                      s.winsize[:3000], s.flags_byte[:3000], s.proto[fid],
                      s.s_port[fid], s.d_port[fid], fid, s.fin[:3000])
    tbl.flush_agg()
    live = np.flatnonzero(tbl.ctrl["state"] != 0)
    assert len(live) >= 37
    agg = np.concatenate([tbl.agg[live], np.stack([AGG_INIT] * 2),
                          np.zeros((2, AGG_WIDTH))])
    pad = np.zeros(4, np.float32)
    meta = [np.concatenate([getattr(tbl, k)[live], pad])
            for k in ("proto", "s_port", "d_port")]
    return agg, meta


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_numpy_emitter_bitwise(rows, plan_name):
    agg, (proto, sp, dp) = rows
    plan = stats_plan(PLANS[plan_name])
    want = jext.emit_agg_features(plan, agg, proto=proto, s_port=sp, d_port=dp)
    got = emit_agg_features(plan, agg, proto=proto, s_port=sp, d_port=dp)
    for a, b in zip(want, got, strict=True):
        assert b.dtype == a.dtype == np.float32
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_torch_emitter_matches_jnp(rows, plan_name):
    agg, meta = rows
    plan = stats_plan(PLANS[plan_name])
    agg32 = agg.astype(np.float32)
    want = np.asarray(j_agg_extract(jnp.asarray(agg32),
                                    *(jnp.asarray(m) for m in meta),
                                    plan=plan))
    got = torch.stack(emit_agg_features(
        plan, torch.from_numpy(agg32), proto=torch.from_numpy(meta[0]),
        s_port=torch.from_numpy(meta[1]), d_port=torch.from_numpy(meta[2])),
        dim=1).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got[-4:] == 0).all()        # pristine and padding rows


def _forest_on(x: np.ndarray, seed: int, T=8, D=6, K=5):
    """A random forest whose thresholds are values of the columns `x`, as
    a trainer's quantile edges are: ties with the columns happen."""
    R = np.random.default_rng(seed)
    F = x.shape[1]
    feature = R.integers(0, F, (T, 2 ** D - 1))
    rows = R.integers(0, x.shape[0], feature.shape)
    return forest_from_numpy(feature, x[rows, feature],
                             R.random((T, 2 ** D, K)), D, F)


@pytest.mark.parametrize("n", [1, 5, 37])
@pytest.mark.parametrize("plan_name", ["all59", "iat"])
def test_fused_agg_plain_matches_reference_kernel(rows, n, plan_name):
    agg, meta = rows
    plan = stats_plan(PLANS[plan_name])
    # the padding and pristine rows at the end, the first live rows before
    sel = np.r_[np.arange(max(0, n - 4)), np.arange(len(agg) - 4, len(agg))][-n:]
    a64, m = agg[sel], [x[sel] for x in meta]
    x_ref = np.asarray(j_agg_extract(jnp.asarray(a64.astype(np.float32)),
                                     *(jnp.asarray(v) for v in m), plan=plan))
    forest = _forest_on(np.asarray(j_agg_extract(
        jnp.asarray(agg.astype(np.float32)), *(jnp.asarray(v) for v in meta),
        plan=plan)), seed=n)
    want = np.asarray(j_fused_agg_infer(
        jnp.asarray(a64), *(jnp.asarray(v) for v in m),
        jnp.asarray(forest.feature), jnp.asarray(forest.threshold),
        jnp.asarray(forest.leaf), plan=plan, forest_depth=forest.depth,
        interpret=True))
    tables = forest_tables(forest, "cpu")
    cols = torch.empty((n, len(plan)))
    got = fused_agg_infer(
        torch.from_numpy(a64), *(torch.from_numpy(v) for v in m), *tables,
        op_table=torch.from_numpy(encode_plan(plan)),
        forest_depth=forest.depth, columns=cols)
    np.testing.assert_allclose(cols.numpy(), x_ref, rtol=1e-5, atol=1e-6)
    assert_straddle_parity(want, got.numpy(), x_ref, cols.numpy(), forest)


def test_aggregate_kernel_refuses_a_median(rows):
    agg, meta = rows
    plan = stats_plan(("dur", "s_bytes_med"))
    forest = _forest_on(np.zeros((4, 2), np.float32), seed=0)
    tables = forest_tables(forest, "cpu")
    args = (torch.from_numpy(agg[:4].astype(np.float32)),
            torch.from_numpy(np.stack([v[:4] for v in meta], 1)), *tables)
    with pytest.raises(ValueError, match="median"):
        fused_agg_call(*args, op_table=torch.from_numpy(encode_plan(plan)),
                       forest_depth=forest.depth)
    with pytest.raises(ValueError, match="no incremental form"):
        fused_agg_infer_plain(*args, op_table=torch.from_numpy(
            encode_plan(plan)), forest_depth=forest.depth)


@pytest.mark.parametrize("form", ["array", "tensor"])
def test_agg_op_table_refuses_a_median_on_the_host(form):
    """The median check runs on the host table before it goes anywhere."""
    table = encode_plan(stats_plan(("dur", "s_bytes_med", "d_iat_std")))
    if form == "tensor":
        table = torch.from_numpy(table)
    with pytest.raises(ValueError, match="median"):
        agg_op_table(table, "cpu")


def test_agg_op_table_keeps_an_incremental_plan():
    table = encode_plan(stats_plan(PLANS["all59"]))
    got = agg_op_table(table, "cpu")
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got, torch.from_numpy(table))


def test_aggregate_kernel_takes_no_unchecked_device_table():
    """A table off the host that `agg_op_table` did not make is refused
    before anything reads it, and `agg_op_table` takes only host tables."""
    plan = stats_plan(PLANS["bytes"])
    off_host = torch.from_numpy(encode_plan(plan)).to("meta")
    forest = _forest_on(np.zeros((4, len(plan)), np.float32), seed=0)
    with pytest.raises(ValueError, match="agg_op_table"):
        fused_agg_call(torch.zeros((4, AGG_WIDTH), device="meta"),
                       torch.zeros((4, 3), device="meta"),
                       *forest_tables(forest, "cpu"), op_table=off_host,
                       forest_depth=forest.depth)
    with pytest.raises(ValueError, match="host"):
        agg_op_table(off_host, "cpu")


def test_predict_agg_fused_and_unfused_agree(world, rows):  # noqa: F811
    ref, port, forest = world
    agg, meta = rows
    fused = port.pipe
    unfused = build_pipeline(fused.rep, forest, DEPTH, device="cpu")
    oracle = build_pipeline(fused.rep, forest, DEPTH, use_kernel=False,
                            device="cpu")
    assert fused.supports_agg and unfused.supports_agg
    a = unfused.predict_agg(agg, *meta).numpy()
    b = fused.predict_agg(agg, *meta).numpy()
    c = oracle.predict_agg(agg, *meta).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(c, a, rtol=0, atol=PROB_ATOL)
    np.testing.assert_array_equal(fused.finalize(fused.predict_agg(agg, *meta)),
                                  unfused.finalize(torch.from_numpy(a)))
    # against the reference's two-launch aggregate entry
    plan = stats_plan(NAMES)
    xr = np.asarray(j_agg_extract(jnp.asarray(agg.astype(np.float32)),
                                  *(jnp.asarray(v) for v in meta), plan=plan))
    xt = torch.stack(emit_agg_features(
        plan, torch.from_numpy(agg.astype(np.float32)),
        proto=torch.from_numpy(meta[0]), s_port=torch.from_numpy(meta[1]),
        d_port=torch.from_numpy(meta[2])), 1).numpy()
    assert_straddle_parity(np.asarray(ref.pipe.predict_agg(agg, *meta)), b,
                           xr, xt, forest)
    no_agg = build_pipeline(FeatureRep(("dur", "s_bytes_med"), DEPTH),
                            forest_from_numpy(np.zeros((1, 1)), np.zeros((1, 1)),
                                              np.ones((1, 2, 2)), 1, 2),
                            DEPTH, fused=True, device="cpu")
    assert not no_agg.supports_agg
    with pytest.raises(ValueError, match="not incremental"):
        no_agg.predict_agg(agg, *meta)


@pytest.mark.parametrize("shards", [1, 4])
def test_threshold_zero_results_equal_reuse_off(world, shards):  # noqa: F811
    _, port, _ = world
    s = port.stream
    out = []
    for reuse in (None, (0.0, 64)):
        st = prt.replay(s, lambda reuse=reuse: _runtime(port, shards, 256, reuse),
                        s.base_pps * 3, port.svc, ring_capacity=s.n_events // 6)
        out.append(st)
    off, thr0 = out
    assert thr0.metrics.forced_reinfer > 0
    assert set(thr0.predictions) == set(off.predictions)
    for k, v in off.predictions.items():
        assert np.array_equal(thr0.predictions[k], v), k


@pytest.mark.parametrize("shards", [1, 4])
def test_reuse_counters_and_refreshes_match_reference(world, shards):  # noqa: F811
    """At threshold 0.1, refresh every 64 packets: the same reuse hits,
    refreshes and forced re-inferences as the reference (the drift decision
    runs on the host in float64 on both sides), and the same refreshed
    live predictions."""
    ref, port, _ = world
    out = []
    for side in (ref, port):
        made = []

        def mk(side=side, made=made):
            made.append(_runtime(side, shards, 256, (0.1, 64)))
            return made[-1]

        st = side.rt.replay(side.stream, mk, side.stream.base_pps * 3,
                            side.svc, ring_capacity=side.stream.n_events // 6)
        live = {}
        for r in getattr(made[0], "shards", [made[0]]):
            live.update(r.dispatcher.live_predictions)
        out.append((st, {k: int(v) for k, v in live.items()}))
    (want, live_w), (got, live_g) = out
    for k in ("reuse_hits", "refreshes", "forced_reinfer"):
        assert getattr(got.metrics, k) == getattr(want.metrics, k), k
    assert want.metrics.refreshes > 0 and want.metrics.reuse_hits > 0
    assert _counters(got.metrics) == _counters(want.metrics)
    # the refresh columns of the two sides agree to rounding and this
    # forest's thresholds meet none of them between the two values
    assert live_g == live_w
