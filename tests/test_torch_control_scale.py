"""The control plane's skew gate at the size `chip_smoke.py`'s control phase
runs it (zipf app-class, 1000 flows of up to 256 packets, 4 shards, 8
bisection steps), on both packages under one fixed synthetic
`ServiceModel` (`examples/serve_control.py`'s constants).

The replay clock is a pure function of the stream, the constants and the
control plane's decisions, so the static and the dynamic fleet's zero-loss
rate, drops, imbalance, stage seconds, counters and `control` summary must
be exactly the reference's. This is what tells a fault of the port apart
from the reference's own behaviour at this size (where the dynamic fleet
sustains a lower rate than the static one: migration is charged to the
clock).
"""
import numpy as np
import pytest

import repro.serve as jserve
from repro.core.search_space import FeatureRep as JFeatureRep
from repro.traffic import extract_features as j_extract
from repro.traffic import synth as jsynth
from repro.traffic.models import train_traffic_model as j_train
from repro.traffic.pipeline import build_pipeline as j_build

import repro_torch.serve as tserve
from repro_torch.convert import forest_from_numpy
from repro_torch.core.search_space import FeatureRep
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_scenario_dataset
from test_torch_control import REP_A, SVC_A

SIZE = dict(n_flows=1000, max_pkts=256, seed=3)


@pytest.fixture(scope="module")
def fleets():
    """(serve module, stream, pipeline) for the reference and the port,
    both pipelines over the reference's tree-fast forest on rep A."""
    names, depth = REP_A
    jds = jsynth.make_scenario_dataset("app-class", "zipf", **SIZE)
    ds = make_scenario_dataset("app-class", "zipf", **SIZE)
    jf, _ = j_train(np.asarray(j_extract(jds, names, depth)), jds.label,
                    model="tree-fast", seed=0)
    forest = forest_from_numpy(jf.feature, jf.threshold, jf.leaf, jf.depth,
                               jf.n_features, jf.classes)
    jp = j_build(JFeatureRep(names, depth), jf, depth, use_kernel=False)
    tp = build_pipeline(FeatureRep(names, depth), forest, depth, fused=True,
                        device="cpu")
    return {"ref": (jserve, jserve.PacketStream.from_dataset(jds, seed=0), jp),
            "port": (tserve, tserve.PacketStream.from_dataset(ds, seed=0), tp)}


def _search(sv, stream, pipe, dynamic: bool):
    def fleet(execute=False):
        return sv.ShardedRuntime(pipe, n_shards=4, capacity=2048,
                                 max_batch=64, execute=execute)

    session = (sv.ServeSession(control=sv.ControlConfig(
        interval_pkts=512, imbalance_trigger=1.04)) if dynamic else None)
    rate, st = sv.find_zero_loss_rate(
        stream, fleet, sv.ServiceModel(**SVC_A), iters=8,
        ring_capacity=max(64, stream.n_events // 16), session=session)
    return dict(rate=rate, drops=st.drops, load_imbalance=st.load_imbalance,
                stage_seconds=st.stage_seconds, control=st.control,
                counters={k: getattr(st.metrics, k)
                          for k in st.metrics.counter_fields()},
                latency=(st.latency_p50_s, st.latency_p99_s))


@pytest.mark.parametrize("arm", ["static", "dynamic"])
def test_zero_loss_search_at_scale_matches_reference(fleets, arm):
    got = _search(*fleets["port"], dynamic=arm == "dynamic")
    want = _search(*fleets["ref"], dynamic=arm == "dynamic")
    assert got == want
    assert got["drops"] == 0
    if arm == "dynamic":
        assert got["control"]["rebalances"] > 0


if __name__ == "__main__":
    # `PYTHONPATH=src:tests python tests/test_torch_control_scale.py`: both
    # packages' searches as JSON lines, with the dynamic fleet's migration
    # charge (two accumulated packets' time a migrated flow, one on each
    # side) beside its stage seconds
    import json

    sides = fleets.__wrapped__()
    for arm in ("static", "dynamic"):
        for name, side in sides.items():
            r = _search(*side, dynamic=arm == "dynamic")
            if arm == "dynamic":
                r["migration_charge_s"] = (2 * r["control"]["flows_migrated"]
                                           * SVC_A["pkt_accum_ns"] * 1e-9)
            print(json.dumps({"arm": arm, "package": name, **r}))
