"""The port's `ServeSession` (`repro_torch.serve.session`): the reference's
attachment API and its deprecation shim, as `tests/test_serve_session.py`
holds them for `repro`.

Every serving entry point takes one ``session=`` carrying obs / control /
reopt / audit; the legacy per-call keywords (``obs=``, ``control=``,
``audit=``, ``tracer=``) keep working behind a `DeprecationWarning` and
produce identical results; a session together with a legacy keyword is a
`TypeError`, and a reoptimizer without a control config is one too. Also
pins the `now_pkts` clock normalization. Pipelines run B2's plain version
on the CPU.
"""
from __future__ import annotations

import inspect
import pathlib

import numpy as np
import pytest

from repro_torch.core.search_space import FeatureRep
from repro_torch.serve import (
    AuditLog,
    ControlConfig,
    ControlPlane,
    Observability,
    PacketStream,
    ServeSession,
    ServiceModel,
    ShardedRuntime,
    Tracer,
    controlled_replay,
    deploy,
    replay,
)
from repro_torch.serve.obs.audit import AuditEvent
from repro_torch.traffic.extraction import extract_features
from repro_torch.traffic.models import train_traffic_model
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.synth import make_scenario_dataset

REP = FeatureRep(("dur", "s_load", "s_bytes_mean", "s_iat_mean", "ack_cnt"),
                 depth=8)


@pytest.fixture(scope="module")
def ds():
    return make_scenario_dataset("app-class", "uniform", n_flows=150,
                                 max_pkts=16, seed=7)


@pytest.fixture(scope="module")
def pipeline(ds):
    X = extract_features(ds, REP.features, REP.depth, device="cpu")
    forest, _ = train_traffic_model(X, ds.label, model="tree-fast", seed=0)
    return build_pipeline(REP, forest, max_pkts=REP.depth, fused=True,
                          device="cpu")


@pytest.fixture(scope="module")
def stream(ds):
    return PacketStream.from_dataset(ds, seed=0)


@pytest.fixture(scope="module")
def service():
    return ServiceModel(
        pkt_accum_ns=800.0, pkt_track_ns=200.0,
        bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5},
        gather_ns_per_flow=200.0, source="synthetic",
    )


def _fleet(pipeline):
    return ShardedRuntime(pipeline, n_shards=2, capacity=1024,
                          max_batch=32, execute=True)


# ---------------------------------------------------------------------------
# legacy keywords: warn, but behave identically
# ---------------------------------------------------------------------------


def test_replay_legacy_obs_equals_session(stream, pipeline, service):
    with pytest.warns(DeprecationWarning, match="obs="):
        legacy = replay(stream, lambda: _fleet(pipeline), 1e5, service,
                        obs=Observability())
    new = replay(stream, lambda: _fleet(pipeline), 1e5, service,
                 session=ServeSession(obs=Observability()))
    assert legacy.drops == new.drops
    assert legacy.predictions == new.predictions
    assert legacy.duration_s == new.duration_s


def test_controlled_replay_legacy_control_equals_session(
        stream, pipeline, service):
    cfg = ControlConfig(interval_pkts=256, rebalance=False)
    with pytest.warns(DeprecationWarning, match="control="):
        legacy = controlled_replay(stream, lambda: _fleet(pipeline), 1e5,
                                   service, control=cfg)
    new = controlled_replay(stream, lambda: _fleet(pipeline), 1e5, service,
                            session=ServeSession(control=cfg))
    assert legacy.predictions == new.predictions
    assert legacy.control["steps"] == new.control["steps"]


def test_session_plus_legacy_keyword_is_a_conflict(stream, pipeline, service):
    with pytest.raises(TypeError, match="not both"):
        replay(stream, lambda: _fleet(pipeline), 1e5, service,
               session=ServeSession(), obs=Observability())


def test_reopt_without_control_is_an_error(stream, pipeline, service):
    class _Stub:
        pass

    with pytest.raises(TypeError, match="control plane"):
        replay(stream, lambda: _fleet(pipeline), 1e5, service,
               session=ServeSession(reopt=_Stub()))


def test_deploy_legacy_audit_warns(pipeline, service, stream):
    from repro_torch.serve.deploy import BundlePoint

    point = BundlePoint(rep=REP, cost=1.0, perf=0.9, fidelity="measured",
                        aux={}, compile_meta={"fused": False},
                        forest_doc=None, pipeline=pipeline)
    rt = _fleet(pipeline)
    log = AuditLog()
    with pytest.warns(DeprecationWarning, match="audit="):
        deploy(point, rt, 0.0, audit=log)
    assert [e.kind for e in log.events] == ["deploy"]


# ---------------------------------------------------------------------------
# resolution rules
# ---------------------------------------------------------------------------


def test_resolve_audit_precedence():
    explicit, bundled = AuditLog(), AuditLog()
    obs = Observability(audit=bundled)
    assert ServeSession(obs=obs, audit=explicit).resolve_audit() is explicit
    assert ServeSession(obs=obs).resolve_audit() is bundled
    assert ServeSession().resolve_audit() is None


def test_session_properties_thread_through_obs():
    tr = Tracer()
    obs = Observability(tracer=tr)
    s = ServeSession(obs=obs)
    assert s.tracer is tr
    assert s.drift is None
    assert ServeSession().tracer is None


def test_coerce_wraps_bare_tracer():
    tr = Tracer()
    with pytest.warns(DeprecationWarning, match="tracer="):
        s = ServeSession.coerce(tracer=tr)
    assert s.obs is not None and s.obs.tracer is tr


# ---------------------------------------------------------------------------
# now_pkts normalization
# ---------------------------------------------------------------------------


def test_audit_event_legacy_t_round_trip():
    ev = AuditEvent(seq=0, now_pkts=42.0, kind="deploy", rationale="r",
                    detail={})
    assert ev.t == 42.0                       # pre-rename alias
    assert AuditEvent.from_doc(ev.to_doc()).now_pkts == 42.0
    # documents written before the rename carried "t"
    old = {"seq": 1, "t": 7.0, "kind": "deploy", "rationale": "r",
           "detail": {}}
    assert AuditEvent.from_doc(old).now_pkts == 7.0


def test_control_surface_signatures_say_now_pkts():
    for fn in (ControlPlane.maybe_step, deploy, Tracer.instant,
               AuditLog.record):
        assert "now_pkts" in inspect.signature(fn).parameters, fn


def test_no_bare_now_keyword_anywhere_in_the_ports_serve():
    """Lint: the packet clock is spelled now_pkts across the serving
    control surface. Worker-internal lane clocks assign ``now = ...``
    (with spaces); a literal ``now=`` substring would be a keyword
    argument regression."""
    root = pathlib.Path(__file__).resolve().parent.parent
    offenders = []
    for p in sorted((root / "src" / "repro_torch" / "serve").rglob("*.py")):
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if "now=" in line and "now_pkts" not in line:
                offenders.append(f"{p.name}:{i}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


def test_predictions_identical_with_and_without_attachments(
        stream, pipeline, service):
    """Attachments observe; they never perturb the data path."""
    bare = replay(stream, lambda: _fleet(pipeline), 1e5, service)
    dressed = replay(
        stream, lambda: _fleet(pipeline), 1e5, service,
        session=ServeSession(
            obs=Observability(tracer=Tracer()),
            control=ControlConfig(interval_pkts=512, rebalance=False)))
    assert bare.predictions == dressed.predictions
    assert bare.drops == dressed.drops == 0
    for fid, pred in bare.predictions.items():
        assert isinstance(pred, (int, np.integer))


def test_coerce_folds_legacy_keywords_and_passes_sessions_through():
    cfg = ControlConfig(interval_pkts=256)
    s = ServeSession(control=cfg)
    assert ServeSession.coerce(s) is s
    assert ServeSession.coerce() == ServeSession()
    with pytest.warns(DeprecationWarning, match="control="):
        folded = ServeSession.coerce(control=cfg, audit=AuditLog())
    assert folded.control is cfg and folded.audit is not None
    with pytest.raises(TypeError, match="not both"):
        ServeSession.coerce(s, control=cfg)
