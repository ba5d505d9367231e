"""Serving substrate.

Port of `repro.serve`, unchanged but for the LM serving steps it
names.

Two serving stacks live here:

- LM serving steps (`serve_step`): prefill (full-sequence forward) and
  per-token decode against the KV cache, for the dense and hybrid
  families.
- the streaming traffic runtime (`runtime/`): online flow table with
  vectorized block ingest (`observe_batch`), micro-batched shape-bucketed
  dispatch staged in preallocated arenas, and offered-load replay with
  zero-loss throughput measurement — the continuous-serving layer over the
  CATO pipelines on the card, fused single-launch by default
  (DESIGN.md §6, §7), horizontally sharded behind RSS-style steering
  (§8) with an adaptive control plane (`control/`, §9): dynamic RETA
  rebalancing, zero-downtime pipeline hot-swap, elastic worker sizing —
  plus the compile-to-deploy layer (`deploy.py`, §10.4) that turns an
  optimized Pareto front into warmed pipelines, a serializable
  `ParetoBundle`, and a live hot-swap into the fleet, and the
  drift-triggered re-optimization policy (`control/reoptimizer.py`,
  §13) that closes the measure → optimize → compile → deploy → adapt
  loop autonomously.

This module is the **public serving namespace**: everything a serving
consumer (examples, benchmarks, downstream users) needs is re-exported
here, threaded through one attachment carrier (`ServeSession`) — reach
into submodules only for internals. The re-exports resolve lazily
(PEP 562): `from repro_torch.serve import make_serve_step` must not drag
in the traffic/extraction stack, and the traffic package must stay
importable without touching this one.
"""
from .serve_step import make_serve_step, make_prefill

_SESSION_EXPORTS = (
    "ServeSession",
)

_RUNTIME_EXPORTS = (
    "BatchRecord",
    "FlowStatus",
    "FlowTable",
    "LatencyHistogram",
    "MicroBatchDispatcher",
    "MultiTenantPipeline",
    "PacketStream",
    "ReplayStats",
    "ReuseConfig",
    "RuntimeMetrics",
    "ServiceModel",
    "ShardedRuntime",
    "StreamingRuntime",
    "build_multi_tenant_pipeline",
    "find_zero_loss_rate",
    "replay",
    "tuple_hash64",
)

_CONTROL_EXPORTS = (
    "BucketTelemetry",
    "ControlConfig",
    "ControlPlane",
    "HeadroomPolicy",
    "PipelineSwap",
    "ReoptOutcome",
    "ReoptimizerConfig",
    "ReoptimizerPolicy",
    "cato_retuner",
    "controlled_replay",
)

# compile-to-deploy layer (DESIGN.md §10.4): CatoResult front ->
# warmed pipelines -> serializable ParetoBundle -> live hot-swap
_DEPLOY_EXPORTS = (
    "BundlePoint",
    "MultiTenantBundlePoint",
    "ParetoBundle",
    "compile_front",
    "compile_multi_tenant",
    "deploy",
    "make_swap",
    "warm_buckets_for",
)

# unified serving observability (DESIGN.md §11, §14): fleet-wide metrics
# registry, flow/stage span tracing on the replay clock, control-plane
# audit log, online drift signals, per-component latency sketches,
# windowed SLO burn-rate tracking, Prometheus/JSONL export
_OBS_EXPORTS = (
    "AuditLog",
    "DriftMonitor",
    "DriftVerdict",
    "LatencyConfig",
    "LatencyRecorder",
    "LatencySketch",
    "MetricsExporter",
    "MetricsRegistry",
    "Observability",
    "SLOConfig",
    "SLOTracker",
    "SLOVerdict",
    "Tracer",
    "check_prometheus",
    "fleet_registry",
    "render_prometheus",
)

__all__ = sorted(["make_serve_step", "make_prefill", *_SESSION_EXPORTS,
                  *_RUNTIME_EXPORTS, *_CONTROL_EXPORTS, *_DEPLOY_EXPORTS,
                  *_OBS_EXPORTS])


_EXPORT_HOMES = {
    **{n: "session" for n in _SESSION_EXPORTS},
    **{n: "runtime" for n in _RUNTIME_EXPORTS},
    **{n: "control" for n in _CONTROL_EXPORTS},
    **{n: "deploy" for n in _DEPLOY_EXPORTS},
    **{n: "obs" for n in _OBS_EXPORTS},
}


def __getattr__(name):
    # importlib (not ``from . import x``): an export sharing its
    # submodule's name (``deploy``) would recurse through the
    # fromlist's hasattr probe otherwise
    home = _EXPORT_HOMES.get(name)
    if home is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{home}"), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))


# The ``deploy`` *function* shares its submodule's name. Whenever any
# import touches the ``repro_torch.serve.deploy`` submodule, the import system
# binds that submodule as an attribute of this package — which would
# shadow the lazy export and make ``from repro_torch.serve import deploy``
# yield the module. Bind the function eagerly; the ``from`` rebind runs
# after the submodule's setattr, so the function wins and stays won.
from .deploy import deploy as deploy  # noqa: E402
