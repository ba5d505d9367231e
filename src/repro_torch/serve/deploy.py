"""Compile-to-deploy: turn an optimized Pareto front into running pipelines.

Port of `repro.serve.deploy`, with its semantics. Every function that
builds a pipeline takes ``device=`` (default ``"cuda"``) and warms every
bucket geometry there. The port has no ``use_kernel``: its path follows the
device. Its bundles leave the key out, and the reference's loader reads it
as False, so a bundle written by either package loads in the other.

The paper's pitch is that CATO "compiles end-to-end optimized serving
pipelines that can be deployed in real networks" — discovery is only
half the loop. This module is the other half (DESIGN.md §10.4):

1. `compile_front` takes a `CatoResult` (its measured-fidelity Pareto
   set) and the profiler that measured it, rebuilds each front point's
   trained model from the profiler's cache (the *same* seeded forest the
   measurement used), compiles the serving pipeline, and pre-warms every
   dispatch bucket geometry of the target runtime so deployment never
   pays a first use (the kernel library's load, a bucket's device
   allocations) on the serving path (`ServingPipeline.warm`).
2. `ParetoBundle` is the serializable artifact: configs, measured
   objectives, compile metadata, and the full dense-forest payload per
   point — `save`/`load` round-trips through JSON, so a bundle built on
   the optimization host can be deployed elsewhere without retraining.
3. `make_swap` / `deploy` push a chosen point (`knee()` by default —
   the diminishing-returns operating point) into a *live* runtime:
   `make_swap` schedules a zero-downtime `PipelineSwap` through the
   control plane, `deploy` hot-swaps immediately via the §9.3
   drain-and-swap quiescence protocol (zero drops, exactly-once
   predictions — the same argument, reused).

`examples/tune_serving.py` drives the full measure → optimize →
compile → deploy loop.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Optional

import numpy as np

from ..core.forest import DenseForest
from ..core.optimizer import CatoResult, Observation
from ..core.pareto import knee_index
from ..core.search_space import FeatureRep

__all__ = ["BundlePoint", "MultiTenantBundlePoint", "ParetoBundle",
           "compile_front", "compile_multi_tenant", "deploy", "make_swap",
           "warm_buckets_for"]


def warm_buckets_for(runtime=None, lo: int = 8, hi: int = 256) -> list[int]:
    """Power-of-two dispatch buckets a runtime's dispatcher can submit.

    Warming must cover the target fleet's *actual* batch geometry
    (`min_bucket..max_batch`); the defaults only apply when no runtime
    is given (matching `StreamingRuntime`'s own defaults)."""
    if runtime is not None:
        worker = getattr(runtime, "shards", [runtime])[0]
        lo, hi = worker.dispatcher.min_bucket, worker.dispatcher.max_batch
    buckets, b = [], lo
    while b <= hi:
        buckets.append(b)
        b *= 2
    return buckets


def _forest_to_doc(f: DenseForest) -> dict:
    return {
        "feature": f.feature.tolist(),
        "threshold": f.threshold.tolist(),
        "leaf": f.leaf.tolist(),
        "depth": int(f.depth),
        "n_features": int(f.n_features),
        "classes": None if f.classes is None else f.classes.tolist(),
    }


def _forest_from_doc(d: dict) -> DenseForest:
    return DenseForest(
        feature=np.asarray(d["feature"], dtype=np.int32),
        threshold=np.asarray(d["threshold"], dtype=np.float32),
        leaf=np.asarray(d["leaf"], dtype=np.float32),
        depth=int(d["depth"]),
        n_features=int(d["n_features"]),
        classes=(None if d["classes"] is None
                 else np.asarray(d["classes"])),
    )


@dataclasses.dataclass
class BundlePoint:
    """One compiled Pareto point: config + measured objectives + model."""

    rep: FeatureRep
    cost: float
    perf: float
    fidelity: str
    aux: dict
    compile_meta: dict        # buckets warmed, compile wall, fusion mode
    forest_doc: dict          # serialized DenseForest (deploy payload)
    # live warm handle — process-local, never serialized
    pipeline: object = dataclasses.field(default=None, repr=False,
                                         compare=False)

    def forest(self) -> DenseForest:
        return _forest_from_doc(self.forest_doc)

    def build(self, *, runtime=None, warm: bool = True, device="cuda"):
        """(Re)compile this point's serving pipeline on `device`; warm it
        for the target runtime's bucket geometry unless told not to."""
        from ..traffic.pipeline import build_pipeline

        pipe = build_pipeline(
            self.rep, self.forest(), max_pkts=self.rep.depth,
            fused=bool(self.compile_meta.get("fused", True)), device=device,
        )
        if warm:
            pipe.warm(warm_buckets_for(runtime))
        self.pipeline = pipe
        return pipe

    def to_doc(self) -> dict:
        return {
            "features": list(self.rep.features),
            "depth": int(self.rep.depth),
            "cost": float(self.cost),
            "perf": float(self.perf),
            "fidelity": self.fidelity,
            "aux": self.aux,
            "compile_meta": self.compile_meta,
            "forest": self.forest_doc,
        }

    @classmethod
    def from_doc(cls, d: dict) -> "BundlePoint":
        return cls(
            rep=FeatureRep(tuple(d["features"]), int(d["depth"])),
            cost=float(d["cost"]),
            perf=float(d["perf"]),
            fidelity=d["fidelity"],
            aux=dict(d["aux"]),
            compile_meta=dict(d["compile_meta"]),
            forest_doc=d["forest"],
        )


@dataclasses.dataclass
class MultiTenantBundlePoint(BundlePoint):
    """N tenants' compiled points fused into one deployable unit
    (DESIGN.md §15).

    `rep` is the *union* FeatureRep (what the shared `FlowTable` is sized
    by), `cost` the sum of the per-tenant measured costs (the independent
    upper bound — the shared fleet's discount is what deployment buys),
    `perf` the mean per-tenant perf. `build()` compiles the shared
    `MultiTenantPipeline`, so `make_swap`/`deploy` hot-swap it into a
    live fleet through the same §9.3 quiescence path as a solo point."""

    # per-tenant {features, depth, forest} docs, deploy order == lane order
    tenant_docs: list = dataclasses.field(default_factory=list)

    @property
    def tenant_reps(self) -> tuple:
        return tuple(FeatureRep(tuple(d["features"]), int(d["depth"]))
                     for d in self.tenant_docs)

    def tenant_forests(self) -> tuple:
        return tuple(_forest_from_doc(d["forest"]) for d in self.tenant_docs)

    def build(self, *, runtime=None, warm: bool = True, device="cuda"):
        from ..traffic.multi_tenant import build_multi_tenant_pipeline

        pipe = build_multi_tenant_pipeline(
            self.tenant_reps, self.tenant_forests(),
            fused=bool(self.compile_meta.get("fused", True)), device=device,
        )
        if warm:
            pipe.warm(warm_buckets_for(runtime))
        self.pipeline = pipe
        return pipe

    def to_doc(self) -> dict:
        d = super().to_doc()
        d["kind"] = "cato_multi_tenant_point"
        d["tenants"] = self.tenant_docs
        return d

    @classmethod
    def from_doc(cls, d: dict) -> "MultiTenantBundlePoint":
        return cls(
            rep=FeatureRep(tuple(d["features"]), int(d["depth"])),
            cost=float(d["cost"]),
            perf=float(d["perf"]),
            fidelity=d["fidelity"],
            aux=dict(d["aux"]),
            compile_meta=dict(d["compile_meta"]),
            forest_doc=d["forest"],
            tenant_docs=list(d["tenants"]),
        )


def compile_multi_tenant(
    points,
    *,
    runtime=None,
    fused: bool = True,
    warm: bool = True,
    meta: Optional[dict] = None,
    device="cuda",
) -> MultiTenantBundlePoint:
    """Fuse per-tenant bundle points (each tenant front's chosen operating
    point — e.g. its `knee()`) into one multi-tenant deployable.

    The per-tenant points carry the exact measured forests, so the fused
    pipeline's lanes are bit-identical to each tenant's solo deployment;
    the union plan and the stacked-forest kernel are what change the
    cost. `deploy`/`make_swap` accept the result like any bundle point."""
    points = list(points)
    if not points:
        raise ValueError("need >= 1 tenant bundle point")
    from ..traffic.multi_tenant import union_rep

    reps = tuple(p.rep for p in points)
    fids = {p.fidelity for p in points}
    mt = MultiTenantBundlePoint(
        rep=union_rep(reps),
        cost=float(sum(p.cost for p in points)),
        perf=float(np.mean([p.perf for p in points])),
        fidelity=fids.pop() if len(fids) == 1 else "mixed",
        aux={
            "tenant_costs": [float(p.cost) for p in points],
            "tenant_perfs": [float(p.perf) for p in points],
        },
        compile_meta={"fused": fused, "n_tenants": len(points)},
        forest_doc=points[0].forest_doc,
        tenant_docs=[{
            "features": list(p.rep.features),
            "depth": int(p.rep.depth),
            "forest": p.forest_doc,
        } for p in points],
    )
    t0 = time.perf_counter()
    mt.build(runtime=runtime, warm=warm, device=device)
    mt.compile_meta.update({
        "buckets": list(warm_buckets_for(runtime)) if warm else [],
        "compile_s": round(time.perf_counter() - t0, 4),
    })
    if meta:
        mt.aux.update(meta)
    return mt


@dataclasses.dataclass
class ParetoBundle:
    """The deployable artifact: a measured Pareto front, compiled.

    `points` are sorted by cost ascending. `meta` records where the
    front came from (fidelity, scenario, shard count, measurement
    budget, surrogate fallbacks) so an operator can audit what a bundle
    claims before pushing it at traffic."""

    points: list[BundlePoint]
    meta: dict = dataclasses.field(default_factory=dict)

    # -- selection -----------------------------------------------------------
    def knee(self) -> BundlePoint:
        """The diminishing-returns point of the (cost, -perf) front."""
        Y = np.array([(p.cost, -p.perf) for p in self.points])
        return self.points[knee_index(Y)]

    def best_by_perf(self) -> BundlePoint:
        return max(self.points, key=lambda p: p.perf)

    def best_by_cost(self) -> BundlePoint:
        return min(self.points, key=lambda p: p.cost)

    # -- serialization -------------------------------------------------------
    def to_doc(self) -> dict:
        return {
            "kind": "cato_pareto_bundle",
            "version": 1,
            "meta": self.meta,
            "points": [p.to_doc() for p in self.points],
        }

    @classmethod
    def from_doc(cls, d: dict) -> "ParetoBundle":
        if d.get("kind") != "cato_pareto_bundle":
            raise ValueError(f"not a ParetoBundle document: {d.get('kind')!r}")
        return cls(
            points=[BundlePoint.from_doc(p) for p in d["points"]],
            meta=dict(d["meta"]),
        )

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_doc()) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "ParetoBundle":
        return cls.from_doc(json.loads(pathlib.Path(path).read_text()))


def compile_front(
    result: CatoResult,
    profiler,
    *,
    runtime=None,
    fused: bool = True,
    warm: bool = True,
    max_points: Optional[int] = None,
    meta: Optional[dict] = None,
    device="cuda",
) -> ParetoBundle:
    """Compile the measured-fidelity Pareto set of `result` into a bundle.

    `profiler` must be the `TrafficProfiler` the optimization evaluated
    through: its `perf_f1` cache returns the exact seeded forest each
    front point was measured with, so the deployed model *is* the
    measured model. `runtime` (optional) fixes the warm-bucket geometry
    to the deployment fleet's dispatcher; `warm=False` skips bucket
    pre-compilation (the pipeline still compiles lazily on first use).
    `max_points` keeps only the front's best-spread subset — both
    extremes and the knee always survive, so the result has
    max(max_points, 3) points — when compiling every point would be
    wasteful.
    """
    front: list[Observation] = result.pareto_observations()
    if not front:
        raise ValueError("result has no measured observations to compile")
    if max_points is not None and len(front) > max_points:
        # both extremes and the knee are always kept (so the bundle is
        # never smaller than 3 points, even for max_points < 3); the
        # remaining quota fills with an even spread over the front
        keep = {0, len(front) - 1,
                knee_index(np.array([o.objectives for o in front]))}
        for i in np.linspace(0, len(front) - 1, max_points).round():
            if len(keep) >= max_points:
                break
            keep.add(int(i))
        front = [front[i] for i in sorted(keep)]
    buckets = warm_buckets_for(runtime)
    points = []
    for o in front:
        f1, forest = profiler.perf_f1(o.x)  # cache hit: the measured model
        from ..traffic.pipeline import build_pipeline

        t0 = time.perf_counter()
        pipe = build_pipeline(o.x, forest, max_pkts=o.x.depth, fused=fused,
                              device=device)
        if warm:
            pipe.warm(buckets)
        compile_s = time.perf_counter() - t0
        points.append(BundlePoint(
            rep=o.x,
            cost=o.cost,
            perf=o.perf,
            fidelity=o.fidelity,
            aux=dict(o.aux),
            compile_meta={
                "buckets": list(buckets) if warm else [],
                "compile_s": round(compile_s, 4),
                "fused": fused,
                "n_trees": forest.n_trees,
                "forest_depth": forest.depth,
            },
            forest_doc=_forest_to_doc(forest),
            pipeline=pipe,
        ))
    points.sort(key=lambda p: p.cost)
    bundle_meta = {
        "measured_fidelity": result.measured_fidelity,
        "fidelity_counts": result.fidelity_counts,
        "surrogate_fallbacks": len(result.surrogate_fallbacks),
        "budget": result.budget,
        "scenario": getattr(profiler, "scenario", None),
        "n_shards": getattr(profiler, "n_shards", None),
        "cost_mode": getattr(profiler, "cost_mode", None),
    }
    if meta:
        bundle_meta.update(meta)
    return ParetoBundle(points=points, meta=bundle_meta)


def make_swap(
    point: BundlePoint,
    *,
    after_pkts: int = 0,
    runtime=None,
    service=None,
    audit=None,
    session=None,
    now_pkts: float = 0.0,
    device="cuda",
):
    """Schedule `point` as a zero-downtime `PipelineSwap` (DESIGN.md §9.3).

    Reuses the bundle's compiled pipeline handle when present
    (compile-once), but always (re-)warms it for the *target* runtime's
    bucket geometry: a handle warmed elsewhere for a smaller `max_batch`
    would pay a bucket's first use on the serving path mid-swap —
    exactly the stall the warm protocol exists to prevent. Re-warming an
    already-warm bucket only replays a zero batch, so the ensure is
    cheap. A point without a handle is built on `device`. `service`
    defaults to the modeled clock constants for the point's (F, n) —
    pass measured constants for calibrated replay. A `session` (or the
    deprecated bare ``audit=``) records the scheduling decision against
    `now_pkts` — the replay packet clock (canonical definition in
    `repro_torch.serve.control.plane`) at which the decision was made."""
    from .control.plane import PipelineSwap
    from .runtime.replay import ServiceModel
    from .session import ServeSession

    audit = ServeSession.coerce(session, audit=audit,
                                warn=False).resolve_audit()
    pipe = point.pipeline or point.build(runtime=runtime, warm=False,
                                         device=device)
    pipe.warm(warm_buckets_for(runtime))
    if service is None:
        t_reps = getattr(point, "tenant_reps", None)
        if t_reps:
            service = ServiceModel.modeled_multi_tenant(
                t_reps, point.tenant_forests())
        else:
            service = ServiceModel.modeled(point.rep, point.forest())
    if audit is not None:
        audit.record(
            "swap_scheduled", now_pkts,
            f"bundle point (|F|={len(point.rep.features)}, "
            f"n={point.rep.depth}) armed to swap after "
            f"{after_pkts} pkts",
            {
                "features": list(point.rep.features),
                "depth": int(point.rep.depth),
                "cost": float(point.cost),
                "perf": float(point.perf),
                "fidelity": point.fidelity,
                "after_pkts": int(after_pkts),
                "service": service.source,
            },
        )
    return PipelineSwap(pipeline=pipe, service=service, after_pkts=after_pkts)


def deploy(point: BundlePoint, runtime, now_pkts: float, *, audit=None,
           session=None, device="cuda"):
    """Hot-swap `point` into a live runtime immediately.

    `runtime` is a `StreamingRuntime` or `ShardedRuntime`; the swap goes
    through the §9.3 drain-and-swap quiescence protocol, so in-flight
    flows resolve under the old pipeline and no flow is dropped or
    predicted twice. `now_pkts` is the replay packet clock (canonical
    definition in `repro_torch.serve.control.plane`) at the swap edge. Warm
    coverage for `runtime`'s bucket geometry is ensured first (see
    `make_swap`), so the swap pays no compile on the serving path.
    Returns the quiesce flush records (list for a single worker,
    {shard: records} for a fleet) so a replay clock can charge them to
    the right lanes. Pass a `session` (or the deprecated bare
    ``audit=``) to record the deployment (DESIGN.md §11.3)."""
    from .session import ServeSession

    audit = ServeSession.coerce(session, audit=audit).resolve_audit()
    pipe = point.pipeline or point.build(runtime=runtime, warm=False,
                                         device=device)
    pipe.warm(warm_buckets_for(runtime))
    recs = runtime.hot_swap(pipe, now_pkts)
    if audit is not None:
        flushes = (sum(len(r) for r in recs.values())
                   if isinstance(recs, dict) else len(recs))
        audit.record(
            "deploy", now_pkts,
            f"immediate hot-swap of bundle point "
            f"(|F|={len(point.rep.features)}, n={point.rep.depth})",
            {
                "features": list(point.rep.features),
                "depth": int(point.rep.depth),
                "cost": float(point.cost),
                "perf": float(point.perf),
                "fidelity": point.fidelity,
                "quiesce_flushes": flushes,
            },
        )
    return recs
