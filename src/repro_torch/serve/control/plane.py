"""The serving control plane: telemetry -> planner -> actuation
(DESIGN.md §9).

Port of `repro.serve.control.plane`, unchanged but for its imports and the
device of `PipelineSwap.build`.

`ControlPlane` closes the loop the static `ShardedRuntime` leaves open:
it watches per-RETA-bucket load (`BucketTelemetry`), and every
`interval_pkts` ingested packets it may

1. **hot-swap** the pipeline (a scheduled `PipelineSwap` — e.g. a new
   Pareto-optimal (F, n) from `CatoOptimizer` compiled in the
   background) via the per-shard drain-and-swap protocol;
2. **resize the fleet** under a `HeadroomPolicy` (add workers when the
   offered load crowds the utilization target, retire the coldest one —
   after migrating its buckets away — when the load would comfortably
   fit on fewer);
3. **rebalance the RETA** (greedy bucket-migration plan, applied through
   the quiescent flow-state migration protocol so no flow is lost,
   double-predicted, or misrouted mid-flow).

The plane is clock-agnostic: it mutates the runtime and returns a
`StepReport` describing what happened; the replay loop (or a live
serving loop) interprets the report — charging flush records and
migration costs to the right worker's lanes, retargeting service
constants after a swap. Control cadence is counted in *packets*, not
seconds, so decisions are invariant under replay clock compression and
zero-loss bisection probes stay comparable across offered rates.

**The clock argument (`now_pkts`) — canonical definition.** Every time
value crossing the control surface (`maybe_step`, audit events, tracer
instants, `deploy`) is the *replay packet clock*: virtual time, in
seconds at the offered rate, advanced only by packet deliveries — never
wall time. The name carries the provenance (the packet stream drives
it), the unit stays seconds so durations and rates divide out naturally.
Workers' internal lane clocks (`dispatch.py`, `flow_table.py`) keep
their own `now` — they never cross this surface. Under a `ReoptimizerPolicy`
(`reoptimizer.py`) the plane also closes the adaptation loop: after its
own actuations each step, it lets the policy threshold the run's drift
signal, and a fired episode schedules its re-optimized pipeline through
`schedule_swap` — so autonomous re-deployments ride the same audited,
packet-counted swap path as operator-scheduled ones.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..runtime.dispatch import BatchRecord
from ..runtime.replay import ServiceModel
from ..runtime.shard import ShardedRuntime

from .planner import HeadroomPolicy, plan_rebalance, plan_retirement
from .telemetry import BucketTelemetry

__all__ = ["ControlConfig", "ControlPlane", "PipelineSwap", "StepReport"]


@dataclasses.dataclass
class PipelineSwap:
    """A scheduled zero-downtime pipeline replacement.

    `pipeline` is the new compiled artifact (warm it with
    `ServingPipeline.warm` so the swap never pays a compile on the
    serving path); `service` carries the replay-clock constants of the
    new configuration (its feature set and depth change both per-packet
    and per-batch costs); `after_pkts` triggers the swap once the fleet
    has ingested that many packets."""

    pipeline: object
    service: ServiceModel
    after_pkts: int = 0

    @classmethod
    def build(
        cls,
        rep,
        forest,
        *,
        after_pkts: int = 0,
        service: Optional[ServiceModel] = None,
        fused: bool = True,
        use_kernel: bool = True,
        runtime=None,
        warm_buckets: Optional[tuple] = None,
        device="cuda",
    ) -> "PipelineSwap":
        """Optimizer handoff: turn a Pareto-optimal (F, n) into a ready
        swap.

        `rep`/`forest` come straight from a `CatoOptimizer` observation
        (`o.x` and the profiler's trained model for it); this compiles
        the serving pipeline, pre-warms every dispatch bucket so the
        swap pays no first use on the serving path, and derives modeled clock
        constants unless measured ones are supplied. Pass the target
        `runtime` (sharded or single) so the warm set is *its*
        dispatcher's actual bucket geometry — a hard-coded default
        would leave a non-default `max_batch`/`min_bucket` fleet paying
        a compile on the serving path at swap time. The pipeline is built
        on `device` (the card unless the caller asks for the CPU) and
        warmed there."""
        from ..deploy import warm_buckets_for
        from ...traffic.pipeline import build_pipeline

        if warm_buckets is None:
            warm_buckets = warm_buckets_for(runtime)
        pipeline = build_pipeline(rep, forest, max_pkts=rep.depth,
                                  fused=fused, use_kernel=use_kernel,
                                  device=device)
        pipeline.warm(list(warm_buckets))
        if service is None:
            service = ServiceModel.modeled(rep, forest)
        return cls(pipeline=pipeline, service=service, after_pkts=after_pkts)


@dataclasses.dataclass
class ControlConfig:
    """Knobs for one control loop instance."""

    interval_pkts: int = 1024          # control period, in ingested packets
    ewma_alpha: float = 0.4            # telemetry smoothing
    rebalance: bool = True
    imbalance_trigger: float = 1.10    # act when max/mean EWMA load above this
    max_moves_per_step: int = 8
    # state-copy cost charged per migrated flow, in accumulated-packet
    # service-time equivalents: a flow's dense state is one ~KB row copy
    # plus two index updates — about what one packet accumulate costs
    # (which includes its own hash probe and row write). Scaling by the
    # service model keeps the charge honest under both modeled (ns-scale)
    # and measured (µs-scale) clock constants.
    migrate_cost_pkts: float = 1.0
    headroom: Optional[HeadroomPolicy] = None
    swap: Optional[PipelineSwap] = None


@dataclasses.dataclass
class StepReport:
    """What one control step did — the replay loop's charging manifest."""

    t: float
    records: dict[int, list[BatchRecord]] = dataclasses.field(
        default_factory=dict)
    ingest_charge_s: dict[int, float] = dataclasses.field(default_factory=dict)
    service_switch: dict[int, ServiceModel] = dataclasses.field(
        default_factory=dict)
    buckets_moved: int = 0
    flows_migrated: int = 0
    swapped: bool = False
    workers_added: list[int] = dataclasses.field(default_factory=list)
    workers_retired: list[int] = dataclasses.field(default_factory=list)


class ControlPlane:
    def __init__(
        self,
        runtime: ShardedRuntime,
        config: ControlConfig,
        service: ServiceModel,
        *,
        audit=None,
        tracer=None,
        session=None,
    ):
        from ..session import ServeSession

        session = ServeSession.coerce(session, audit=audit, tracer=tracer,
                                      warn=False)
        self.rt = runtime
        self.cfg = config
        self.service = service  # current constants (retargeted on swap)
        self.telemetry = BucketTelemetry(alpha=config.ewma_alpha)
        # decision audit log (DESIGN.md §11.3): every actuation below is
        # recorded with its rationale and before/after load snapshot; an
        # external Observability bundle (via the session) passes its own
        # log in so one run yields one audit stream
        audit = session.resolve_audit()
        if audit is None:
            from ..obs.audit import AuditLog

            audit = AuditLog()
        self.audit = audit
        self.tracer = session.tracer
        # drift-triggered re-optimization (DESIGN.md §13): the policy is
        # reset per plane (one plane = one run), bound to the session's
        # drift monitor — the same sketches the dispatchers feed
        self.reopt = session.reopt
        if self.reopt is not None:
            self.reopt.reset(drift=session.drift)
        # SLO verdicts + export (DESIGN.md §14): the shared tracker the
        # worker clocks feed is *checked* here at control-step cadence —
        # breach edges are audited (kind "slo") and the verdict gauges
        # published through the telemetry registry; a bound exporter
        # appends one JSONL record per executed step
        self.slo = session.slo
        self.n_slo_breaches = 0
        self.exporter = session.exporter
        if self.exporter is not None:
            self.exporter.bind(self._export_registry, slo=self.slo)
        self._pending_swap: Optional[PipelineSwap] = config.swap
        self._pkts_since = 0
        self._last_step_t: Optional[float] = None
        self._pps_ewma = 0.0
        # counters for the run summary
        self.n_steps = 0
        self.n_rebalances = 0
        self.buckets_moved = 0
        self.flows_migrated = 0
        self.buckets_skipped = 0
        self.n_swaps = 0
        # packets ingested fleet-wide when the scheduled swap actually
        # fired (control steps run on block cadence, so this is >= the
        # requested after_pkts): callers checking post-swap invariants
        # need the real boundary, not the requested one
        self.swap_at_pkts: Optional[int] = None
        self.workers_added = 0
        self.workers_retired = 0
        self.log: list[dict] = []

    # -- data-path hooks -----------------------------------------------------

    def note(self, keys: np.ndarray, buckets: np.ndarray) -> None:
        """Account one ingest block: steering ledger + bucket telemetry."""
        self.rt.note_steering(keys, buckets)
        self.telemetry.note(buckets)
        self._pkts_since += len(buckets)

    def schedule_swap(self, swap: PipelineSwap) -> None:
        """Arm a pipeline swap to fire once the fleet's ingested-packet
        count reaches ``swap.after_pkts`` (checked on control-step
        cadence, so the actual fire point lands on the next step
        boundary at or after it). One swap may be pending at a time —
        the plane refuses to silently drop an armed deployment."""
        if self._pending_swap is not None:
            raise RuntimeError(
                "a pipeline swap is already pending (after_pkts="
                f"{self._pending_swap.after_pkts}); the armed deployment "
                "must fire or be cleared before another is scheduled")
        self._pending_swap = swap

    def maybe_step(self, now_pkts: float) -> Optional[StepReport]:
        """Run a control step if a full interval of packets has arrived.

        `now_pkts` is the replay packet clock (module docstring) — the
        virtual time of the block edge that completed the interval."""
        if self._pkts_since < self.cfg.interval_pkts:
            return None
        cfg = self.cfg
        rt = self.rt
        window_pkts = self._pkts_since
        rates = self.telemetry.roll()
        self._pkts_since = 0
        report = StepReport(t=now_pkts)
        self.n_steps += 1

        # offered-rate estimate for the headroom policy (EWMA of pps over
        # the interval wall time; first step has no baseline interval)
        if self._last_step_t is not None and now_pkts > self._last_step_t:
            win_pps = window_pkts / (now_pkts - self._last_step_t)
            self._pps_ewma = (cfg.ewma_alpha * win_pps
                              + (1 - cfg.ewma_alpha) * self._pps_ewma
                              if self._pps_ewma > 0 else win_pps)
        self._last_step_t = now_pkts

        # 1. pending pipeline hot-swap (operator-scheduled via the config,
        # or armed mid-run by the reoptimizer through schedule_swap)
        swap = self._pending_swap
        if swap is not None and self.telemetry.total_pkts >= swap.after_pkts:
            before = self._loads_doc()
            recs = rt.hot_swap(swap.pipeline, now_pkts)
            self._merge_records(report, recs)
            for i in range(len(rt.shards)):
                report.service_switch[i] = swap.service
            self.service = swap.service
            self._pending_swap = None
            report.swapped = True
            self.n_swaps += 1
            self.swap_at_pkts = int(self.telemetry.total_pkts)
            self._audit(
                "hot_swap", now_pkts,
                f"scheduled swap armed at {swap.after_pkts} pkts; fleet "
                f"has ingested {self.swap_at_pkts}",
                {
                    "quiesce_flushes": sum(len(r) for r in recs.values()),
                    "shards": len(rt.shards),
                    "new_service": swap.service.source,
                },
                before=before,
            )

        # 2. elastic fleet sizing
        if cfg.headroom is not None and self._pps_ewma > 0:
            from ..runtime.shard import INDIRECTION_SIZE

            cap_pps = 1e9 / max(self.service.pkt_accum_ns, 1e-3)
            n_active = sum(rt.active)
            desired = cfg.headroom.desired_workers(
                self._pps_ewma, cap_pps, n_active)
            # the RETA is the steering quantum: more workers than entries
            # can never receive load (add_worker enforces the same bound)
            desired = min(desired, INDIRECTION_SIZE)
            n_before = sum(rt.active)
            size_before = (self._loads_doc() if desired != n_before else None)
            while desired > sum(rt.active):
                # reactivate a drained retired worker before minting a new
                # replica: flapping load must not grow the shard list
                retired = [i for i, a in enumerate(rt.active) if not a]
                if retired:
                    i = retired[0]
                    rt.active[i] = True
                elif len(rt.shards) < INDIRECTION_SIZE:
                    i = rt.add_worker()
                else:
                    break
                report.workers_added.append(i)
                self.workers_added += 1
            if report.workers_added:
                self._audit(
                    "scale_out", now_pkts,
                    f"offered {self._pps_ewma:.0f} pps vs {cap_pps:.0f} "
                    f"pps/worker capacity wants {desired} workers "
                    f"(had {n_before})",
                    {
                        "workers_added": list(report.workers_added),
                        "pps_ewma": round(self._pps_ewma, 1),
                        "cap_pps": round(cap_pps, 1),
                        "desired": desired,
                    },
                    before=size_before,
                )
            if desired < sum(rt.active):
                # one retirement per step: pick the coldest active worker,
                # evacuate its buckets, then mark it inactive
                loads = self.telemetry.shard_loads(rt.indirection,
                                                   len(rt.shards))
                act = [i for i, a in enumerate(rt.active) if a]
                coldest = min(act, key=lambda i: loads[i])
                moves = plan_retirement(rates, rt.indirection, coldest,
                                        rt.active)
                pre_fm = report.flows_migrated
                self._apply_moves(report, moves, now_pkts)
                if not np.any(rt.indirection == coldest):
                    rt.active[coldest] = False
                    report.workers_retired.append(coldest)
                    self.workers_retired += 1
                    self._audit(
                        "retire", now_pkts,
                        f"load fits {desired} workers; evacuated coldest "
                        f"worker {coldest} "
                        f"(ewma load {float(loads[coldest]):.1f})",
                        {
                            "worker": coldest,
                            "buckets_evacuated": len(moves),
                            "flows_migrated":
                                report.flows_migrated - pre_fm,
                            "pps_ewma": round(self._pps_ewma, 1),
                            "desired": desired,
                        },
                        before=size_before,
                    )

        # 3. RETA rebalancing
        if cfg.rebalance:
            moves = plan_rebalance(
                rates, rt.indirection, rt.active,
                max_moves=cfg.max_moves_per_step,
                trigger=cfg.imbalance_trigger,
            )
            if moves:
                before_rb = self._loads_doc()
                pre_bm = report.buckets_moved
                pre_fm = report.flows_migrated
                self.n_rebalances += 1
                self._apply_moves(report, moves, now_pkts)
                self._audit(
                    "rebalance", now_pkts,
                    f"imbalance {before_rb['imbalance']:.3f} over trigger "
                    f"{cfg.imbalance_trigger:.3f}; planned "
                    f"{len(moves)} bucket moves",
                    {
                        "moves_planned": len(moves),
                        "buckets_moved": report.buckets_moved - pre_bm,
                        "flows_migrated": report.flows_migrated - pre_fm,
                        "trigger": cfg.imbalance_trigger,
                    },
                    before=before_rb,
                )

        # 4. drift-triggered re-optimization (DESIGN.md §13): after this
        # step's actuations, let the policy read the drift sketches and —
        # when an excursion has dwelt long enough — run its shadow
        # re-tune and arm the resulting swap. The swap itself fires
        # through section 1 on a *later* step, so episodes interleave
        # with the replay packet clock exactly like operator swaps.
        if self.reopt is not None:
            self.reopt.maybe_step(self, now_pkts)

        # 5. SLO verdict (DESIGN.md §14.2): fold the shared tracker's
        # windows at this step's clock edge, publish the verdict into the
        # telemetry registry projection, and audit breach *edges* — one
        # "slo" event per breach episode, zero when the objective is met.
        if self.slo is not None:
            v = self.slo.check(now_pkts)
            self.telemetry.publish("slo_attainment_fast", v.attainment_fast)
            self.telemetry.publish("slo_attainment_slow", v.attainment_slow)
            self.telemetry.publish("slo_burn_fast", v.burn_fast)
            self.telemetry.publish("slo_burn_slow", v.burn_slow)
            self.telemetry.publish("slo_breached", 1.0 if v.breached else 0.0)
            if v.new_breach:
                self.n_slo_breaches += 1
                self._audit(
                    "slo", now_pkts,
                    f"attainment {v.attainment_fast:.4f} under objective "
                    f"{v.objective:.4f} for target {v.target_s * 1e6:.0f}µs; "
                    f"burn fast {v.burn_fast:.1f}x / slow {v.burn_slow:.1f}x "
                    f"of error budget",
                    v.to_doc(),
                )

        # 6. export tick: one JSONL record per executed control step
        if self.exporter is not None:
            self.exporter.step(now_pkts)

        if (report.buckets_moved or report.swapped or report.workers_added
                or report.workers_retired):
            self.log.append({
                "now_pkts": now_pkts,
                "buckets_moved": report.buckets_moved,
                "flows_migrated": report.flows_migrated,
                "swapped": report.swapped,
                "workers_added": list(report.workers_added),
                "workers_retired": list(report.workers_retired),
            })
        return report

    # -- internals -----------------------------------------------------------

    def _export_registry(self):
        """The exporter's pull view: the merged fleet registry plus the
        telemetry and SLO projections, one namespace per pull."""
        from ..obs import fleet_registry

        reg = fleet_registry(self.rt)
        self.telemetry.to_registry(registry=reg)
        if self.slo is not None:
            self.slo.to_registry(registry=reg)
        return reg

    def _loads_doc(self) -> dict:
        """Snapshot of the planner's view: per-shard EWMA load projected
        through the current RETA, plus the imbalance statistic it acts
        on. Attached to audit events as the before/after state."""
        rt = self.rt
        loads = self.telemetry.shard_loads(rt.indirection, len(rt.shards))
        act = [i for i, a in enumerate(rt.active) if a]
        mean = float(loads[act].mean()) if act else 0.0
        return {
            "shard_loads_ewma": [round(float(x), 3) for x in loads],
            "active_workers": act,
            "imbalance": round(float(loads[act].max() / mean), 4)
            if act and mean > 0 else 1.0,
        }

    def _audit(self, kind: str, now_pkts: float, rationale: str,
               detail: Optional[dict] = None, *, before=None,
               after=None) -> None:
        if after is None and before is not None:
            after = self._loads_doc()
        self.audit.record(kind, now_pkts, rationale, detail,
                          before=before, after=after)
        if self.tracer is not None and self.tracer.enabled:
            from ..obs.trace import TID_CONTROL

            self.tracer.instant(f"control.{kind}", now_pkts, pid=0,
                                tid=TID_CONTROL)

    def _apply_moves(self, report: StepReport, moves: dict,
                     now_pkts: float) -> None:
        rep = self.rt.migrate_buckets(moves, now_pkts)
        for shard, recs in rep["records"].items():
            report.records.setdefault(shard, []).extend(recs)
        cost = (self.cfg.migrate_cost_pkts
                * self.service.pkt_accum_ns * 1e-9)
        for shard, n in rep["flows_out"].items():
            report.ingest_charge_s[shard] = (
                report.ingest_charge_s.get(shard, 0.0) + n * cost)
        for shard, n in rep["flows_in"].items():
            report.ingest_charge_s[shard] = (
                report.ingest_charge_s.get(shard, 0.0) + n * cost)
        report.buckets_moved += rep["buckets_moved"]
        report.flows_migrated += rep["flows_migrated"]
        self.buckets_moved += rep["buckets_moved"]
        self.buckets_skipped += rep["buckets_skipped"]
        self.flows_migrated += rep["flows_migrated"]

    @staticmethod
    def _merge_records(report: StepReport, recs: dict) -> None:
        for shard, rs in recs.items():
            report.records.setdefault(shard, []).extend(rs)

    def summary(self) -> dict:
        out = {
            "steps": self.n_steps,
            "rebalances": self.n_rebalances,
            "buckets_moved": self.buckets_moved,
            "buckets_skipped": self.buckets_skipped,
            "flows_migrated": self.flows_migrated,
            "swaps": self.n_swaps,
            "swap_at_pkts": self.swap_at_pkts,
            "workers_added": self.workers_added,
            "workers_retired": self.workers_retired,
            "active_workers": sum(self.rt.active),
        }
        if self.reopt is not None:
            out["reopt"] = self.reopt.summary()
        if self.slo is not None:
            out["slo_breaches"] = self.n_slo_breaches
            out["slo_attainment"] = round(self.slo.attainment, 6)
        return out
