"""Drift-triggered background re-optimization: the self-optimizing fleet
(DESIGN.md §13).

Port of `repro.serve.control.reoptimizer`, unchanged but for its imports
and the device: the trigger carries the live fleet's device, and
`cato_retuner` compiles the new front there.

Without it the deployment story ends at "compile the Pareto front and
hot-swap the knee" — a fleet that is optimal for the traffic it was
tuned on and frozen thereafter. Real traffic drifts. This module closes
the last loop: it consumes the `DriftMonitor`'s signal → trigger API
(`check()`), and when drift holds above threshold long enough, it runs a
budgeted *shadow* re-optimization (a fresh `CatoOptimizer` over a
profiler built from the traffic seen so far, warm-started from the
deployed bundle's observations) and pushes the new knee through the
existing zero-downtime `make_swap` path — so the whole measure →
optimize → compile → deploy → adapt cycle runs as one system, on the
deterministic replay packet clock.

Episode state machine (thrash-proof by construction)::

    IDLE --trigger--> DWELL --min_dwell_pkts held--> FIRE --> COOLDOWN
      ^                 | signal released                        |
      +--(hysteresis)---+            (cooldown_pkts elapsed) ----+

- **IDLE → DWELL** when `DriftVerdict.triggered` (a signal crossed its
  threshold, EWMAs warmed up).
- **DWELL → IDLE** when the verdict disarms — the signal fell below
  ``threshold * release_frac`` (hysteresis: one quiet batch inside the
  band does not release).
- **DWELL → FIRE** once the signal has held for `min_dwell_pkts`
  ingested packets: run the re-tune, schedule the swap for the next
  control step, audit the episode, `rebaseline()` the monitor (so the
  fix does not re-trigger on itself).
- **FIRE → COOLDOWN** for `cooldown_pkts` packets: back-to-back swaps
  are structurally impossible regardless of what the signal does.

The re-tune is *shadow-evaluated*: it runs against its own runtimes and
datasets, never the live fleet. `ReoptimizerPolicy` enforces this at
runtime — the live fleet's packet and prediction counters are snapshotted
around the re-tune callable, and any movement raises. Every episode is
recorded in the audit log (kind ``"reopt"``: trigger rationale,
drift magnitudes, budget spent, old-vs-new knee objectives) and exposed
as ``reopt.*`` registry metrics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

__all__ = ["ReoptOutcome", "ReoptimizerConfig", "ReoptimizerPolicy",
           "cato_retuner"]


@dataclasses.dataclass
class ReoptimizerConfig:
    """Knobs for the drift → re-tune → deploy policy."""

    class_threshold: float = 0.25       # class-mix TV distance trigger
    feature_threshold: float = float("inf")  # feature shift (σ units), off
    release_frac: float = 0.5           # hysteresis release band
    min_dwell_pkts: int = 2048          # signal must hold this long to fire
    cooldown_pkts: int = 1 << 16        # refractory period after a fire
    max_episodes: int = 1               # episodes per run
    swap_delay_pkts: int = 0            # extra packets before the swap arms


@dataclasses.dataclass
class ReoptOutcome:
    """What one re-tune produced: the point to deploy, plus its receipts."""

    point: object                       # BundlePoint — the new knee
    service: Optional[object] = None    # ServiceModel (modeled if None)
    budget: dict = dataclasses.field(default_factory=dict)
    old_objectives: Optional[tuple] = None  # (cost, perf) of the old knee
    new_objectives: Optional[tuple] = None  # (cost, perf) of the new knee
    detail: dict = dataclasses.field(default_factory=dict)


class ReoptimizerPolicy:
    """Threshold drift signals into audited re-optimization episodes.

    `retune` is the episode body: a callable taking one trigger document
    (drift verdict + signal, packet clock, episode index) and returning a
    `ReoptOutcome`. `cato_retuner` builds the standard one (warm-started
    multi-fidelity BO → `compile_front` → knee); tests substitute
    cheaper bodies. `drift` binds the monitored `DriftMonitor` — usually
    injected by the `ControlPlane` from the run's session, so one policy
    object can serve repeated replays (each plane construction calls
    `reset()`).
    """

    def __init__(
        self,
        retune: Callable[[dict], ReoptOutcome],
        config: Optional[ReoptimizerConfig] = None,
        *,
        drift=None,
    ):
        self.retune = retune
        self.cfg = config or ReoptimizerConfig()
        self.drift = drift
        self.reset()

    def reset(self, drift=None) -> None:
        """Start a fresh run: state machine to IDLE, counters to zero.

        The policy object itself is reusable across replays (zero-loss
        bisection probes build a fresh plane per probe); per-run episode
        history does not leak between them."""
        if drift is not None:
            self.drift = drift
        self.state = "idle"
        self.episodes: list[dict] = []
        self.n_checks = 0
        self.n_triggers = 0
        self.n_disarmed = 0
        self.n_suppressed_cooldown = 0
        self.retune_wall_s = 0.0
        self.last_verdict = None
        self._dwell_start_pkts = 0
        self._cooldown_until_pkts = 0

    # -- the control-step hook ----------------------------------------------

    def maybe_step(self, plane, now_pkts: float) -> Optional[dict]:
        """Advance the episode state machine one control step.

        Called by `ControlPlane.maybe_step` after its own actuations, so
        episodes interleave deterministically with the replay packet
        clock: a fired episode's swap is scheduled here and executes on
        the *next* control step through the plane's normal swap path.
        Returns the episode record when one fired, else None."""
        if self.drift is None:
            return None
        cfg = self.cfg
        pkts = int(plane.telemetry.total_pkts)
        self.n_checks += 1
        if self.state == "cooldown":
            if pkts < self._cooldown_until_pkts:
                self.n_suppressed_cooldown += 1
                return None
            self.state = "idle"
        if len(self.episodes) >= cfg.max_episodes:
            return None
        verdict = self.drift.check(
            cfg.class_threshold, cfg.feature_threshold,
            release_frac=cfg.release_frac)
        self.last_verdict = verdict
        if self.state == "idle" and verdict.triggered:
            self.state = "dwell"
            self._dwell_start_pkts = pkts
            self.n_triggers += 1
        if self.state == "dwell":
            if not verdict.armed:
                # hysteresis release: the excursion ended before the
                # dwell filled — no episode, back to watching
                self.state = "idle"
                self.n_disarmed += 1
                return None
            if pkts - self._dwell_start_pkts >= cfg.min_dwell_pkts:
                return self._fire(plane, now_pkts, pkts, verdict)
        return None

    # -- episode body --------------------------------------------------------

    def _fire(self, plane, now_pkts: float, pkts: int, verdict) -> dict:
        """One audited episode: shadow re-tune, schedule swap, cool down."""
        from ..deploy import make_swap

        cfg = self.cfg
        guard_before = self._live_counters(plane.rt)
        t0 = time.perf_counter()
        outcome = self.retune({
            "episode": len(self.episodes),
            "now_pkts": float(now_pkts),
            "pkts_ingested": pkts,
            "verdict": verdict.to_doc(),
            "signal": self.drift.signal(),
            "device": str(plane.rt.pipeline.device),
        })
        wall = time.perf_counter() - t0
        self.retune_wall_s += wall
        guard_after = self._live_counters(plane.rt)
        if guard_after != guard_before:
            raise RuntimeError(
                "shadow re-tune evaluated on the live fleet: packet/"
                f"prediction counters moved {guard_before} -> {guard_after} "
                "during the episode. Re-tune bodies must profile through "
                "their own runtimes (DESIGN.md §13.2).")

        after_pkts = pkts + cfg.swap_delay_pkts
        swap = make_swap(
            outcome.point, after_pkts=after_pkts, runtime=plane.rt,
            service=outcome.service, audit=plane.audit, now_pkts=now_pkts)
        plane.schedule_swap(swap)

        detail = {
            "episode": len(self.episodes),
            "pkts_ingested": pkts,
            "drift": verdict.to_doc(),
            "budget": outcome.budget,
            "old_knee": outcome.old_objectives,
            "new_knee": outcome.new_objectives,
            "retune_wall_s": round(wall, 4),
            "swap_after_pkts": after_pkts,
            "cooldown_until_pkts": pkts + cfg.cooldown_pkts,
        }
        detail.update(outcome.detail)
        plane._audit(
            "reopt", now_pkts,
            f"class-mix shift {verdict.class_mix_shift:.3f} >= "
            f"{cfg.class_threshold:.3f} held {pkts - self._dwell_start_pkts} "
            f"pkts (dwell floor {cfg.min_dwell_pkts}); re-tuned and "
            f"scheduled the new knee after {after_pkts} pkts",
            detail,
        )
        # the new pipeline's prediction mix is *supposed* to differ:
        # re-anchor the baseline so the fix cannot re-trigger on itself
        self.drift.rebaseline()
        self.state = "cooldown"
        self._cooldown_until_pkts = pkts + cfg.cooldown_pkts
        record = dict(detail)
        self.episodes.append(record)
        return record

    @staticmethod
    def _live_counters(rt) -> tuple:
        """The shadow-evaluation guard's snapshot of the live fleet."""
        m = rt.metrics
        if hasattr(m, "merged"):  # AggregateMetrics (sharded fleet)
            m = m.merged()
        return (m.pkts_total, m.flows_predicted, m.batches)

    # -- reporting -----------------------------------------------------------

    def summary(self) -> dict:
        return {
            "state": self.state,
            "episodes": len(self.episodes),
            "checks": self.n_checks,
            "triggers": self.n_triggers,
            "disarmed": self.n_disarmed,
            "suppressed_cooldown": self.n_suppressed_cooldown,
            "retune_wall_s": round(self.retune_wall_s, 4),
        }

    def to_registry(self, reg=None):
        """Project the policy's counters as ``reopt.*`` metrics."""
        if reg is None:
            from ..obs.registry import MetricsRegistry

            reg = MetricsRegistry()
        reg.set_counter("reopt.episodes", len(self.episodes))
        reg.set_counter("reopt.checks", self.n_checks)
        reg.set_counter("reopt.triggers", self.n_triggers)
        reg.set_counter("reopt.disarmed", self.n_disarmed)
        reg.set_counter("reopt.suppressed_cooldown",
                        self.n_suppressed_cooldown)
        reg.set_gauge("reopt.retune_wall_s", self.retune_wall_s,
                      reduce="sum")
        if self.last_verdict is not None:
            reg.set_gauge("reopt.last_class_shift",
                          self.last_verdict.class_mix_shift, reduce="max")
            reg.set_gauge("reopt.last_feature_shift",
                          self.last_verdict.feature_shift, reduce="max")
        return reg


def cato_retuner(
    make_profiler: Callable[[dict], object],
    space,
    *,
    priors=None,
    fidelities: tuple = ("modeled",),
    measure_budget: int = 4,
    batch_size: int = 4,
    n_init: int = 3,
    seed: int = 0,
    warm_from=None,
    baseline=None,
    max_points: int = 4,
    fused: bool = True,
    runtime=None,
) -> Callable[[dict], ReoptOutcome]:
    """Build the standard CATO re-tune body for `ReoptimizerPolicy`.

    Per episode it constructs a *shadow* profiler via
    ``make_profiler(trigger)`` — typically over the traffic observed up
    to the trigger (the trigger document carries ``pkts_ingested`` and
    the drift signal so the caller can cut the window) — then runs a
    budgeted optimization warm-started from `warm_from` (a
    `ParetoBundle`, `CatoResult`, or observation list — usually the
    deployed bundle, so the surrogate starts from everything the last
    tune learned), compiles the front with `compile_front`, and returns
    the knee. `baseline` (a `BundlePoint`, usually the currently deployed
    knee) fills the episode audit's old-vs-new objective comparison.
    Everything the body touches is its own: fresh profiler, fresh
    evaluator, fresh optimizer — the policy's live-fleet guard holds by
    construction.

    The front is compiled on the live fleet's device, which the trigger
    document carries as ``device`` (so ``make_profiler`` can build its
    shadow profiler there too)."""
    from ...core import CatoOptimizer, MemoizedEvaluator
    from ...core.optimizer import Observation
    from ...traffic.backends import backend_suite
    from ..deploy import compile_front

    def _warm_observations() -> list:
        if warm_from is None:
            return []
        if hasattr(warm_from, "points"):        # ParetoBundle
            return [
                Observation(x=p.rep, cost=float(p.cost), perf=float(p.perf),
                            aux=dict(p.aux), fidelity=p.fidelity)
                for p in warm_from.points
            ]
        if hasattr(warm_from, "observations"):  # CatoResult
            return list(warm_from.observations)
        return list(warm_from)

    def retune(trigger: dict) -> ReoptOutcome:
        prof = make_profiler(trigger)
        ev = MemoizedEvaluator(backend_suite(prof, fidelities))
        opt = CatoOptimizer(space, ev, priors, n_init=n_init, seed=seed,
                            batch_size=batch_size)
        n_warm = opt.warm_start(_warm_observations())
        if ev.multi_fidelity:
            res = opt.run_multi_fidelity(measure_budget=measure_budget,
                                         batch_size=batch_size)
        else:
            res = opt.run(n_iterations=n_init + measure_budget)
            # warm-started observations carry a "warm:" fidelity tag; pin
            # the measured fidelity so the reported front is live-only
            res.measured_fidelity = ev.measured
        bundle = compile_front(res, prof, runtime=runtime, fused=fused,
                               max_points=max_points,
                               device=trigger["device"])
        knee = bundle.knee()
        old = (None if baseline is None
               else (float(baseline.cost), float(baseline.perf)))
        return ReoptOutcome(
            point=knee,
            budget=res.budget,
            old_objectives=old,
            new_objectives=(float(knee.cost), float(knee.perf)),
            detail={
                "warm_started": n_warm,
                "front_points": len(bundle.points),
                "fidelity_counts": res.fidelity_counts,
            },
        )

    return retune
