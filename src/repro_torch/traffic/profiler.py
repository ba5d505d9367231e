"""The CATO Profiler: measure cost(x) and perf(x) of generated pipelines.

Port of `repro.traffic.profiler`. The profiler takes ``device=`` (default
``"cuda"``) and passes it to every extraction and pipeline it builds: the
measured fidelities time the card's machine, the modeled ones are the
reference's arithmetic over the same feature matrices.

For every feature representation x = (F, n) sampled by the Optimizer, the
Profiler (paper §3.4):

  1. *generates* the serving pipeline — the plan of exactly the ops for F
     at depth n (`repro_torch.traffic.extraction`) plus the dense-forest
     inference stage;
  2. *trains a fresh model* on the training split and evaluates macro-F1 on
     a hold-out test set (perf);
  3. *measures* the systems cost under one of four metrics (paper §4):
       exec_time   — per-flow CPU time of the pipeline,
       latency     — end-to-end inference latency incl. time waiting for
                     packets to arrive (inter-arrival dominated),
       throughput  — zero-loss drain rate (negated for minimization),
       throughput_replayed — zero-loss throughput *measured* by replaying
                     the test split as a packet stream through the online
                     serving runtime (`repro_torch.serve.runtime`) and bisecting
                     the highest offered load with zero drops (Fig. 5c as
                     a measurement rather than a model),
       throughput_replayed_sharded — the same measurement against an
                     `n_shards`-worker `ShardedRuntime` with RSS-style
                     symmetric flow steering: the bisection is over the
                     aggregate offered load, and a drop on any shard
                     fails the trial (DESIGN.md §8).

Cost modes:
  measured — wall-clock the compiled extraction + inference on this machine
             (compile excluded, best-of-k). Used for headline runs (Fig. 5).
  modeled  — deterministic op-DAG accounting (shared ops deduplicated),
             calibrated to Table-2 magnitudes. Used for ground-truth
             exhaustive enumeration and the convergence studies, where
             120k+ profiler calls make per-call wall-clocking impractical
             and measurement noise would swamp HVI comparisons.

Fig.-8 ablation variants are exposed as alternative metrics: `naive_cost`
(per-feature costs summed without shared-op dedup), `model_inf_cost`,
`pkt_depth_cost`, `naive_perf` (sum of per-feature MI).

The cheap-modeled vs. expensive-replayed spectrum above is packaged as
pluggable measurement *backends* in `repro_torch.traffic.backends`
(`modeled` / `replayed` / `replayed_sharded`), all views over one
profiler instance: they share its matrix, trained-model, service-model
calibration, and result caches, so the multi-fidelity optimizer and
every baseline pay for each distinct config at most once per fidelity
(DESIGN.md §10.1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

import torch

from ..core.forest import (
    DenseForest,
    forest_apply_np,
    forest_predict_class,
)
from ..core.mutual_info import mi_scores
from ..core.search_space import FeatureRep
from ..device import resolve_device
from .extraction import extract_features, extraction_fn
from .features import (
    FEATURE_NAMES,
    modeled_extraction_cost_ns,
)
from .models import macro_f1, train_traffic_model
from .synth import TrafficDataset

__all__ = ["ProfileResult", "TrafficProfiler"]

_CAPTURE_NS = 2.0  # connection-tracking cost per packet beyond depth n
_TREE_NODE_NS = 1.2  # per level per tree during inference
# frozen-path / tracked-path cost ratio assumed by the modeled fidelity
# before any measured calibration has timed the frozen path (DESIGN.md §12)
_REUSE_DISCOUNT_DEFAULT = 0.5


@dataclasses.dataclass
class ProfileResult:
    cost: float
    perf: float
    aux: dict = dataclasses.field(default_factory=dict)


class TrafficProfiler:
    def __init__(
        self,
        dataset: TrafficDataset,
        feature_names: Sequence[str] = FEATURE_NAMES,
        *,
        model: str = "rf",
        cost_metric: str = "exec_time",   # exec_time | latency | throughput
                                          # | throughput_replayed
                                          # | throughput_replayed_sharded
        cost_mode: str = "modeled",       # modeled | measured
        n_shards: int = 2,                # worker count for the sharded metric
        scenario: str = "uniform",        # arrival process for replayed metrics
        bisect_iters: int = 10,           # zero-loss bisection depth
        test_frac: float = 0.2,
        seed: int = 0,
        cache: bool = True,
        reuse=None,                       # ReuseConfig: replay + model with
                                          # drift-gated prediction reuse on
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.feature_names = tuple(feature_names)
        self.model = model
        self.cost_metric = cost_metric
        self.cost_mode = cost_mode
        self.n_shards = n_shards
        self.scenario = scenario
        self.reuse = reuse
        self.bisect_iters = bisect_iters
        self.seed = seed
        self.train_ds, self.test_ds = dataset.split(test_frac, seed)
        self._stream_cache = None
        self._service_cache: dict = {}
        self._matrix_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._result_cache: dict = {}
        # trained model + hold-out F1 per canonical config key: every
        # fidelity of the same x shares one trained model (training is
        # seeded-deterministic, so caching is semantics-free), and
        # `serve.deploy` reuses the exact forest the measurement used
        self._perf_cache: dict = {}
        self._cache_enabled = cache
        self._mi_full: Optional[np.ndarray] = None
        self.n_profile_calls = 0
        self.wallclock = {"train_perf": 0.0, "measure_cost": 0.0, "pipeline_gen": 0.0}

    # -- feature matrices (column-sliced from per-depth full extraction) ----
    def matrices_at_depth(self, depth: int) -> tuple[np.ndarray, np.ndarray]:
        if depth not in self._matrix_cache:
            Xtr = extract_features(self.train_ds, self.feature_names, depth,
                                   device=self.device)
            Xte = extract_features(self.test_ds, self.feature_names, depth,
                                   device=self.device)
            self._matrix_cache[depth] = (Xtr, Xte)
        return self._matrix_cache[depth]

    def columns(self, x: FeatureRep) -> tuple[np.ndarray, np.ndarray]:
        Xtr, Xte = self.matrices_at_depth(x.depth)
        idx = [self.feature_names.index(f) for f in x.features]
        return Xtr[:, idx], Xte[:, idx]

    # -- perf(x): train fresh model, hold-out macro F1 -----------------------
    def perf_f1(self, x: FeatureRep) -> tuple[float, DenseForest]:
        pkey = (x.key(), self.model)
        if self._cache_enabled and pkey in self._perf_cache:
            return self._perf_cache[pkey]
        t0 = time.perf_counter()
        Xtr, Xte = self.columns(x)
        forest, _ = train_traffic_model(
            Xtr, self.train_ds.label, model=self.model, seed=self.seed
        )
        pred = forest_predict_class(forest, Xte)
        f1 = macro_f1(self.test_ds.label, pred)
        self.wallclock["train_perf"] += time.perf_counter() - t0
        if self._cache_enabled:
            self._perf_cache[pkey] = (f1, forest)
        return f1, forest

    # -- cost components ------------------------------------------------------
    def _depth_eff(self, x: FeatureRep) -> float:
        """Mean packets actually processed: min(depth, flow_len)."""
        return float(np.minimum(self.test_ds.flow_len, x.depth).mean())

    def _inference_ns(self, forest: DenseForest) -> float:
        return forest.n_trees * forest.depth * _TREE_NODE_NS + 2.0 * forest.n_out

    def modeled_exec_us(self, x: FeatureRep, forest: DenseForest, dedup=True) -> float:
        ns = modeled_extraction_cost_ns(x.features, self._depth_eff(x), dedup)
        ns += self._inference_ns(forest)
        return ns / 1e3

    def _wait(self) -> None:
        """Wait for the work queued on the profiler's device: a torch call
        on the card returns before its kernels run, so a host-clock window
        that does not end here times launches, not work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def measured_exec_us(self, x: FeatureRep, forest: DenseForest) -> float:
        """Wall-clock the generated pipeline on the test split (per flow):
        the extraction on the profiler's device, each timed window ending
        with a wait for the device, then the forest in numpy, as in the
        reference."""
        t0 = time.perf_counter()
        fn = extraction_fn(x.features, x.depth, self.test_ds.max_pkts,
                           device=self.device)
        feats = fn(self.test_ds).cpu().numpy()  # warm
        self.wallclock["pipeline_gen"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        best = np.inf
        for _ in range(3):
            t1 = time.perf_counter()
            fn(self.test_ds)
            self._wait()
            best = min(best, time.perf_counter() - t1)
        t_inf = np.inf
        for _ in range(3):
            t1 = time.perf_counter()
            forest_apply_np(forest, feats)
            t_inf = min(t_inf, time.perf_counter() - t1)
        self.wallclock["measure_cost"] += time.perf_counter() - t0
        n = self.test_ds.n_flows
        return (best + t_inf) / n * 1e6

    def exec_time_us(self, x: FeatureRep, forest: DenseForest) -> float:
        if self.cost_mode == "measured":
            return self.measured_exec_us(x, forest)
        return self.modeled_exec_us(x, forest)

    def latency_s(self, x: FeatureRep, forest: DenseForest) -> float:
        """Wait for n packets (inter-arrival) + pipeline execution time."""
        ds = self.test_ds
        last = np.minimum(ds.flow_len, x.depth) - 1
        wait = ds.ts[np.arange(ds.n_flows), last]
        return float(wait.mean()) + self.exec_time_us(x, forest) / 1e6

    def throughput_gbps(self, x: FeatureRep, forest: DenseForest) -> float:
        """Zero-loss drain rate: bits/flow over CPU-seconds/flow."""
        ds = self.test_ds
        n_eff = self._depth_eff(x)
        mean_len = float(ds.flow_len.mean())
        if self.cost_mode == "measured":
            exec_ns = self.measured_exec_us(x, forest) * 1e3
        else:
            exec_ns = self.modeled_exec_us(x, forest) * 1e3
        # packets past the inference point still transit connection tracking;
        # under reuse they take the cheaper frozen fast path instead
        # (DESIGN.md §12), discounted by the learned frozen/track ratio
        tail_ns = max(0.0, mean_len - n_eff) * _CAPTURE_NS
        drain_ns = exec_ns + tail_ns * self.reuse_discount()
        bytes_per_flow = float((ds.size * ds.valid_mask()).sum() / ds.n_flows)
        return bytes_per_flow * 8.0 / drain_ns  # Gbit/s (bits per ns)

    def reuse_discount(self, reuse="profiler") -> float:
        """Frozen-path discount the modeled fidelity applies to packets past
        the inference point when prediction reuse is on.

        Learned, not guessed, whenever possible: any measured service
        calibration in this profiler's cache that timed the frozen path
        (`calibrate_warm`) contributes its frozen/track ratio — the cheap
        fidelity absorbs the expensive fidelity's measurement, keeping the
        multi-fidelity surrogate's two views of one config commensurable.
        Falls back to the deterministic default before any measurement
        exists, and to 1.0 (no discount) with reuse off."""
        if reuse == "profiler":
            reuse = self.reuse
        if reuse is None or not getattr(reuse, "enabled", False):
            return 1.0
        ratios = [
            sm.pkt_frozen_ns / sm.pkt_track_ns
            for sm in self._service_cache.values()
            if sm.pkt_frozen_ns is not None and sm.pkt_track_ns > 0
        ]
        if ratios:
            return float(min(1.0, sum(ratios) / len(ratios)))
        return _REUSE_DISCOUNT_DEFAULT

    def replayed_throughput_gbps(
        self,
        x: FeatureRep,
        forest: DenseForest,
        *,
        capacity: int = 2048,
        max_batch: int = 128,
        ring_capacity: Optional[int] = None,
        bisect_iters: Optional[int] = None,
        verbose: bool = False,
        fused: bool = True,
        n_shards: int = 1,
        control=None,
        obs=None,
        reuse="profiler",
        calibrate_warm: Optional[bool] = None,
    ):
        """Zero-loss throughput measured through the streaming runtime.

        Replays the held-out split as an offered-load packet stream through
        `repro_torch.serve.runtime` (flow table -> bucketed micro-batch
        dispatch -> this representation's pipeline on the profiler's device
        — by default the single-launch fused kernel B2, DESIGN.md §7) and
        bisects the highest rate with zero drops. cost_mode selects the replay clock's constants:
        measured (wall-clock calibration on this machine) or modeled
        (feature-op DAG). Returns (gbps, ReplayStats).

        With `n_shards > 1` the DUT is a `ShardedRuntime`: RSS-style
        symmetric steering splits the offered load across workers, and the
        bisection runs over the *aggregate* rate (a drop on any shard
        fails the trial). Each worker queue gets a full-size ring — the
        hardware-RSS provisioning, where every queue owns its own
        descriptor ring — clamped below the hottest shard's sub-trace so
        saturation stays reachable (DESIGN.md §8.3, incl. the buffering
        caveat this implies for aggregate numbers). The flow table budget
        (`capacity`) is split per shard.

        The offered stream follows the profiler's `scenario` (arrival
        process + dataset skew are fixed at dataset construction; see
        `make_scenario_dataset`). With `control` (a
        `repro_torch.serve.control.ControlConfig`) and `n_shards > 1`, the
        measurement runs under the adaptive control plane — dynamic RETA
        rebalancing and friends — instead of the static fleet
        (DESIGN.md §9).

        Pass an `Observability` bundle as `obs` to instrument the final
        zero-loss verification replay (tracing, drift, fleet registry,
        audit — DESIGN.md §11); bisection probes stay uninstrumented so
        the bundle captures exactly one run.

        `reuse` overrides the profiler's own reuse configuration for this
        measurement (a `ReuseConfig` or None; the default inherits
        `self.reuse`). With reuse on, the measured calibration always
        times the steady-state warm paths (`calibrate_warm`) so the
        replay clock charges frozen packets their real amortized cost;
        pass `calibrate_warm=True` to force the honest warm calibration
        for a reuse-off arm too (an apples-to-apples A/B needs both arms
        on measured constants, not one on the legacy 0.25x guess).
        """
        from ..serve.runtime import (
            PacketStream, ServiceModel, ShardedRuntime, StreamingRuntime,
            find_zero_loss_rate,
        )
        from .pipeline import build_pipeline

        t0 = time.perf_counter()
        pipe = build_pipeline(x, forest, max_pkts=x.depth, fused=fused,
                              device=self.device)
        if self._stream_cache is None:
            self._stream_cache = PacketStream.from_dataset(
                self.test_ds, seed=self.seed, scenario=self.scenario)
        stream = self._stream_cache
        if ring_capacity is None:
            # the DUT buffer must be small vs the trace or loss cannot
            # occur. Per-queue ring: every worker queue gets the full
            # ring, exactly as NIC RSS provisions descriptor rings per
            # queue (DESIGN.md §8.3); the binding clamp is the *hottest
            # shard's* steered sub-trace — its queue must not be able to
            # absorb its whole offered load (the same trace-size clamp
            # the single-worker path applies — see the tiny-split
            # regression tests). Explicit ring_capacity values are
            # honored verbatim; find_zero_loss_rate raises loudly if
            # they make saturation unreachable.
            ring_capacity = max(64, min(4096, stream.n_events // 8))
            if n_shards > 1:
                from ..serve.runtime.shard import steer_flows

                counts = np.bincount(
                    steer_flows(stream, n_shards)[stream.fid],
                    minlength=n_shards)
                events_bound = int(counts.max())
            else:
                events_bound = stream.n_events
            ring_capacity = min(ring_capacity, max(1, events_bound - 1))
        self.wallclock["pipeline_gen"] += time.perf_counter() - t0

        ru = self.reuse if reuse == "profiler" else reuse
        if calibrate_warm is None:
            calibrate_warm = ru is not None and getattr(ru, "enabled", False)

        def make_runtime(execute: bool) -> StreamingRuntime:
            if n_shards > 1:
                return ShardedRuntime(
                    pipe, n_shards=n_shards, capacity=capacity,
                    max_batch=max_batch, flush_timeout_s=0.05,
                    idle_timeout_s=60.0, execute=execute, reuse=ru,
                )
            return StreamingRuntime(
                pipe, capacity=capacity, max_batch=max_batch,
                flush_timeout_s=0.05, idle_timeout_s=60.0, execute=execute,
                reuse=ru,
            )

        t0 = time.perf_counter()
        # one calibration per representation: repeated measurements of the
        # same (F, n) — e.g. a static-vs-controlled comparison — must share
        # clock constants, or calibration jitter masquerades as a
        # configuration effect
        skey = (x.key(), self.cost_mode, calibrate_warm,
                None if ru is None else (getattr(ru, "enabled", False),
                                         getattr(ru, "drift_threshold", 0.0),
                                         getattr(ru, "refresh_every", 0)))
        service = self._service_cache.get(skey)
        if service is None:
            if self.cost_mode == "measured":
                service = ServiceModel.measure(
                    make_runtime(True), stream, calibrate_warm=calibrate_warm)
            else:
                service = ServiceModel.modeled(
                    x, forest, reuse_discount=self.reuse_discount(ru))
            self._service_cache[skey] = service
        session = None
        if control is not None or obs is not None:
            from ..serve import ServeSession

            session = ServeSession(control=control, obs=obs)
        rate_pps, stats = find_zero_loss_rate(
            stream, make_runtime, service,
            iters=self.bisect_iters if bisect_iters is None else bisect_iters,
            ring_capacity=ring_capacity, verbose=verbose, session=session,
        )
        self.wallclock["measure_cost"] += time.perf_counter() - t0
        return stats.offered_gbps, stats

    def replayed_latency_p99(
        self,
        x: FeatureRep,
        forest: DenseForest,
        *,
        offered_pps: Optional[float] = None,
        capacity: int = 2048,
        max_batch: int = 128,
        ring_capacity: Optional[int] = None,
        n_shards: int = 1,
        obs=None,
    ):
        """p99 enqueue→prediction latency under a *fixed* offered load
        (DESIGN.md §14, ROADMAP "SLO-aware provisioning").

        One replay of the held-out split at `offered_pps` (default: the
        scenario trace's native rate — the load the SLO is stated
        against), through the same runtime geometry as
        `replayed_throughput_gbps` but with no bisection: tail latency
        is a property of one operating point, not of the saturation
        envelope. Clock constants come from the same per-representation
        `ServiceModel` cache, so a throughput and a latency measurement
        of one (F, n) share constants. Returns (p99_s, ReplayStats);
        an `obs` bundle (e.g. with a `LatencyConfig`) instruments the
        run for per-stage decomposition.
        """
        from ..serve.runtime import (
            PacketStream, ServiceModel, ShardedRuntime, StreamingRuntime,
            replay,
        )
        from .pipeline import build_pipeline

        t0 = time.perf_counter()
        pipe = build_pipeline(x, forest, max_pkts=x.depth, fused=True,
                              device=self.device)
        if self._stream_cache is None:
            self._stream_cache = PacketStream.from_dataset(
                self.test_ds, seed=self.seed, scenario=self.scenario)
        stream = self._stream_cache
        if ring_capacity is None:
            ring_capacity = max(64, min(4096, stream.n_events // 8))
        self.wallclock["pipeline_gen"] += time.perf_counter() - t0

        ru = self.reuse
        calibrate_warm = ru is not None and getattr(ru, "enabled", False)

        def make_runtime(execute: bool = False):
            if n_shards > 1:
                return ShardedRuntime(
                    pipe, n_shards=n_shards, capacity=capacity,
                    max_batch=max_batch, flush_timeout_s=0.05,
                    idle_timeout_s=60.0, execute=execute, reuse=ru,
                )
            return StreamingRuntime(
                pipe, capacity=capacity, max_batch=max_batch,
                flush_timeout_s=0.05, idle_timeout_s=60.0, execute=execute,
                reuse=ru,
            )

        t0 = time.perf_counter()
        skey = (x.key(), self.cost_mode, calibrate_warm,
                None if ru is None else (getattr(ru, "enabled", False),
                                         getattr(ru, "drift_threshold", 0.0),
                                         getattr(ru, "refresh_every", 0)))
        service = self._service_cache.get(skey)
        if service is None:
            if self.cost_mode == "measured":
                service = ServiceModel.measure(
                    make_runtime(True), stream, calibrate_warm=calibrate_warm)
            else:
                service = ServiceModel.modeled(
                    x, forest, reuse_discount=self.reuse_discount(ru))
            self._service_cache[skey] = service
        pps = float(offered_pps) if offered_pps is not None else stream.base_pps
        session = None
        if obs is not None:
            from ..serve import ServeSession

            session = ServeSession(obs=obs)
        stats = replay(stream, make_runtime, pps, service,
                       ring_capacity=ring_capacity, session=session)
        self.wallclock["measure_cost"] += time.perf_counter() - t0
        return stats.latency_p99_s, stats

    # -- ablation metrics (Fig. 8) -------------------------------------------
    def naive_cost_us(self, x: FeatureRep, forest: DenseForest) -> float:
        return self.modeled_exec_us(x, forest, dedup=False)

    def model_inf_cost_us(self, forest: DenseForest) -> float:
        return self._inference_ns(forest) / 1e3

    def naive_perf(self, x: FeatureRep) -> float:
        if self._mi_full is None:
            Xtr, _ = self.matrices_at_depth(self.dataset.max_pkts)
            self._mi_full = mi_scores(Xtr, self.train_ds.label, seed=self.seed)
        idx = [self.feature_names.index(f) for f in x.features]
        return float(self._mi_full[idx].sum())

    # -- main entry ------------------------------------------------------------
    def __call__(self, x: FeatureRep, metric: Optional[str] = None) -> ProfileResult:
        metric = metric or self.cost_metric
        key = (x.key(), metric, self.cost_mode, self.model)
        if self._cache_enabled and key in self._result_cache:
            return self._result_cache[key]
        self.n_profile_calls += 1

        if metric == "naive_perf":
            f1, forest = self.naive_perf(x), None
            # cost stays the real metric (Fig. 8 keeps cost(x) original)
            _, forest = self.perf_f1(x)  # still need a model for exec cost
            cost = self.exec_time_us(x, forest)
            res = ProfileResult(cost=cost, perf=f1, aux={"variant": "naive_perf"})
        else:
            f1, forest = self.perf_f1(x)
            if metric == "exec_time":
                cost = self.exec_time_us(x, forest)
            elif metric == "latency":
                cost = self.latency_s(x, forest)
            elif metric == "throughput":
                cost = -self.throughput_gbps(x, forest)
            elif metric == "throughput_replayed":
                cost = -self.replayed_throughput_gbps(x, forest)[0]
            elif metric == "throughput_replayed_sharded":
                cost = -self.replayed_throughput_gbps(
                    x, forest, n_shards=self.n_shards)[0]
            elif metric == "latency_p99_replayed":
                # tail latency at fixed offered load (DESIGN.md §14): the
                # third objective axis the ROADMAP's SLO-aware provisioning
                # planner optimizes; lower is better, so no negation
                cost = self.replayed_latency_p99(x, forest)[0]
            elif metric == "naive_cost":
                cost = self.naive_cost_us(x, forest)
            elif metric == "model_inf_cost":
                cost = self.model_inf_cost_us(forest)
            elif metric == "pkt_depth_cost":
                cost = float(x.depth)
            else:
                raise ValueError(f"unknown metric {metric!r}")
            res = ProfileResult(
                cost=float(cost),
                perf=float(f1),
                aux={"n_features": len(x.features), "depth": x.depth},
            )
        if self._cache_enabled:
            self._result_cache[key] = res
        return res

    # -- true metrics for post-hoc re-evaluation (Fig. 8 post-processing) ----
    def true_metrics(self, x: FeatureRep) -> ProfileResult:
        f1, forest = self.perf_f1(x)
        if self.cost_metric == "latency":
            cost = self.latency_s(x, forest)
        elif self.cost_metric == "throughput":
            cost = -self.throughput_gbps(x, forest)
        elif self.cost_metric == "throughput_replayed":
            cost = -self.replayed_throughput_gbps(x, forest)[0]
        elif self.cost_metric == "throughput_replayed_sharded":
            cost = -self.replayed_throughput_gbps(
                x, forest, n_shards=self.n_shards)[0]
        elif self.cost_metric == "latency_p99_replayed":
            cost = self.replayed_latency_p99(x, forest)[0]
        else:
            cost = self.exec_time_us(x, forest)
        return ProfileResult(cost=float(cost), perf=float(f1))
