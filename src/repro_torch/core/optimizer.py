"""The CATO Optimizer: multi-objective BO over feature representations.

Loop (paper §3.3 + Fig. 3):
  1. preprocessing — MI dimensionality reduction + automatic prior build
     (done by the caller via `build_priors`; pass priors=None for CATO-BASE);
  2. init — `n_init` points sampled from the priors (random but
     prior-weighted, §5.5);
  3. iterate — fit RF surrogate on observations, draw a candidate pool
     (prior samples + uniform samples + mutations of incumbent Pareto
     points), score with MC-EHVI, inject πBO prior weight, evaluate the
     argmax with the *real* Profiler, update observations.

Evaluation goes through a `MemoizedEvaluator` — the same memoized layer
every baseline uses, so cost comparisons are measured through identical
code and a config is profiled at most once per fidelity (DESIGN.md
§10.2). The raw `profile(x) -> (cost, perf)` / `ProfileResult` callable
contract still works (it is wrapped on construction); both objectives
are minimized internally as ``(cost, -perf)``.

Two loop shapes exist:

- `run` — the paper's sequential loop (batch_size=1 reproduces it
  draw-for-draw); batch_size>1 proposes q-EHVI greedy batches at one
  fidelity.
- `run_multi_fidelity` — the batched **measure → optimize** loop
  (DESIGN.md §10.3): propose a batch, evaluate it at the *cheap*
  fidelity, and promote only candidates on the current cheap front to
  the expensive measured fidelity (successive-halving-style budget
  split). The surrogate is fidelity-aware (a level input column), so
  low-fidelity points inform the posterior without polluting the
  measured front, and the returned `CatoResult` reports the
  measured-fidelity Pareto set.

The optimizer is space-generic: any object implementing the `SearchSpace`
protocol (encode / sample_uniform / sample_from_priors / mutate) works —
`repro_torch.core.tuner` reuses it for LM serving-pipeline configuration
search.

The port's own copy of `repro.core.optimizer` (numpy only), so that the
port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import numpy as np

from .acquisition import apply_pibo, ehvi, qehvi_greedy, scalarized_ei
from .pareto import normalize_objectives, pareto_mask
from .priors import CatoPriors
from .search_space import SearchSpace
from .surrogate import RFSurrogate

__all__ = ["Observation", "CatoResult", "CatoOptimizer"]


@dataclasses.dataclass
class Observation:
    x: Any                 # FeatureRep (or tuner config)
    cost: float
    perf: float
    aux: dict = dataclasses.field(default_factory=dict)
    iteration: int = -1
    elapsed_s: float = 0.0
    fidelity: str = ""     # which measurement backend produced it

    @property
    def objectives(self) -> tuple[float, float]:
        """(cost, -perf) — both minimized."""
        return (self.cost, -self.perf)


@dataclasses.dataclass
class CatoResult:
    observations: list[Observation]
    space: Any
    # iterations where `surrogate.fit` failed and proposal degraded to
    # random search — convergence plots must be able to tell BO from
    # accidental random (DESIGN.md §10.3)
    surrogate_fallbacks: list[int] = dataclasses.field(default_factory=list)
    fidelity_counts: dict = dataclasses.field(default_factory=dict)
    # set by multi-fidelity runs: the expensive fidelity whose
    # observations form the reported Pareto set
    measured_fidelity: Optional[str] = None
    budget: dict = dataclasses.field(default_factory=dict)

    def observations_at(self, fidelity: str) -> list[Observation]:
        return [o for o in self.observations if o.fidelity == fidelity]

    def measured_observations(self) -> list[Observation]:
        """Observations backing the reported front: the measured-fidelity
        subset of a multi-fidelity run, every observation otherwise."""
        if self.measured_fidelity is None:
            return list(self.observations)
        return self.observations_at(self.measured_fidelity)

    def objective_matrix(self) -> np.ndarray:
        return np.array([o.objectives for o in self.observations], dtype=np.float64)

    def pareto_observations(self) -> list[Observation]:
        obs = self.measured_observations()
        if not obs:
            return []
        Y = np.array([o.objectives for o in obs], dtype=np.float64)
        mask = pareto_mask(Y)
        obs = [o for o, m in zip(obs, mask) if m]
        return sorted(obs, key=lambda o: o.cost)

    def pareto_points(self) -> np.ndarray:
        """(k, 2) array of (cost, perf) on the estimated front."""
        return np.array(
            [(o.cost, o.perf) for o in self.pareto_observations()], dtype=np.float64
        )

    def best_by_perf(self) -> Observation:
        return max(self.measured_observations(), key=lambda o: o.perf)

    def best_by_cost(self) -> Observation:
        return min(self.measured_observations(), key=lambda o: o.cost)


class CatoOptimizer:
    def __init__(
        self,
        space: SearchSpace,
        profiler: Callable[[Any], tuple[float, float] | Any],
        priors: Optional[CatoPriors] = None,
        *,
        n_init: int = 3,
        candidate_pool: int = 512,
        surrogate: Optional[RFSurrogate] = None,
        pibo_beta: float = 3.0,
        seed: int = 0,
        batch_size: int = 1,
    ):
        from .evaluator import MemoizedEvaluator

        self.space = space
        self.profiler = profiler
        self.evaluator = (
            profiler if isinstance(profiler, MemoizedEvaluator)
            else MemoizedEvaluator(profiler)
        )
        self.priors = priors
        self.n_init = n_init
        self.candidate_pool = candidate_pool
        self.surrogate = surrogate or RFSurrogate(seed=seed)
        self.pibo_beta = pibo_beta
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.observations: list[Observation] = []
        self.fallback_iterations: list[int] = []
        self._seen: set = set()

    # -- warm start (shadow re-optimization episodes) ------------------------
    def warm_start(self, observations, *, tag: str = "warm") -> int:
        """Inject prior observations to warm-start the surrogate.

        The self-optimizing fleet's re-tune episodes start from the
        deployed bundle's observations instead of a cold posterior: the
        injected points join `self.observations` (so the surrogate and
        the exploitation pool see them) and mark their configs as seen
        (so proposals spend no budget re-discovering them).

        Each injected observation is re-tagged with fidelity
        ``"{tag}:{original}"`` — a level that matches no live measurement
        backend — so warm points inform the fidelity-aware posterior as
        low-fidelity context but can never pollute the cheap promotion
        front, the measured Pareto set, or the measurement budget
        accounting. Returns the number of observations injected."""
        n = 0
        for o in observations:
            k = self._key(o.x)
            if k in self._seen:
                continue
            self.observations.append(dataclasses.replace(
                o, aux=dict(o.aux), fidelity=f"{tag}:{o.fidelity}"))
            self._seen.add(k)
            n += 1
        return n

    # -- evaluation ----------------------------------------------------------
    def _evaluate(
        self, x: Any, iteration: int, fidelity: Optional[str] = None
    ) -> Observation:
        obs = self.evaluator.evaluate(x, iteration, fidelity)
        self.observations.append(obs)
        self._seen.add(self._key(x))
        return obs

    @staticmethod
    def _key(x: Any):
        return x.key() if hasattr(x, "key") else x

    def _result(self, measured_fidelity: Optional[str] = None) -> CatoResult:
        counts: dict[str, int] = {}
        for o in self.observations:
            counts[o.fidelity] = counts.get(o.fidelity, 0) + 1
        return CatoResult(
            self.observations,
            self.space,
            surrogate_fallbacks=list(self.fallback_iterations),
            fidelity_counts=counts,
            measured_fidelity=measured_fidelity,
            budget=self.evaluator.budget_summary(),
        )

    # -- candidate generation --------------------------------------------------
    def _candidates(self, n: int) -> list[Any]:
        cands: list[Any] = []
        if self.priors is not None and hasattr(self.space, "sample_from_priors"):
            cands += self.space.sample_from_priors(
                self.rng, int(n * 0.6), self.priors.feature_probs, self.priors.depth_pmf
            )
        cands += self.space.sample_uniform(self.rng, n - len(cands))
        # exploit: mutate incumbent Pareto points. Fronts are computed
        # per fidelity — objective scales are incommensurable across
        # fidelities (a measured cost can dominate every cheap cost
        # numerically), so a mixed mask would collapse the exploitation
        # pool to measured-only incumbents. Single-fidelity runs have
        # one group, which is exactly the historical behavior.
        if self.observations:
            groups: dict[str, list[Observation]] = {}
            for o in self.observations:
                groups.setdefault(o.fidelity, []).append(o)
            inc, inc_keys = [], set()
            for grp in groups.values():
                Y = np.array([o.objectives for o in grp])
                for o, m in zip(grp, pareto_mask(Y)):
                    k = self._key(o.x)
                    if m and k not in inc_keys:
                        inc_keys.add(k)
                        inc.append(o.x)
            for x in inc:
                for _ in range(4):
                    cands.append(self.space.mutate(self.rng, x))
        # drop already-evaluated
        fresh, seen = [], set()
        for c in cands:
            k = self._key(c)
            if k in self._seen or k in seen:
                continue
            seen.add(k)
            fresh.append(c)
        return fresh

    def _sample_init(self, n: int) -> list[Any]:
        """Initialization: random but prior-weighted (paper §5.5)."""
        if self.priors is not None and hasattr(self.space, "sample_from_priors"):
            return self.space.sample_from_priors(
                self.rng, n, self.priors.feature_probs, self.priors.depth_pmf
            )
        return self.space.sample_uniform(self.rng, n)

    # -- main loop (single fidelity) -------------------------------------------
    def run(
        self,
        n_iterations: int = 50,
        verbose: bool = False,
        fidelity: Optional[str] = None,
    ) -> CatoResult:
        """Sequential (batch_size=1) or batched single-fidelity loop.

        `fidelity` picks the measurement backend (None = the evaluator's
        expensive default, which for a plain profiler callable is the
        callable itself).
        """
        for i, x in enumerate(self._sample_init(min(self.n_init, n_iterations))):
            self._evaluate(x, i, fidelity)

        it = len(self.observations)
        while it < n_iterations:
            q = min(self.batch_size, n_iterations - it)
            for x in self._propose_batch(it, q):
                obs = self._evaluate(x, it, fidelity)
                it += 1
                if verbose:
                    print(
                        f"[cato] iter {obs.iteration}: cost={obs.cost:.6g} "
                        f"perf={obs.perf:.4f} x={x}"
                    )
        return self._result()

    # -- batched multi-fidelity loop (DESIGN.md §10.3) -------------------------
    def run_multi_fidelity(
        self,
        measure_budget: int = 8,
        *,
        batch_size: Optional[int] = None,
        promote_quota: Optional[int] = None,
        max_rounds: int = 64,
        verbose: bool = False,
    ) -> CatoResult:
        """Propose batches, evaluate cheap, promote front points to measured.

        Each round proposes a q-EHVI greedy batch, evaluates it at the
        *cheapest* fidelity, and promotes at most `promote_quota`
        (default q // 2 — the successive-halving budget split) of the
        batch to the expensive *measured* fidelity. A candidate is only
        ever promoted while non-dominated among all cheap-fidelity
        observations, so the measurement budget is never spent on a
        point the cheap model already rules out. Stops once
        `measure_budget` measured evaluations have been taken (or the
        proposal stream dries up).
        """
        ev = self.evaluator
        if not ev.multi_fidelity:
            raise ValueError(
                "run_multi_fidelity needs a multi-fidelity evaluator: pass "
                "an ordered backend mapping (cheap first) as the profiler, "
                "e.g. repro_torch.traffic.backends.backend_suite(...)"
            )
        cheap, measured = ev.cheapest, ev.measured
        q = batch_size or max(self.batch_size, 1)
        quota = promote_quota if promote_quota is not None else max(1, q // 2)

        def measured_used() -> int:
            return sum(1 for o in self.observations if o.fidelity == measured)

        # init at the cheap fidelity (deduped: prior-weighted sampling can
        # repeat a config, and a repeat would burn budget on a memo hit);
        # promote its front so the measured set is never empty
        init, init_keys = [], set()
        for x in self._sample_init(self.n_init):
            k = self._key(x)
            if k in init_keys:
                continue
            init_keys.add(k)
            init.append(x)
        init_obs = [self._evaluate(x, i, cheap) for i, x in enumerate(init)]
        it = len(self.observations)
        for o in self._promotable(init_obs, min(quota, measure_budget), cheap,
                                  measured):
            self._evaluate(o.x, it, measured)
            it += 1

        rounds = 0
        while measured_used() < measure_budget and rounds < max_rounds:
            rounds += 1
            xs = self._propose_batch(it, q, measured_fidelity=measured)
            # the no-candidates fallback can return already-seen configs
            # (tiny/exhausted spaces): a repeat adds nothing but a memo
            # hit, so drop them — and stop once nothing fresh remains
            fresh, fresh_keys = [], set()
            for x in xs:
                k = self._key(x)
                if k in self._seen or k in fresh_keys:
                    continue
                fresh_keys.add(k)
                fresh.append(x)
            if not fresh:
                break
            batch_obs = []
            for x in fresh:
                batch_obs.append(self._evaluate(x, it, cheap))
                it += 1
            k = min(quota, measure_budget - measured_used())
            promoted = self._promotable(batch_obs, k, cheap, measured)
            for o in promoted:
                m = self._evaluate(o.x, it, measured)
                it += 1
                if verbose:
                    print(
                        f"[cato-mf] round {rounds}: promoted {o.x} "
                        f"cheap=({o.cost:.4g},{o.perf:.3f}) "
                        f"measured=({m.cost:.4g},{m.perf:.3f})"
                    )
            if verbose:
                print(
                    f"[cato-mf] round {rounds}: batch={len(xs)} "
                    f"promoted={len(promoted)} "
                    f"measured {measured_used()}/{measure_budget}"
                )
        return self._result(measured_fidelity=measured)

    def _promotable(
        self, batch_obs: list[Observation], k: int, cheap: str, measured: str
    ) -> list[Observation]:
        """Members of `batch_obs` worth the measured fidelity: never a
        candidate dominated at the cheap fidelity, never one already
        measured (a memoized repeat would burn a budget slot on zero new
        information), ranked by *exclusive* hypervolume contribution to
        the cheap front. Ranking stays inside the cheap objective space
        on purpose: fidelity scales are incommensurable, and a joint
        normalization would compress every cheap cost difference into a
        sliver of the axis, reducing the ranking to perf-only."""
        if k <= 0 or not batch_obs:
            return []
        cheap_obs = [o for o in self.observations if o.fidelity == cheap]
        Y = np.array([o.objectives for o in cheap_obs], dtype=np.float64)
        front_keys = {
            self._key(o.x) for o, m in zip(cheap_obs, pareto_mask(Y)) if m
        }
        measured_keys = {
            self._key(o.x)
            for o in self.observations if o.fidelity == measured
        }
        elig, elig_keys = [], set()
        for o in batch_obs:
            key = self._key(o.x)
            if key not in front_keys or key in measured_keys:
                continue
            if key in elig_keys:  # a batch may repeat a config (fallbacks)
                continue
            elig_keys.add(key)
            elig.append(o)
        if not elig:
            return []
        from .acquisition import hvi_contribution

        Yn, lo, hi = normalize_objectives(Y)
        span = np.where(hi > lo, hi - lo, 1.0)
        front_n = Yn[pareto_mask(Y)]
        contrib = np.empty(len(elig))
        for i, o in enumerate(elig):
            yn = (np.asarray(o.objectives, dtype=np.float64) - lo) / span
            others = front_n[~np.all(front_n == yn, axis=1)]
            contrib[i] = hvi_contribution(others, yn[None, :])[0]
        order = np.argsort(-contrib, kind="stable")
        return [elig[int(i)] for i in order[:k]]

    # -- proposal --------------------------------------------------------------
    def _propose_batch(
        self, iteration: int, q: int, measured_fidelity: Optional[str] = None
    ) -> list[Any]:
        """q proposals. The q=1 single-fidelity path is the paper's
        sequential proposal, draw-for-draw; batches use greedy q-EHVI
        selection over the same posterior samples."""
        if q == 1 and measured_fidelity is None:
            return [self._propose(iteration)]
        cands = self._candidates(self.candidate_pool)
        if not cands:
            return self.space.sample_uniform(self.rng, q)
        Y = np.array([o.objectives for o in self.observations], dtype=np.float64)
        Yn, lo, hi = normalize_objectives(Y)
        X_obs = np.stack([self.space.encode(o.x) for o in self.observations])
        X_cand = np.stack([self.space.encode(c) for c in cands])
        if measured_fidelity is not None:
            # fidelity-aware surrogate: pool every observation, tagged
            # with its level; score candidates at the measured level
            levels = np.array(
                [1.0 if o.fidelity == measured_fidelity else 0.0
                 for o in self.observations], dtype=np.float32)
            X_obs = RFSurrogate.with_fidelity(X_obs, levels)
            X_cand = RFSurrogate.with_fidelity(
                X_cand, np.ones(len(cands), dtype=np.float32))
        if not self._fit_surrogate(X_obs, Yn, iteration):
            sel = self.rng.choice(len(cands), size=min(q, len(cands)),
                                  replace=False)
            return [cands[int(i)] for i in sel]
        post = self.surrogate.posterior_samples(X_cand)  # (T, M, 2)
        if measured_fidelity is not None:
            # EHVI improves the *measured* front; cheap points steer only
            # through the surrogate posterior
            m_mask = np.array(
                [o.fidelity == measured_fidelity for o in self.observations])
            Ym = Yn[m_mask]
            front = Ym[pareto_mask(Ym)] if len(Ym) else np.empty((0, 2))
        else:
            front = Yn[pareto_mask(Yn)]
        lp = None
        if self.priors is not None:
            pl = getattr(self.priors, "pi_log_clipped", self.priors.pi_log)
            lp = np.array([pl(self.space, c) for c in cands])
        idx = qehvi_greedy(
            post, front, q, log_prior=lp, iteration=iteration,
            beta=self.pibo_beta,
        )
        return [cands[i] for i in idx]

    def _fit_surrogate(self, X: np.ndarray, Y: np.ndarray, iteration: int) -> bool:
        """Fit, counting failures: a failed fit degrades the proposal to
        random search, which convergence analysis must see (fig7)."""
        try:
            self.surrogate.fit(X, Y)
            return True
        except Exception as e:  # noqa: BLE001 — any fit failure falls back
            self.fallback_iterations.append(iteration)
            warnings.warn(
                f"[cato] surrogate fit failed at iteration {iteration} "
                f"({e!r}); proposal degrades to random search for this step",
                RuntimeWarning,
                stacklevel=3,
            )
            return False

    def _propose(self, iteration: int) -> Any:
        cands = self._candidates(self.candidate_pool)
        if not cands:
            return self.space.sample_uniform(self.rng, 1)[0]
        Y = np.array([o.objectives for o in self.observations], dtype=np.float64)
        Yn, lo, hi = normalize_objectives(Y)
        X_obs = np.stack([self.space.encode(o.x) for o in self.observations])
        if not self._fit_surrogate(X_obs, Yn, iteration):
            return cands[int(self.rng.integers(len(cands)))]
        X_cand = np.stack([self.space.encode(c) for c in cands])
        post = self.surrogate.posterior_samples(X_cand)  # (T, M, 2)
        front = Yn[pareto_mask(Yn)]
        # alternate EHVI (front-global) with random-scalarization EI
        # (front-local coverage) — HyperMapper-style multi-objective mix
        if iteration % 2 == 0:
            acq = ehvi(post, front)
        else:
            # bathtub-distributed weights: favors the front's extremes
            # (where Fig. 6 shows CATO's edge) while covering the middle
            lam = float(self.rng.beta(0.3, 0.3))
            acq = scalarized_ei(post, Yn, lam)
        if self.priors is not None:
            pl = getattr(self.priors, "pi_log_clipped", self.priors.pi_log)
            lp = np.array([pl(self.space, c) for c in cands])
            acq = apply_pibo(acq, lp, iteration, self.pibo_beta)
        return cands[int(np.argmax(acq))]
