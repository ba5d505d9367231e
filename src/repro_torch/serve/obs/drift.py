"""Online drift signals from dispatch outputs (DESIGN.md §11.4).

Port of `repro.serve.obs.drift`, unchanged but for its imports (numpy
only).

The ROADMAP's self-optimizing fleet needs a trigger: a signal, computed
*from serving telemetry alone*, that the traffic the pipeline classifies
today no longer looks like the traffic it was optimized for. Two sketches
feed it, both updated per resolved micro-batch (one vectorized reduction
per batch — `BucketTelemetry.note` cost discipline):

- **class-mix EWMAs** over the predicted labels: a fast EWMA tracks the
  recent mix, a slow EWMA the long-run mix; the drift score is the total
  variation distance ``0.5 * |fast - slow|_1`` between them. Under a
  stationary mix both converge to the same point and the score decays to
  ~0; under the `drift` scenario (class mix shifts along the replay) the
  fast mix runs ahead of the slow one and the score moves.
- **per-class confidence EWMAs** over the winning class's vote share
  (the forest's top-class probability mass): a pipeline whose inputs
  wander off its training manifold gets less confident before it gets
  *wrong*, so confidence decay is the earlier warning.
- **per-feature streaming moments** (parallel Welford) over cheap
  batch-level feature summaries (flow length, mean packet size, flow
  duration): fast/slow mean gap in slow-σ units flags covariate shift
  even when the label mix holds still.

`DriftMonitor` is pure observation — it never actuates. `check()` is the
signal → trigger API the self-optimizing fleet consumes: it folds the
sketches into one `DriftVerdict` against caller-supplied thresholds, and
`rebaseline()` re-anchors the slow sketches after a corrective action
(e.g. a re-optimized pipeline hot-swap) so the monitor measures drift
*since the fix*, not since the start of time. The thresholding policy
itself — hysteresis, dwell, cooldown — lives in
`repro_torch.serve.control.reoptimizer`, which builds on top.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["DriftMonitor", "DriftVerdict", "StreamingMoments"]

FEATURE_SUMMARY_NAMES = ("flow_len", "mean_pkt_size", "duration_s")


@dataclasses.dataclass(frozen=True)
class DriftVerdict:
    """One thresholded read of the drift sketches (the trigger API).

    `triggered` is the arm edge: some signal crossed its threshold.
    `armed` is the hysteresis hold: signals are still above
    ``threshold * release_frac``, so a dwell window opened on a trigger
    should stay open. `warmed_up` gates both — below `min_batches` the
    EWMAs are still seeding and every score is startup noise."""

    triggered: bool
    armed: bool
    warmed_up: bool
    class_mix_shift: float
    feature_shift: float
    class_threshold: float
    feature_threshold: float

    def to_doc(self) -> dict:
        return {
            "triggered": self.triggered,
            "armed": self.armed,
            "warmed_up": self.warmed_up,
            "class_mix_shift": round(self.class_mix_shift, 6),
            "feature_shift": round(self.feature_shift, 6),
            "class_threshold": self.class_threshold,
            "feature_threshold": self.feature_threshold,
        }


class StreamingMoments:
    """Parallel Welford: exact streaming mean/variance per column."""

    def __init__(self, n_cols: int):
        self.n = 0.0
        self.mean = np.zeros(n_cols)
        self._m2 = np.zeros(n_cols)

    def update(self, x: np.ndarray) -> None:
        """Fold a (n, n_cols) batch in (Chan's parallel combine)."""
        x = np.asarray(x, np.float64)
        nb = float(len(x))
        if nb == 0.0:
            return
        bmean = x.mean(axis=0)
        bm2 = ((x - bmean) ** 2).sum(axis=0)
        delta = bmean - self.mean
        n = self.n + nb
        self.mean = self.mean + delta * (nb / n)
        self._m2 = self._m2 + bm2 + delta**2 * (self.n * nb / n)
        self.n = n

    def var(self) -> np.ndarray:
        if self.n < 2:
            return np.zeros_like(self._m2)
        return self._m2 / (self.n - 1.0)

    def std(self) -> np.ndarray:
        return np.sqrt(self.var())


class DriftMonitor:
    """Fast/slow sketches over predictions, confidence, and features.

    `alpha_fast` >> `alpha_slow`: the fast EWMA is the "now" estimate,
    the slow one the baseline. `min_batches` suppresses the startup
    transient (both EWMAs seed from the first batches, so early scores
    are noise, not drift).
    """

    def __init__(
        self,
        alpha_fast: float = 0.25,
        alpha_slow: float = 0.02,
        min_batches: int = 8,
        history_cap: int = 4096,
    ):
        if not 0 < alpha_slow <= alpha_fast <= 1:
            raise ValueError("need 0 < alpha_slow <= alpha_fast <= 1")
        self.alpha_fast = alpha_fast
        self.alpha_slow = alpha_slow
        self.min_batches = min_batches
        self.history_cap = history_cap
        self.n_batches = 0
        self.n_flows = 0
        # class sketches size themselves to the label space lazily
        self._fast_mix: Optional[np.ndarray] = None
        self._slow_mix: Optional[np.ndarray] = None
        self._conf_ewma: Optional[np.ndarray] = None
        self._conf_seen: Optional[np.ndarray] = None
        # feature sketches
        self._feat_fast: Optional[np.ndarray] = None
        self._feat_slow: Optional[StreamingMoments] = None
        self.max_class_shift = 0.0
        self.max_feature_shift = 0.0
        self.history: list[dict] = []

    # -- sketch updates (one vectorized reduction per batch) -----------------

    def _grow_classes(self, n: int) -> None:
        if self._fast_mix is not None and n <= len(self._fast_mix):
            return

        def grow(a):
            out = np.zeros(n)
            if a is not None:
                out[: len(a)] = a
            return out

        self._fast_mix = grow(self._fast_mix)
        self._slow_mix = grow(self._slow_mix)
        self._conf_ewma = grow(self._conf_ewma)
        seen = np.zeros(n, bool)
        if self._conf_seen is not None:
            seen[: len(self._conf_seen)] = self._conf_seen
        self._conf_seen = seen

    def note_predictions(self, preds: np.ndarray,
                         confidence: Optional[np.ndarray] = None) -> None:
        """Fold one resolved batch's class labels (+ top-class vote share)."""
        preds = np.asarray(preds, np.int64).ravel()
        if preds.size == 0:
            return
        self._grow_classes(int(preds.max()) + 1)
        k = len(self._fast_mix)
        mix = np.bincount(preds, minlength=k) / preds.size
        if self.n_batches == 0:
            self._fast_mix = mix.astype(np.float64)
            self._slow_mix = mix.astype(np.float64)
        else:
            af, asl = self.alpha_fast, self.alpha_slow
            self._fast_mix = af * mix + (1 - af) * self._fast_mix
            self._slow_mix = asl * mix + (1 - asl) * self._slow_mix
        if confidence is not None:
            conf = np.asarray(confidence, np.float64).ravel()
            # per-class mean confidence this batch, EWMA'd where present
            csum = np.bincount(preds, weights=conf, minlength=k)
            ccnt = np.bincount(preds, minlength=k)
            present = ccnt > 0
            cmean = np.where(present, csum / np.maximum(ccnt, 1), 0.0)
            fresh = present & ~self._conf_seen
            self._conf_ewma[fresh] = cmean[fresh]
            upd = present & self._conf_seen
            af = self.alpha_fast
            self._conf_ewma[upd] = (af * cmean[upd]
                                    + (1 - af) * self._conf_ewma[upd])
            self._conf_seen |= present
        self.n_batches += 1
        self.n_flows += preds.size
        score = self.class_mix_shift()
        if self.n_batches >= self.min_batches:
            self.max_class_shift = max(self.max_class_shift, score)
        if len(self.history) < self.history_cap:
            self.history.append({
                "n_flows": self.n_flows,
                "class_mix_shift": score,
                "feature_shift": self.feature_shift(),
            })

    def note_features(self, summaries: np.ndarray) -> None:
        """Fold one batch's (n, k) feature summary columns."""
        x = np.asarray(summaries, np.float64)
        if x.size == 0:
            return
        if self._feat_slow is None:
            self._feat_slow = StreamingMoments(x.shape[1])
            self._feat_fast = x.mean(axis=0)
        else:
            af = self.alpha_fast
            self._feat_fast = af * x.mean(axis=0) + (1 - af) * self._feat_fast
        self._feat_slow.update(x)
        if self.n_batches >= self.min_batches:
            self.max_feature_shift = max(self.max_feature_shift,
                                         self.feature_shift())

    # -- signals -------------------------------------------------------------

    def class_mix_shift(self) -> float:
        """Total variation distance between fast and slow class mixes."""
        if self._fast_mix is None:
            return 0.0
        return float(0.5 * np.abs(self._fast_mix - self._slow_mix).sum())

    def feature_shift(self) -> float:
        """Max per-feature |fast mean - slow mean| in slow-σ units."""
        if self._feat_slow is None or self._feat_slow.n < 2:
            return 0.0
        gap = np.abs(self._feat_fast - self._feat_slow.mean)
        return float((gap / (self._feat_slow.std() + 1e-9)).max())

    def confidence(self) -> dict[int, float]:
        """Per-class prediction-confidence EWMA (observed classes only)."""
        if self._conf_ewma is None:
            return {}
        return {int(c): float(self._conf_ewma[c])
                for c in np.flatnonzero(self._conf_seen)}

    def check(
        self,
        class_threshold: float = 0.25,
        feature_threshold: float = float("inf"),
        *,
        release_frac: float = 0.5,
    ) -> DriftVerdict:
        """Threshold the current sketches into one `DriftVerdict`.

        `triggered` when the instantaneous class-mix TV distance crosses
        `class_threshold` or the feature shift crosses
        `feature_threshold` (default off); `armed` while either signal
        holds above ``threshold * release_frac`` — the hysteresis band a
        dwell window uses so a trigger is not disarmed by one quiet
        batch. Both are False until `min_batches` batches have seeded
        the EWMAs."""
        if not 0.0 <= release_frac <= 1.0:
            raise ValueError("release_frac must be in [0, 1]")
        warmed = self.n_batches >= self.min_batches
        cls = self.class_mix_shift()
        feat = self.feature_shift()
        trig = warmed and (cls >= class_threshold
                           or feat >= feature_threshold)
        armed = warmed and (cls >= class_threshold * release_frac
                            or feat >= feature_threshold * release_frac)
        return DriftVerdict(
            triggered=trig, armed=armed, warmed_up=warmed,
            class_mix_shift=cls, feature_shift=feat,
            class_threshold=class_threshold,
            feature_threshold=feature_threshold,
        )

    def rebaseline(self) -> None:
        """Re-anchor the slow sketches at the fast ones' current state.

        Called after a corrective actuation (a re-optimized pipeline was
        swapped in): the new pipeline's prediction mix *will* differ from
        the old baseline — that is the point — so without re-anchoring
        the monitor would immediately re-trigger on its own fix. The fast
        sketches and flow/batch counts survive; running maxima reset so
        post-fix excursions are measured against the new baseline."""
        if self._fast_mix is not None:
            self._slow_mix = self._fast_mix.copy()
        if self._feat_slow is not None and self._feat_fast is not None:
            # restart the slow moments centered on the recent mean: the
            # variance re-seeds from post-fix batches
            fresh = StreamingMoments(len(self._feat_fast))
            fresh.update(self._feat_fast[None, :])
            self._feat_slow = fresh
        self.max_class_shift = 0.0
        self.max_feature_shift = 0.0

    def signal(self) -> dict:
        return {
            "n_batches": self.n_batches,
            "n_flows": self.n_flows,
            "class_mix_shift": self.class_mix_shift(),
            "max_class_shift": self.max_class_shift,
            "feature_shift": self.feature_shift(),
            "max_feature_shift": self.max_feature_shift,
            "confidence": self.confidence(),
        }
