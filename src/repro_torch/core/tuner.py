"""PipelineTuner: CATO's multi-objective BO applied to LM serving configs.

Beyond-paper integration (DESIGN.md §3): the Optimizer is profiler-agnostic,
so the same BO machinery that searches (feature set × connection depth) for
traffic pipelines searches (serving knobs) for LM pipelines:

    knobs: KV dtype (bf16/int8), attention window (the LM analogue of the
           paper's *connection depth* — how much context the pipeline
           consumes), microbatch count, remat policy, decode batch.

    cost(x) = roofline-model step time for the target cell (same hardware
              constants as §Roofline; or a real dry-run measure_fn when
              compile time is paid);
    perf(x) = quality proxy: fraction of full-quality attention/precision
              retained (window and int8-KV discount it).

`ConfigSpace` implements the SearchSpace protocol (encode / sample_uniform /
mutate), so `CatoOptimizer(space=ConfigSpace(...), profiler=...)` runs
unchanged — including the RF surrogate and EHVI acquisition. Priors are
optional (a `ConfigPriors` with pi_log) mirroring the Beta-depth prior:
smaller windows are a priori cheaper.

The port's own copy of `repro.core.tuner` (numpy only), so that the port
never imports the JAX package. Its roofline constants are the H100's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .optimizer import CatoOptimizer, CatoResult

__all__ = ["ServingConfig", "ConfigSpace", "ConfigPriors", "PipelineTuner"]

_KV_DTYPES = ("bf16", "int8")
_REMAT = ("none", "block")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    kv_dtype: str = "bf16"
    window: int = 32768         # attention window (context consumed)
    microbatches: int = 1
    remat: str = "block"
    decode_batch: int = 128

    def key(self):
        return dataclasses.astuple(self)


@dataclasses.dataclass
class ConfigSpace:
    max_window: int = 32768
    min_window: int = 1024
    batches: tuple = (32, 64, 128, 256)
    microbatch_opts: tuple = (1, 2, 4, 8)

    @property
    def dim(self) -> int:
        return 5

    def encode(self, x: ServingConfig) -> np.ndarray:
        return np.array([
            _KV_DTYPES.index(x.kv_dtype),
            math.log2(x.window),
            math.log2(x.microbatches),
            _REMAT.index(x.remat),
            math.log2(x.decode_batch),
        ], dtype=np.float32)

    def sample_uniform(self, rng: np.random.Generator, n: int):
        out = []
        for _ in range(n):
            w = 2 ** int(rng.integers(
                int(math.log2(self.min_window)), int(math.log2(self.max_window)) + 1
            ))
            out.append(ServingConfig(
                kv_dtype=_KV_DTYPES[rng.integers(len(_KV_DTYPES))],
                window=w,
                microbatches=int(rng.choice(self.microbatch_opts)),
                remat=_REMAT[rng.integers(len(_REMAT))],
                decode_batch=int(rng.choice(self.batches)),
            ))
        return out

    def mutate(self, rng: np.random.Generator, x: ServingConfig,
               depth_step: int | None = None) -> ServingConfig:
        f = rng.integers(5)
        kw = dataclasses.asdict(x)
        if f == 0:
            kw["kv_dtype"] = _KV_DTYPES[rng.integers(len(_KV_DTYPES))]
        elif f == 1:
            w = kw["window"] * (2 if rng.random() < 0.5 else 0.5)
            kw["window"] = int(np.clip(w, self.min_window, self.max_window))
        elif f == 2:
            kw["microbatches"] = int(rng.choice(self.microbatch_opts))
        elif f == 3:
            kw["remat"] = _REMAT[rng.integers(len(_REMAT))]
        else:
            kw["decode_batch"] = int(rng.choice(self.batches))
        return ServingConfig(**kw)


@dataclasses.dataclass
class ConfigPriors:
    """Smaller windows a priori cheaper (Beta(1,2) over log-window),
    uniform elsewhere — the LM analogue of the paper's depth prior."""

    space: ConfigSpace

    def pi_log(self, space, x: ServingConfig) -> float:
        lo = math.log2(self.space.min_window)
        hi = math.log2(self.space.max_window)
        u = (math.log2(x.window) - lo) / max(hi - lo, 1e-9)
        return float(np.log(max(2 * (1 - u), 1e-3)))


class PipelineTuner:
    """cost(x): analytic roofline step-time for a serving cell;
    perf(x): retained-quality proxy. Swap `profile` for a dry-run-backed
    measure to pay compile time for exactness (the §Perf hillclimb path)."""

    # NVIDIA H100 SXM datasheet: dense bf16 on the tensor cores, HBM3, and
    # NVLink 4 (900 GB/s both ways, 450 GB/s one way)
    PEAK, HBM, LINK = 989e12, 3.35e12, 450e9

    def __init__(self, cfg, chips: int = 256, profile=None):
        self.cfg = cfg
        self.chips = chips
        self._external = profile

    def profile(self, x: ServingConfig):
        if self._external is not None:
            return self._external(x)
        c = self.cfg
        kvb = 2 if x.kv_dtype == "bf16" else 1
        L, H, hd, d = c.n_layers, c.n_kv_heads, c.hd, c.d_model
        # decode step: stream params once per token + read KV window
        param_bytes = c.active_params * 2 / self.chips
        kv_bytes = L * x.decode_batch * min(x.window, c.max_seq) * H * hd * 2 \
            * kvb / self.chips
        t_mem = (param_bytes + kv_bytes) / self.HBM
        flops = 2 * c.active_params * x.decode_batch / self.chips
        t_comp = flops / self.PEAK
        # TP all-reduces per layer (2) on (batch, d) activations
        coll = 2 * L * x.decode_batch * d * 2 * 2 / self.chips
        t_coll = coll / self.LINK
        step = max(t_mem, t_comp, t_coll) * (1 + 0.1 * (x.microbatches - 1))
        # cost per *generated token*: batching amortizes weight streaming
        # until the KV reads dominate — the real decode tradeoff
        cost = step / x.decode_batch
        # quality proxy: window truncation + int8 KV discount, normalized to
        # the search space's full window
        max_w = 32768
        q_window = min(1.0, 0.35 + 0.65 * math.log2(max(x.window, 2))
                       / math.log2(max_w)) / 1.0
        q_window = min(1.0, q_window / (0.35 + 0.65))
        q_kv = 1.0 if x.kv_dtype == "bf16" else 0.985
        q_remat = 1.0  # decode-path remat is quality-neutral
        perf = q_window * q_kv * q_remat
        return cost * 1e6, perf  # (us per generated token, quality in [0,1])

    def tune(self, n_iterations: int = 40, seed: int = 0,
             use_priors: bool = True) -> CatoResult:
        space = ConfigSpace(max_window=min(32768, self.cfg.max_seq))
        priors = ConfigPriors(space) if use_priors else None
        opt = CatoOptimizer(space, self.profile, priors, seed=seed)
        return opt.run(n_iterations)
