"""Multi-tenant white-box serving: N models, one fleet (DESIGN.md §15).

Port of `repro.traffic.multi_tenant`. A vantage point runs many analyses
over the same packets. Served black-box, that is N fleets with N flow
tables and N redundant extraction passes; here the tenants share operators
and state:

- **Merged extraction plan** (`merge_stats_plans`): the union of every
  tenant's `stats_plan`, deduplicated on (op, depth), extracted once per
  flow over one `FlowTable` at the union connection depth; each tenant
  reads its column subset through a static index map.
- **One inference pass**: the fused pipeline launches the multi-forest
  kernel B4 (``csrc/fused_multi.cu``: merged columns in the thread that
  owns the flow, then every tenant's forest, stacked on the tree axis, into
  the tenant's own lanes); the unfused pipeline computes the merged columns
  with torch ops and runs the forest kernel B1 per tenant. Tenant by tenant
  both equal the tenant's solo pipeline.
- **Co-optimization**: `MultiTenantRep` / `MultiTenantSpace` /
  `MultiTenantProfiler` expose the joint configuration space to
  `CatoOptimizer` with the union-plan cost (shared ops counted once).

`MultiTenantPipeline` is duck-compatible with `ServingPipeline` (its
`rep` is a genuine union `FeatureRep`, and it has a `device`), so the flow
tables, dispatch, reuse gating, sharding and replay serve it unchanged;
`finalize` returns an ``(n, T)`` per-tenant class matrix and
`results[fid]` holds a length-T vector.

On ``device="cpu"`` each kernel's plain PyTorch version runs instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..convert import forest_tables, multi_forest_tables
from ..core.forest import DenseForest
from ..core.search_space import FeatureRep, SearchSpace
from ..device import resolve_device
from ..kernels import ops, ref
from ..kernels.fused_pipeline import encode_merged_plan, fused_multi_forest_infer
from .extraction import (
    dataset_tensors,
    emit_merged_agg_features,
    emit_merged_columns,
    merge_stats_plans,
    merged_plan_is_incremental,
    stats_plan,
)
from .features import modeled_extraction_cost_ns
from .profiler import ProfileResult, TrafficProfiler
from .synth import TrafficDataset

__all__ = [
    "MultiTenantPipeline",
    "MultiTenantProfiler",
    "MultiTenantRep",
    "MultiTenantSpace",
    "build_multi_tenant_pipeline",
    "union_rep",
]


def union_rep(reps: Sequence[FeatureRep]) -> FeatureRep:
    """The shared-state representation: union features at max depth.

    This is what the fleet's `FlowTable` is sized by: one table holds every
    packet column any tenant needs, to the deepest prefix any tenant reads.
    """
    feats: set[str] = set()
    for r in reps:
        feats.update(r.features)
    return FeatureRep(tuple(sorted(feats)), max(int(r.depth) for r in reps))


@dataclasses.dataclass
class MultiTenantPipeline:
    """N tenants' pipelines behind one `ServingPipeline` interface.

    `predict_async` returns stacked per-tenant probability lanes
    ``(n, sum K_t)`` on the device; `finalize` maps them to an ``(n, T)``
    class matrix (column t equal to tenant t's solo `finalize`). `lanes[t]`
    is tenant t's ``(lo, hi)`` probability slice."""

    rep: FeatureRep                         # union features @ max depth
    tenant_reps: tuple[FeatureRep, ...]
    forests: tuple[DenseForest, ...]
    merged: tuple                           # merged plan: ((entry, depth), ...)
    tenant_cols: tuple[tuple[int, ...], ...]
    lanes: tuple[tuple[int, int], ...]      # per-tenant prob column spans
    _fn: Callable
    device: torch.device
    fused: bool = False
    _agg_fn: Optional[Callable] = None

    @property
    def n_tenants(self) -> int:
        return len(self.tenant_reps)

    @property
    def drift_prob_slice(self) -> slice:
        """Tenant 0's probability lane: the slice the drift monitor's
        confidence signal is computed over (per-tenant class id spaces must
        not mix in one histogram, DESIGN.md §15.4)."""
        lo, hi = self.lanes[0]
        return slice(lo, hi)

    def __call__(self, ds: TrafficDataset) -> np.ndarray:
        return self.finalize(self.predict_async(ds))

    @property
    def supports_agg(self) -> bool:
        return self._agg_fn is not None

    def predict_agg(self, agg, proto, s_port, d_port) -> torch.Tensor:
        """Infer every tenant from per-flow aggregate rows (n, AGG_WIDTH).

        `agg` is the flow table's float64 block; it is rounded to float32
        on the host before the copy, as the reference's float32 path rounds
        it. The copy is synchronous, so the caller may reuse the arrays at
        once. The merged aggregate columns are emitted with torch ops and
        each tenant's forest runs through B1 (or the oracle): the
        reference's unfused route for the low-rate refresh batches."""
        if self._agg_fn is None:
            raise ValueError(
                "pipeline has no incremental entry (plan not incremental)")
        return self._agg_fn(*(
            torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
            for a in (agg, proto, s_port, d_port)))

    def predict_async(self, ds: TrafficDataset) -> torch.Tensor:
        """Submit the batch and return its (N, sum K) lanes on the device,
        without waiting; pinned arrays are read later, on the stream, as
        `ServingPipeline.predict_async` says."""
        return self._fn(ds)

    def probabilities(self, ds: TrafficDataset) -> np.ndarray:
        return self._fn(ds).cpu().numpy()

    def finalize(self, probs: torch.Tensor) -> np.ndarray:
        """Wait for a `predict_async` result; (n, T) class matrix.

        Per tenant: argmax over its own lane slice (the first maximal class
        on a tie), mapped through its own class table, as the solo
        `finalize` does."""
        idx = torch.stack([torch.argmax(probs[:, lo:hi], dim=1)
                           for lo, hi in self.lanes], dim=1).cpu().numpy()
        cols = [f.classes[idx[:, t]] if f.classes is not None else idx[:, t]
                for t, f in enumerate(self.forests)]
        return np.stack(cols, axis=1)

    def warm(self, buckets: "list[int]") -> None:
        """Run a zero-filled batch of every dispatch size in `buckets`, at
        the union connection depth the shared table stages (as
        `ServingPipeline.warm`: nothing compiles per configuration)."""
        P = int(self.rep.depth)
        for b in buckets:
            ds = TrafficDataset(
                ts=np.zeros((b, P), np.float32),
                size=np.zeros((b, P), np.float32),
                direction=np.zeros((b, P), np.uint8),
                ttl=np.zeros((b, P), np.float32),
                winsize=np.zeros((b, P), np.float32),
                flags=np.zeros((b, P, 8), np.uint8),
                flow_len=np.zeros(b, np.int32),
                proto=np.zeros(b, np.float32),
                s_port=np.zeros(b, np.float32),
                d_port=np.zeros(b, np.float32),
                label=np.zeros(b, np.int32),
                name="warm",
            )
            self.finalize(self.predict_async(ds))


def build_multi_tenant_pipeline(
    reps: Sequence[FeatureRep],
    forests: Sequence[DenseForest],
    *,
    use_kernel: bool = True,
    fused: bool = False,
    device: str | torch.device = "cuda",
) -> MultiTenantPipeline:
    """Compile N tenants' (rep, forest) pairs into one shared pipeline.

    ``fused=True`` launches B4 once per batch on the card (and raises if it
    cannot); unfused computes the merged columns with torch ops, gathers
    each tenant's columns and runs B1 (``use_kernel=True``) or the oracle
    `forest_infer_ref` per tenant. The incremental (aggregate) entry always
    takes the unfused route, as in the reference: refresh batches are
    low-rate (DESIGN.md §12). The stacked or per-tenant forest tables, and
    the merged op table, go to the device once, here."""
    reps = tuple(reps)
    forests = tuple(forests)
    if len(reps) != len(forests) or not reps:
        raise ValueError("need one forest per tenant rep (and >= 1 tenant)")
    dev = resolve_device(device)
    plans = [stats_plan(r.features) for r in reps]
    merged, tenant_cols = merge_stats_plans(plans, [r.depth for r in reps])
    urep = union_rep(reps)
    lanes, k0 = [], 0
    for f in forests:
        k = int(f.leaf.shape[2])
        lanes.append((k0, k0 + k))
        k0 += k

    incremental = merged_plan_is_incremental(merged)
    if not fused or incremental:
        # the per-tenant route: the unfused pipeline and the aggregate entry
        tables = [forest_tables(f, dev) for f in forests]
        col_idx = [torch.as_tensor(c, dtype=torch.long, device=dev)
                   for c in tenant_cols]
        infer = ops.forest_infer if use_kernel else ref.forest_infer_ref

    def infer_tenants(X: torch.Tensor) -> torch.Tensor:
        return torch.cat([infer(X[:, idx].contiguous(), *tab, f.depth)
                          for idx, tab, f in zip(col_idx, tables, forests)],
                         dim=1)

    if fused:
        feat_t, thr_t, leaf_t, spec_t, resc_t, _ = multi_forest_tables(
            forests, tenant_cols, dev)
        op_table = torch.from_numpy(encode_merged_plan(merged)).to(dev)
        conn_depth = int(urep.depth)

        def run(ds: TrafficDataset) -> torch.Tensor:
            t = dataset_tensors(ds, dev)
            return fused_multi_forest_infer(
                t["ts"], t["size"], t["direction"], t["ttl"], t["winsize"],
                t["flags"], t["flow_len"], t["proto"], t["s_port"],
                t["d_port"], feat_t, thr_t, leaf_t, spec_t, resc_t,
                op_table=op_table, depth=conn_depth, n_out=k0)
    else:
        def run(ds: TrafficDataset) -> torch.Tensor:
            X = torch.stack(emit_merged_columns(
                merged, **dataset_tensors(ds, dev)), dim=1)
            return infer_tenants(X)

    run_agg = None
    if incremental:
        def run_agg(agg, proto, s_port, d_port) -> torch.Tensor:
            X = torch.stack(emit_merged_agg_features(
                merged, agg, proto=proto, s_port=s_port, d_port=d_port), dim=1)
            return infer_tenants(X)

    return MultiTenantPipeline(
        rep=urep, tenant_reps=reps, forests=forests, merged=merged,
        tenant_cols=tenant_cols, lanes=tuple(lanes), _fn=run, device=dev,
        fused=fused, _agg_fn=run_agg,
    )


# ---------------------------------------------------------------------------
# joint configuration space (DESIGN.md §15.5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultiTenantRep:
    """Joint config point: one `FeatureRep` per tenant.

    `features`/`depth` present the union view (what the shared table
    costs are a function of), `key()` the per-tenant identity the
    memoized evaluator caches on."""

    reps: tuple[FeatureRep, ...]

    def __post_init__(self):
        object.__setattr__(self, "reps", tuple(self.reps))

    def key(self) -> tuple:
        return tuple(r.key() for r in self.reps)

    @property
    def features(self) -> tuple[str, ...]:
        return union_rep(self.reps).features

    @property
    def depth(self) -> int:
        return max(int(r.depth) for r in self.reps)


@dataclasses.dataclass
class MultiTenantSpace:
    """Product of per-tenant search spaces, optimizer-protocol compatible
    (encode / sample_uniform / mutate — `CatoOptimizer` needs nothing
    else). Encoding is the concatenation of per-tenant encodings, so the
    surrogate sees the joint space; mutation perturbs one tenant at a
    time (the neighborhood a shared-fleet operator actually explores)."""

    spaces: tuple[SearchSpace, ...]

    def __post_init__(self):
        self.spaces = tuple(self.spaces)

    @property
    def dim(self) -> int:
        return sum(s.dim for s in self.spaces)

    @property
    def size(self) -> float:
        out = 1.0
        for s in self.spaces:
            out *= s.size
        return out

    def encode(self, x: MultiTenantRep) -> np.ndarray:
        return np.concatenate(
            [s.encode(r) for s, r in zip(self.spaces, x.reps)])

    def encode_batch(self, xs: Sequence[MultiTenantRep]) -> np.ndarray:
        return np.stack([self.encode(x) for x in xs])

    def decode(self, v: np.ndarray) -> MultiTenantRep:
        reps, off = [], 0
        for s in self.spaces:
            reps.append(s.decode(v[off:off + s.dim]))
            off += s.dim
        return MultiTenantRep(tuple(reps))

    def sample_uniform(
        self, rng: np.random.Generator, n: int
    ) -> list[MultiTenantRep]:
        per = [s.sample_uniform(rng, n) for s in self.spaces]
        return [MultiTenantRep(tuple(p[i] for p in per)) for i in range(n)]

    def mutate(self, rng: np.random.Generator,
               x: MultiTenantRep) -> MultiTenantRep:
        t = int(rng.integers(len(self.spaces)))
        reps = list(x.reps)
        reps[t] = self.spaces[t].mutate(rng, reps[t])
        return MultiTenantRep(tuple(reps))


class MultiTenantProfiler:
    """Joint profiler: perf is the mean per-tenant hold-out macro-F1,
    cost is the modeled shared-fleet cost — ONE union-plan extraction
    pass (shared ops deduped across tenants, the overlap discount) plus
    every tenant's inference. ``shared=False`` is the ablation arm: the
    same tenants billed as independent fleets (sum of solo costs). Both
    arms share the per-tenant profilers' trained-model caches, so a
    joint-vs-independent comparison trains each distinct (tenant, rep)
    at most once.

    Duck-compatible with `TrafficProfiler` as an evaluator: callable
    ``(x, metric) -> ProfileResult`` over `MultiTenantRep` points, so
    `MemoizedEvaluator`/`CatoOptimizer` drive it unchanged.
    """

    def __init__(self, profilers: Sequence[TrafficProfiler], *,
                 shared: bool = True):
        if not profilers:
            raise ValueError("need >= 1 tenant profiler")
        self.profilers = tuple(profilers)
        self.shared = shared
        self.n_profile_calls = 0

    def _depth_eff(self, depth: int) -> float:
        ds = self.profilers[0].test_ds
        return float(np.minimum(ds.flow_len, depth).mean())

    def __call__(self, x: MultiTenantRep,
                 metric: Optional[str] = None) -> ProfileResult:
        self.n_profile_calls += 1
        f1s, infer_ns, indep_ns = [], [], 0.0
        for p, r in zip(self.profilers, x.reps):
            f1, forest = p.perf_f1(r)
            f1s.append(float(f1))
            inf = p._inference_ns(forest)
            infer_ns.append(inf)
            indep_ns += modeled_extraction_cost_ns(
                r.features, self._depth_eff(r.depth)) + inf
        # union-plan extraction: one pass over the shared table, every
        # shared op across tenants counted once, at the union depth
        shared_ns = modeled_extraction_cost_ns(
            x.features, self._depth_eff(x.depth)) + sum(infer_ns)
        cost_ns = shared_ns if self.shared else indep_ns
        return ProfileResult(
            cost=cost_ns / 1e3,
            perf=float(np.mean(f1s)),
            aux={
                "per_tenant_f1": f1s,
                "cost_shared_us": shared_ns / 1e3,
                "cost_independent_us": indep_ns / 1e3,
                "overlap_discount": 1.0 - shared_ns / max(indep_ns, 1e-9),
                "tenant_infer_ns": infer_ns,
            },
        )
