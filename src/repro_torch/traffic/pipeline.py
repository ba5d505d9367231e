"""The generated end-to-end serving pipeline (paper §3.4, Pipeline Generation).

Port of `repro.traffic.pipeline`. `build_pipeline` takes a feature
representation and its trained forest and returns one callable

    packets (dense flow tensors) -> class predictions

with the forest's tables on the device, made once per pipeline. Two fusion
levels exist, as in the reference:

- ``fused=False`` (two launches): `extraction_fn` computes the ``(N, F)``
  feature matrix with torch ops, then the forest kernel B1
  (``use_kernel=True``, `repro_torch.kernels.ops.forest_infer`) or the
  plain oracle `forest_infer_ref` consumes it.
- ``fused=True`` (one launch): the fused kernel B2 computes the plan's
  columns in the thread that owns each flow and walks the forest on them;
  the feature matrix is never written. The plan is encoded once, here, as
  the int32 op table the kernel interprets.

When the plan is incremental (no median), the pipeline also has the
aggregate entry `predict_agg` of the reuse path (DESIGN.md §12): the fused
pipeline launches B3 on the flows' aggregate rows; the two-launch pipeline
computes the columns with the torch `emit_agg_features` and runs B1 (or
the oracle) on them.

On ``device="cpu"`` each kernel's plain PyTorch version runs instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..convert import forest_tables
from ..core.forest import DenseForest
from ..core.search_space import FeatureRep
from ..device import resolve_device
from ..kernels import ops, ref
from ..kernels.fused_pipeline import (
    agg_op_table,
    encode_plan,
    fused_agg_infer,
    fused_forest_infer,
)
from .extraction import (
    dataset_tensors,
    emit_agg_features,
    extraction_fn,
    plan_is_incremental,
    stats_plan,
)
from .synth import TrafficDataset

__all__ = ["ServingPipeline", "build_pipeline"]


@dataclasses.dataclass
class ServingPipeline:
    rep: FeatureRep
    forest: DenseForest
    _fn: Callable
    device: torch.device
    fused: bool = False
    _agg_fn: Optional[Callable] = None

    def __call__(self, ds: TrafficDataset) -> np.ndarray:
        """Predicted class ids for every flow in the batch."""
        return self.finalize(self.predict_async(ds))

    @property
    def supports_agg(self) -> bool:
        """True when this pipeline has an incremental (aggregate-row)
        inference entry — every feature of the plan is maintainable as a
        running statistic (no median)."""
        return self._agg_fn is not None

    def predict_agg(self, agg, proto, s_port, d_port) -> torch.Tensor:
        """Infer from per-flow aggregate rows (n, AGG_WIDTH) instead of the
        packet window; resolves through `finalize` like any submission.

        `agg` is the flow table's float64 block; it is rounded to float32
        on the host before the copy, as the reference's float32 path
        rounds it, and the columns are computed in float32 on the device.
        The arrays are read before this returns (the copy is synchronous),
        so the caller may reuse them at once."""
        if self._agg_fn is None:
            raise ValueError(
                "pipeline has no incremental entry (plan not incremental)")
        return self._agg_fn(*(
            torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
            for a in (agg, proto, s_port, d_port)))

    def predict_async(self, ds: TrafficDataset) -> torch.Tensor:
        """Submit the batch and return its (N, K) probabilities on the device.

        The copies to the device and the kernels are queued on the current
        stream and the call does not wait for them; only `finalize` blocks.
        Where the batch's arrays are views of pinned host memory (the
        streaming dispatcher's staging arenas), the copies are asynchronous
        too: the caller must not overwrite those arrays until the copies
        have run — the dispatcher waits on a CUDA event recorded after this
        call before it reuses an arena. Arrays in pageable memory are read
        before this returns.
        """
        return self._fn(ds)

    def finalize(self, probs: torch.Tensor) -> np.ndarray:
        """Wait for a `predict_async` result and map it to class labels.
        On a tie the first maximal class wins, as in the reference."""
        idx = torch.argmax(probs, dim=1).cpu().numpy()
        if self.forest.classes is not None:
            return self.forest.classes[idx]
        return idx

    def probabilities(self, ds: TrafficDataset) -> np.ndarray:
        return self._fn(ds).cpu().numpy()

    def warm(self, buckets: "list[int]") -> None:
        """Run a zero-filled batch of every dispatch size in `buckets`.

        Nothing is compiled per configuration here (the one fused kernel
        interprets every plan), so a warmed replacement pipeline can be
        swapped in while the old one serves (DESIGN.md §9.3). Warming
        builds and loads the kernel library if this process has not yet,
        and makes the device allocations of each batch shape once.
        """
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


def build_pipeline(
    rep: FeatureRep,
    forest: DenseForest,
    max_pkts: int,
    *,
    use_kernel: bool = True,
    fused: bool = False,
    device: str | torch.device = "cuda",
) -> ServingPipeline:
    dev = resolve_device(device)
    feat_t, thr_t, leaf_t = forest_tables(forest, dev)
    depth = forest.depth
    plan = stats_plan(rep.features)
    incremental = plan_is_incremental(plan)

    if fused:
        # an incremental plan's table also serves B3, which takes it
        # checked for a median on the host
        table = encode_plan(plan)
        op_table = (agg_op_table(table, dev) if incremental
                    else torch.from_numpy(table).to(dev))
        conn_depth = int(rep.depth)

        def run(ds: TrafficDataset) -> torch.Tensor:
            t = dataset_tensors(ds, dev)
            return fused_forest_infer(
                t["ts"], t["size"], t["direction"], t["ttl"], t["winsize"],
                t["flags"], t["flow_len"], t["proto"], t["s_port"],
                t["d_port"], feat_t, thr_t, leaf_t,
                op_table=op_table, depth=conn_depth, forest_depth=depth)

        run_agg = None
        if incremental:
            def run_agg(agg, proto, s_port, d_port) -> torch.Tensor:
                return fused_agg_infer(
                    agg, proto, s_port, d_port, feat_t, thr_t, leaf_t,
                    op_table=op_table, forest_depth=depth)

        return ServingPipeline(rep, forest, run, dev, fused=True,
                               _agg_fn=run_agg)

    extract = extraction_fn(rep.features, rep.depth, max_pkts, device=dev)
    infer = ops.forest_infer if use_kernel else ref.forest_infer_ref

    def run(ds: TrafficDataset) -> torch.Tensor:
        return infer(extract(ds), feat_t, thr_t, leaf_t, depth)

    run_agg = None
    if incremental:
        def run_agg(agg, proto, s_port, d_port) -> torch.Tensor:
            x = torch.stack(emit_agg_features(
                plan, agg, proto=proto, s_port=s_port, d_port=d_port), dim=1)
            return infer(x, feat_t, thr_t, leaf_t, depth)

    return ServingPipeline(rep, forest, run, dev, _agg_fn=run_agg)
