"""Input specs and sharding assembly for every (arch x shape x mesh) cell.

Port of `repro.launch.specs`. `input_specs(cfg, shape)` returns the model
inputs as meta-device tensors, with the shapes and dtypes of the
reference's `ShapeDtypeStruct`s and no storage. The modality frontends
are stubs: whisper receives precomputed frame embeddings, internvl2
precomputed patch embeddings. `decode_input_specs` gives the decode cache
(`init_cache` on the meta device) and the tokens.

`batch_pspecs` and `cache_pspecs` are the reference's specs (as the
port's spec tuples, `repro_torch.parallel.sharding`).

`build_cell(cfg, shape, mesh, ...)` assembles a cell: the step function
(train, prefill or decode) run under the mesh's parallel context, its
inputs as meta tensors, and the specs by which each rank's inputs are
cut (`local_shard`), parallel to them: the parameters by the port's
tensor-parallel layout (`parallel.sharding.tp_pspecs`; a train cell's
state by `train.optimizer.make_placement`, which adds ZeRO-1's), a
decode cell's cache by `tp_cache_pspecs`, the batch by `batch_pspecs`.
Prefill and decode run over any (data, model) mesh (`models.forward`,
`models.decode_step`). The reference returns a jitted function for
`.lower().compile()`; the port has no compile step: the census of each
cell (`launch.dryrun`) runs it once on meta tensors instead.

`train_collectives` and `serve_collectives` are the closed-form counts of
the collectives one dense training step, prefill or decode step runs
over a (data, model) mesh, by kind: what `parallel.collectives.counts`
must show.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..models import init_cache
from ..models.config import ModelConfig, ShapeSpec
from ..parallel import ParallelCtx, maybe_axis, parallel_ctx
from ..parallel.sharding import (
    default_rules,
    kv_cache_cut,
    tp_cache_pspecs,
    tp_pspecs,
)
from ..serve import make_prefill, make_serve_step
from ..train import AdamW, make_train_step
from ..train.optimizer import make_placement

__all__ = [
    "Cell", "batch_pspecs", "build_cell", "cache_pspecs",
    "decode_input_specs", "input_specs", "serve_collectives", "skip_reason",
    "train_collectives",
]

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_META = torch.device("meta")


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """Cells excluded by the assignment rules (recorded in DESIGN.md §4)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is full-attention ({cfg.family})"
        )
    return None


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Abstract batch for train/prefill shapes ({tokens, targets, ...})."""
    B, T = shape.global_batch, shape.seq_len

    def tok(*s):
        return torch.empty(s, dtype=torch.int32, device=_META)

    def emb(*s):
        return torch.empty(s, dtype=_DT[cfg.dtype], device=_META)

    if cfg.family == "audio":
        Te = Td = T // 2
        batch = {"frames": emb(B, Te, cfg.d_model), "tokens": tok(B, Td)}
        tgt_len = Td
    elif cfg.family == "vlm":
        Np = cfg.num_patches
        Tt = max(T - Np, 1)
        batch = {"patches": emb(B, Np, cfg.d_model), "tokens": tok(B, Tt)}
        tgt_len = Tt
    else:
        batch = {"tokens": tok(B, T)}
        tgt_len = T
    if shape.kind == "train":
        batch["targets"] = tok(B, tgt_len)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec):
    """(cache, tokens) for decode shapes, on the meta device; the cache
    holds `seq_len` positions."""
    B, S = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, B, S, device=_META)
    tokens = torch.empty((B,), dtype=torch.int32, device=_META)
    return cache, tokens


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def batch_pspecs(batch, ctx: ParallelCtx):
    """{name: spec} of a batch dict (or the spec of one tensor): the batch
    axis over dp, and for an embedding input its last axis over tp."""
    def spec(x):
        if x.ndim == 1:
            return (maybe_axis(ctx, "dp", x.shape[0]),)
        if x.ndim == 2:
            return (maybe_axis(ctx, "dp", x.shape[0]), None)
        return (maybe_axis(ctx, "dp", x.shape[0]), None,
                maybe_axis(ctx, "tp", x.shape[-1]))
    if isinstance(batch, torch.Tensor):
        return spec(batch)
    return {k: spec(x) for k, x in batch.items()}


def cache_pspecs(cache: dict, ctx: ParallelCtx, cfg: ModelConfig) -> dict:
    """KV caches: batch->dp; heads->tp when divisible, else sequence->tp
    (sequence-parallel KV). SSM states: heads/channels->tp, batch->dp."""

    def spec(name, x):
        if name in ("k", "v", "xk", "xv", "attn_k", "attn_v"):
            L, B, S, H, hd = x.shape
            dp = maybe_axis(ctx, "dp", B)
            tp_h = maybe_axis(ctx, "tp", H)
            if tp_h is not None:
                return (None, dp, None, tp_h, None)
            return (None, dp, maybe_axis(ctx, "tp", S), None, None)
        if name == "ssm":
            return (None, maybe_axis(ctx, "dp", x.shape[1]),
                    maybe_axis(ctx, "tp", x.shape[2]), None, None)
        if name == "conv":
            return (None, maybe_axis(ctx, "dp", x.shape[1]), None,
                    maybe_axis(ctx, "tp", x.shape[3]))
        if name == "mlstm":
            return (None, maybe_axis(ctx, "dp", x.shape[1]),
                    maybe_axis(ctx, "tp", x.shape[2]), None, None)
        if name.startswith("slstm"):
            return (None, maybe_axis(ctx, "dp", x.shape[1]),
                    maybe_axis(ctx, "tp", x.shape[2]))
        if name in ("pos", "mem_len"):
            return (maybe_axis(ctx, "dp", x.shape[0]),)
        return ()

    return {name: spec(name, x) for name, x in cache.items()}


# ---------------------------------------------------------------------------
# cell assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    fn: object          # the step, run under the mesh's parallel context
    abstract: tuple     # its inputs, as meta tensors
    mode: str           # train | prefill | decode
    specs: tuple        # the specs each rank cuts its inputs by


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               microbatches: int = 1, zero1: bool = True,
               device: str | torch.device = "cuda") -> Cell:
    """The cell of (cfg, shape) on `mesh`: for train, (state, batch) and
    their specs ({"params", "opt"}, batch); for prefill, (params, batch);
    for decode, (params, cache, tokens). `fn` takes inputs on `device`."""
    from ..models.zoo import LM

    rules = default_rules(mesh)
    with parallel_ctx(mesh, rules) as ctx:
        params = LM(cfg, _META)
        shapes = {n: p.shape for n, p in params.named_parameters()}
        p_specs = tp_pspecs(shapes, cfg, ctx)[0]

        if shape.kind == "train":
            opt = AdamW(zero1=zero1)
            pl = make_placement(shapes, mesh, cfg)
            p_specs = pl.params
            base = pl.state if zero1 else p_specs
            opt_specs = {"m": base, "v": base, "step": ()}
            state = {"params": params, "opt": opt.init(params)}
            batch = input_specs(cfg, shape)
            step = make_train_step(cfg, opt, microbatches)

            def train_fn(state, batch):
                with parallel_ctx(mesh, rules):
                    return step(state, batch)

            return Cell(train_fn, (state, batch), "train",
                        ({"params": p_specs, "opt": opt_specs},
                         batch_pspecs(batch, ctx)))

        if shape.kind == "prefill":
            batch = input_specs(cfg, shape)
            prefill = make_prefill(cfg, device)

            def prefill_fn(params, batch):
                with parallel_ctx(mesh, rules):
                    return prefill(params, batch)

            return Cell(prefill_fn, (params, batch), "prefill",
                        (p_specs, batch_pspecs(batch, ctx)))

        cache, tokens = decode_input_specs(cfg, shape)
        sstep = make_serve_step(cfg, device=device, max_len=shape.seq_len)

        def decode_fn(params, cache, tokens):
            with parallel_ctx(mesh, rules):
                return sstep(params, cache, tokens)

        return Cell(decode_fn, (params, cache, tokens), "decode",
                    (p_specs, tp_cache_pspecs(cache, cfg, ctx),
                     batch_pspecs(tokens, ctx)))


# ---------------------------------------------------------------------------
# the collectives of one dense training step, in closed form
# ---------------------------------------------------------------------------

def _dense_param_shapes(cfg: ModelConfig, model: int) -> list:
    """[(local shape, its replicated dimensions' sizes, partial)] of a
    dense model's parameters on a model axis of `model`
    (`parallel.sharding.tp_pspecs` written out): heads, kv heads, d_ff and
    the vocabulary cut, the norms replicated."""
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.heads_eff, cfg.n_kv_heads
    ff, V, M = cfg.d_ff, cfg.vocab_size, model
    by_default = cfg.residual == "tp"
    norm = ((d,), (d,), by_default)
    kv = ((d, Hkv * hd // M), (d,), False) if Hkv % M == 0 else \
        ((d, Hkv * hd), (d, Hkv * hd), True)
    layer = [norm, ((d, H * hd // M), (d,), False), kv, kv,
             ((H * hd // M, d), (d,), False), norm,
             ((d, ff // M), (d,), False), ((ff // M, d), (d,), False)]
    if cfg.act == "swiglu":
        layer.append(((d, ff // M), (d,), False))
    if cfg.qk_norm:
        layer += [((hd,), (hd,), True)] * 2
    return ([((V // M, d), (d,), False), norm, ((d, V // M), (d,), False)]
            + layer * cfg.n_layers)


def train_collectives(cfg: ModelConfig, shape: ShapeSpec, data: int,
                      model: int, microbatches: int = 1) -> dict:
    """{kind: {"calls", "bytes"}} of one `make_train_step` step of a dense
    model over a (data, model) mesh, each call's bytes its input's (as
    `parallel.collectives.counts`), written from the config: for every
    microbatch of B / data / microbatches rows, per layer the forward's,
    the recomputation's under remat and the backward's collectives, the
    embedding's, the head's and the loss's; then the step's loss average
    and ZeRO-1's per parameter (a reduce-scatter into the moments' block
    and an all-gather of the updated block, or an all-reduce where no
    dimension splits over data), one sum of the partial gradients over the
    model axis and the global norm. The recomputation stops at the
    layer's last saved input (`torch.utils.checkpoint`'s early stop), so
    the MLP's exit is not run again. Needs heads, d_ff and the
    vocabulary divisible by `model`."""
    if cfg.family != "dense":
        raise NotImplementedError(f"closed form for dense configs, not "
                                  f"{cfg.family}")
    d, V, M = cfg.d_model, cfg.vocab_size, model
    if cfg.heads_eff % M or cfg.d_ff % M or V % M or d % M:
        raise ValueError(f"{cfg.name} does not cut evenly over {M}")
    es = torch.finfo(_DT[cfg.dtype]).bits // 8
    n = shape.global_batch // data // microbatches * shape.seq_len
    out: dict = {}

    def add(kind, calls, nbytes):
        c = out.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += calls
        c["bytes"] += calls * nbytes

    full, block, f32 = n * d * es, n * d // M * es, n * 4
    remat = cfg.remat in ("block", "dots")
    L, mb = cfg.n_layers, microbatches
    if cfg.residual == "tp":
        # a layer: two entries (the residual all-gathered, then normed
        # whole), two exits (reduce-scatter); backward the transposes
        add("all_gather", L * mb * (2 + 2 * remat), block)
        add("reduce_scatter", L * mb * (2 + remat), full)
        add("reduce_scatter", L * mb * 2, full)
        add("all_gather", L * mb * 2, block)
        # embedding (exit, its backward) and head (entry, its backward)
        add("reduce_scatter", mb * 2, full)
        add("all_gather", mb * 2, block)
    else:
        # a layer: two exits (psum_replicated); backward the two entries'
        # sums (replicated_copy)
        add("all_reduce", L * mb * (2 + remat + 2), full)
        add("all_reduce", mb * 2, full)      # embedding; the head's backward
    add("all_reduce", mb * 3, f32)           # loss: max, sum of exp, target
    add("all_reduce", 1, 4)                  # the loss over data
    partial_numel = 0
    for local, free, partial in _dense_param_shapes(cfg, M):
        numel = math.prod(local)
        if any(dim % data == 0 and dim >= data for dim in free):
            add("reduce_scatter", 1, numel * 4)
            add("all_gather", 1, numel // data * es)
            shard = numel // data
        else:
            add("all_reduce", 1, numel * 4)
            shard = numel
        partial_numel += shard if partial else 0
    if partial_numel:                        # the partial parts, end to end
        add("all_reduce", 1, partial_numel * 4)
    add("all_reduce", 1, 4)                  # the global norm
    return out


def serve_collectives(cfg: ModelConfig, shape: ShapeSpec, data: int,
                      model: int) -> dict:
    """{kind: {"calls", "bytes"}} of one prefill (`shape.kind` "prefill")
    or decode step ("decode") of a dense model over a (data, model) mesh,
    each call's bytes its input's (as `parallel.collectives.counts`),
    written from the config for this rank's B / data sequences: the
    embedding's exit, per layer the attention's and the MLP's entry and
    exit, the head's entry and the all-gather of the vocab-parallel
    logits. A decode step over a KV cache that the model axis cuts by
    sequence (`parallel.sharding.kv_cache_cut` at ``shape.seq_len``) adds
    per layer the all-gather of q over the heads and the merge's maximum
    and sum (`models.layers.decode_attention_merged`); one cut by heads
    adds nothing. Needs heads, d_ff and the vocabulary divisible by
    `model`."""
    if cfg.family != "dense" or shape.kind not in ("prefill", "decode"):
        raise NotImplementedError(f"closed form for dense serving, not "
                                  f"{cfg.family} {shape.kind}")
    d, V, M, hd = cfg.d_model, cfg.vocab_size, model, cfg.hd
    H = cfg.heads_eff
    if H % M or cfg.d_ff % M or V % M or d % M:
        raise ValueError(f"{cfg.name} does not cut evenly over {M}")
    es = torch.finfo(_DT[cfg.dtype]).bits // 8
    b = shape.global_batch // data
    n = b * (shape.seq_len if shape.kind == "prefill" else 1)
    out: dict = {}

    def add(kind, calls, nbytes):
        c = out.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += calls
        c["bytes"] += calls * nbytes

    full, block, L = n * d * es, n * d // M * es, cfg.n_layers
    if cfg.residual == "tp":
        add("reduce_scatter", 1 + 2 * L, full)     # embedding; layer exits
        add("all_gather", 2 * L + 1, block)        # layer entries; head
    else:
        add("all_reduce", 1 + 2 * L, full)
    if shape.kind == "decode" and \
            kv_cache_cut(cfg.n_kv_heads, shape.seq_len, M) == "seq":
        add("all_gather", L, b * H // M * hd * es)     # q to all heads
        add("all_reduce", L, b * H * 4)                # the maxima
        add("all_reduce", L, b * H * (hd + 1) * 4)     # (o w, w)
    add("all_gather", 1, n * V // M * es)          # the logits
    return out
