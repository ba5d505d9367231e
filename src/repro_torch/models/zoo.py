"""Family-level model assembly: init / forward / cache / decode per family.

Port of `repro.models.zoo` for every family: dense, moe, vlm, audio, ssm
(xLSTM) and hybrid.

  init_params(cfg, seed, device)             -> LM (an nn.Module)
  forward(params, batch, cfg)                -> logits (prefill)
  init_cache(cfg, batch, max_len, device)    -> decode cache dict
  decode_step(params, cache, tokens, cfg, max_len=None) -> (logits, cache)

`batch` is a dict: the LM families use {"tokens"} (B, T); whisper (audio)
{"frames", "tokens"}; internvl (vlm) {"patches", "tokens"}. The modality
frontends are stubs, as in the reference: frames and patches arrive as
precomputed embeddings (B, T', d). The parameters are `nn.Module`s whose
attribute names are the reference's pytree keys (`LM.tok_emb`,
`LM.blocks[i].attn.w_q`, `LM.pairs[i].mlstm`, ...); layers are an
`nn.ModuleList` walked by a Python loop where the reference scans over
stacked layers, and the hybrid forward's `lax.cond` is a Python `if`.
`decode_step` updates the cache in place (the KV slots, the SSM, conv and
xLSTM states, ``pos``) and returns it.

Whisper's decode cross-attends the cache's ``xk``/``xv`` (B, mem_len, Hkv,
hd) at ``mem_len``; like the reference, nothing here writes the encoder's
memory into them, so they stay the zeros `init_cache` made.

`loss_fn` is the training objective (`repro_torch.train` drives it).
Autograd differentiates `forward` through B6 and B8's autograd functions,
whose backwards are B6b and B8b; every other op is PyTorch's. Under
``cfg.remat`` "block" (and "dots", which the port maps to "block": it has
no per-op save policy) each layer runs in `torch.utils.checkpoint`, so
only its input is kept and the backward recomputes it, B6 and B8 included
(safe: both, and their backwards, give the same bits every run); a hybrid
layer with the shared attention is two such regions, the attention and
the Mamba layer. "none" keeps every activation. Serving builds no graph: the parameters are made
without ``requires_grad``, and the serving entry points run under
`torch.no_grad`.

Under a model axis (`layers.tp_of`: a process-group context, one rank
included) `loss_fn` trains on this rank's blocks: the embedding looks up
the tokens of its vocabulary rows (the others zero) and sums them over
the axis into the residual's layout; whisper's frames and internvl2's
patches arrive cut over d (`launch.specs.batch_pspecs`) and are gathered
where the residual is whole; the encoder memory is gathered (or taken)
whole once; zamba2's shared block takes the whole [h, e0] (its `w_concat`
is replicated); the head is column-parallel over the vocabulary and the
cross-entropy vocab-parallel (`_xent`). A vocabulary the axis does not
divide (internvl2's 92,553, whisper's 51,865) is replicated, and the
head's input then gathered whole.

`forward` and `decode_step` serve under a model axis the same way, on
this rank's blocks of the weights (`parallel.sharding.tp_pspecs`) and of
the cache (`tp_cache_pspecs`), and return the whole logits on every rank:
the vocab-parallel block all-gathered over the axis, or a replicated
head's as they are. Decode embeds vocab-parallel, runs each layer through
`layers.tp_enter`/`tp_leave` on the (B, d) token, zamba2's concat-skip
embedding whole (`_whole`), the attention over its cache's cut
(`transformer.attn_decode`), the SSM and mLSTM steps on their local heads
and the MoE block through `moe_sharded` at `moe_ref`'s capacity over the
whole batch. A rank holding a cache cut by sequence cannot see its whole
length, so `decode_step` takes it (``max_len``). At a model axis of 1
both are bitwise the one-device path.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel.collectives import (
    all_gather,
    pmax,
    psum_replicated,
    replicated_copy,
)
from ..parallel.sharding import current_ctx, parallel_ctx
from ..spans import backward_span, span
from .config import ModelConfig
from .layers import (
    init_dense,
    init_norm,
    param,
    rms_norm,
    rms_norm_tp,
    tp_enter,
    tp_leave,
    tp_of,
    whole_block,
)
from .ssm import (
    _CONV_K,
    _HEAD_P,
    MLSTM,
    SLSTM,
    Mamba2,
    _mamba_dims,
    init_mamba2,
    init_mlstm,
    init_slstm,
    mamba2_decode_step,
    mamba2_forward,
    mamba2_whole,
    mlstm_decode_step,
    mlstm_forward,
    mlstm_whole,
    slstm_decode_step,
    slstm_forward,
)
from .transformer import (
    Attention,
    Block,
    _ffn,
    attn_decode,
    attn_forward,
    attn_whole,
    block_forward,
    init_attn,
    init_block,
    xattn_decode,
)

__all__ = ["LM", "decode_step", "forward", "init_cache", "init_params", "loss_fn"]

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(cfg.family)


class MambaBlock(nn.Module):
    """One hybrid layer: ln, mamba."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.ln = param((cfg.d_model,), dtype, device)
        self.mamba = Mamba2(cfg.d_model, cfg, dtype, device)


class SharedAttn(nn.Module):
    """zamba2's shared attention block: ln, attn, w_concat (2d, d)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.ln = param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.w_concat = param((2 * cfg.d_model, cfg.d_model), dtype, device)


class XLSTMPair(nn.Module):
    """One xLSTM pair: ln_m, mlstm, ln_s, slstm."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln_m = param((d,), dtype, device)
        self.mlstm = MLSTM(d, cfg.n_heads, dtype, device)
        self.ln_s = param((d,), dtype, device)
        self.slstm = SLSTM(d, dtype, device)


class LM(nn.Module):
    """tok_emb (V, d), ln_f (d,), lm_head (d, V), and the family's layers:
    blocks (a ModuleList of `Block`: dense, moe, vlm), enc_blocks,
    dec_blocks (cross blocks) and ln_enc (audio), pairs (`XLSTMPair`, ssm),
    or blocks of `MambaBlock` and shared (hybrid). Allocated uninitialised
    on `device`; `init_params` fills it from a seed,
    `repro_torch.convert.lm_params_from_numpy` from a reference pytree."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        _check_family(cfg)
        dt, d = _DT[cfg.dtype], cfg.d_model
        self.tok_emb = param((cfg.vocab_size, d), dt, device)
        self.ln_f = param((d,), dt, device)
        self.lm_head = param((d, cfg.vocab_size), dt, device)

        def stack(make, n):
            return nn.ModuleList(make() for _ in range(n))

        if cfg.family in ("dense", "moe", "vlm"):
            self.blocks = stack(lambda: Block(cfg, dt, device), cfg.n_layers)
        elif cfg.family == "audio":
            self.enc_blocks = stack(lambda: Block(cfg, dt, device),
                                    cfg.encoder_layers)
            self.dec_blocks = stack(lambda: Block(cfg, dt, device, cross=True),
                                    cfg.n_layers)
            self.ln_enc = param((d,), dt, device)
        elif cfg.family == "ssm":
            self.pairs = stack(lambda: XLSTMPair(cfg, dt, device),
                               cfg.n_layers // 2)
        else:
            self.blocks = stack(lambda: MambaBlock(cfg, dt, device),
                                cfg.n_layers)
            self.shared = SharedAttn(cfg, dt, device)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> LM:
    """A model of `cfg` on `device`, its weights drawn from a
    `torch.Generator` on that device seeded with `seed` (the reference's
    distributions; not its numbers, which come from `jax.random`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = LM(cfg, dev)
    init_dense(p.tok_emb, gen, scale=0.02)
    init_norm(p.ln_f)
    init_dense(p.lm_head, gen)
    if cfg.family == "audio":
        for blk in (*p.enc_blocks, *p.dec_blocks):
            init_block(blk, gen, cfg)
        init_norm(p.ln_enc)
    elif cfg.family == "ssm":
        for pair in p.pairs:
            init_norm(pair.ln_m)
            init_mlstm(pair.mlstm, gen)
            init_norm(pair.ln_s)
            init_slstm(pair.slstm, gen)
    for blk in getattr(p, "blocks", ()):
        if cfg.family == "hybrid":
            init_norm(blk.ln)
            init_mamba2(blk.mamba, gen)
        else:
            init_block(blk, gen, cfg)
    if cfg.family == "hybrid":
        init_norm(p.shared.ln)
        init_attn(p.shared.attn, gen, cfg)
        init_dense(p.shared.w_concat, gen)
    return p


def _head(p: LM, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, p.ln_f) @ p.lm_head


def _embed(p: LM, tokens: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """The token embeddings in the residual's layout. Vocab-parallel: this
    rank's rows look up the tokens in their range, the others zero, summed
    over the model axis (`layers.tp_leave`)."""
    with span("model.embed", p.tok_emb):
        emb = p.tok_emb
        if tp is None:
            return F.embedding(tokens, emb)
        n = emb.shape[0]
        if whole_block(tp, n, cfg.vocab_size):
            return tp_leave(F.embedding(tokens, emb), tp, whole=True)
        local = tokens - tp.index * n
        ok = (local >= 0) & (local < n)
        e = F.embedding(torch.where(ok, local, torch.zeros_like(local)), emb)
        e = torch.where(ok[..., None], e, torch.zeros((), dtype=e.dtype,
                                                      device=e.device))
        return tp_leave(e, tp)


def _embedded_input(t: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """Frames or patches (B, T', d or its d / tp block) in the residual's
    layout, in the model's type."""
    t = t.to(_DT[cfg.dtype])
    if tp is None:
        return t
    d = cfg.d_model
    if tp.residual == "tp" and t.shape[-1] == d and tp.size > 1:
        n = d // tp.size
        return t.narrow(-1, tp.index * n, n)
    if tp.residual != "tp" and t.shape[-1] != d:
        with torch.no_grad():
            return all_gather(t, tp.axis, t.ndim - 1, tp.mesh)
    return t


def _whole(x: torch.Tensor, tp) -> torch.Tensor:
    """The whole of a residual-layout tensor, for a consumer whose
    gradients each rank computes a part of: an all-gather under residual
    "tp"; else the tensor, through a node of its own, so that its uses'
    gradients add up there, in the order they add up in the all-gather's
    (the same bits at a model axis of 1 as without one)."""
    if tp is not None and tp.residual == "tp":
        return all_gather(x, tp.axis, x.ndim - 1, tp.mesh)
    return x.view_as(x)


def _logits(p: LM, x: torch.Tensor, cfg: ModelConfig, tp):
    """(logits, first vocabulary index): this rank's vocabulary block of
    the logits (all of them without a model axis, or of a replicated
    `lm_head`); span ``model.head``."""
    with span("model.head", x):
        if tp is None:
            return _head(p, x), 0
        n = p.lm_head.shape[1]
        if not whole_block(tp, n, cfg.vocab_size):
            return tp_enter(x, p.ln_f, tp) @ p.lm_head, tp.index * n
        # a replicated head: every rank computes all the logits, so its
        # input is gathered whole with a backward that keeps each rank's
        # block (this rank's block normed first, so that ln_f's gradient
        # stays this rank's part of it, as every norm weight's under
        # residual "tp")
        if tp.residual != "tp":
            return rms_norm(x, p.ln_f) @ p.lm_head, 0
        h = rms_norm_tp(x, p.ln_f, tp)
        k = h.shape[-1]
        h = F.pad(h, (tp.index * k, (tp.size - 1 - tp.index) * k))
        return psum_replicated(h, tp.axis, tp.mesh) @ p.lm_head, 0


def _all_logits(p: LM, x: torch.Tensor, cfg: ModelConfig, tp):
    """The whole logits on every rank: `_logits`' vocabulary block
    all-gathered over the model axis, or a replicated head's as they
    are."""
    logits, _ = _logits(p, x, cfg, tp)
    if tp is not None and not whole_block(tp, p.lm_head.shape[1],
                                          cfg.vocab_size):
        logits = all_gather(logits, tp.axis, logits.ndim - 1, tp.mesh)
    return logits


def _xent(logits: torch.Tensor, targets: torch.Tensor, lo: int, tp):
    """Per-position cross-entropy in float32 from this rank's vocabulary
    block [lo, lo + n) of the logits. Vocab-parallel (`tp`): the shift is
    the maximum over the axis, the sum of exponentials and the target's
    logit are summed over it with `psum_replicated` (every rank computes
    the same loss). The target's logit is picked by a select against the
    vocabulary index (the reference multiplies by a one-hot: the same
    value, a single non-zero term), whose backward is elementwise."""
    m = torch.amax(logits.detach(), dim=-1)
    if tp is not None:
        m = pmax(m, tp.axis, tp.mesh)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    se = torch.exp(logits - m[..., None]).sum(-1)
    vocab = torch.arange(lo, lo + logits.shape[-1], device=logits.device)
    hit = vocab == targets[..., None].long()
    picked = torch.where(hit, logits, torch.zeros((), device=logits.device)
                         ).sum(-1)
    if tp is not None:
        se = psum_replicated(se, tp.axis, tp.mesh)
        picked = psum_replicated(picked, tp.axis, tp.mesh)
    return torch.log(se) + m - picked


def _layers(cfg: ModelConfig, params: LM):
    """How each layer's function is applied: in `torch.utils.checkpoint`
    (non-reentrant) under ``remat`` "block" or "dots" while autograd
    records, else directly. The recomputation runs inside the forward's
    parallel context: on the card autograd runs the backward, and so the
    recomputation, on a thread of its own, where the context (thread-local,
    as the reference's) would otherwise be empty and an MoE layer would
    recompute through `moe_ref` instead of `moe_sharded`. Each application
    is span ``model.layer``, and a recomputation ``model.layer.recompute``
    (`_layer`)."""
    remat = cfg.remat in ("block", "dots") and torch.is_grad_enabled() and \
        any(p.requires_grad for p in params.parameters())
    if not remat:
        return _layer
    ctx = current_ctx()

    def in_ctx(fn):
        def run(*args):
            with parallel_ctx(ctx.mesh, ctx.rules):
                return _layer(fn, *args)
        return run

    return lambda fn, *args: checkpoint(in_ctx(fn), *args,
                                        use_reentrant=False)


def _layer(fn, *args):
    """``fn(*args)`` in span ``model.layer``, or ``model.layer.recompute``
    where autograd runs it again inside the backward (checkpoint)."""
    with span("model.layer", args[0],
              in_backward="model.layer.recompute"):
        return fn(*args)


def _hidden(params: LM, batch: dict, cfg: ModelConfig, tp) -> torch.Tensor:
    """The residual stream after the last layer (this rank's layout of
    it under a model axis), each layer run under ``cfg.remat``."""
    _check_family(cfg)
    fam = cfg.family
    layer = _layers(cfg, params)
    x = _embed(params, batch["tokens"], cfg, tp)
    if fam == "vlm":
        x = torch.cat([_embedded_input(batch["patches"], cfg, tp), x], dim=1)
    if fam in ("dense", "moe", "vlm"):
        for blk in params.blocks:
            x = layer(lambda h, blk=blk: block_forward(h, blk, cfg), x)
        return x
    if fam == "audio":
        enc = _embedded_input(batch["frames"], cfg, tp)
        for blk in params.enc_blocks:
            enc = layer(lambda h, blk=blk: block_forward(h, blk, cfg,
                                                         causal=False), enc)
        enc = rms_norm(_whole(enc, tp) if tp is not None else enc,
                       params.ln_enc)
        for blk in params.dec_blocks:
            x = layer(lambda h, m, blk=blk: block_forward(h, blk, cfg,
                                                          memory=m), x, enc)
        return x
    if fam == "ssm":
        def pair_fn(h, pair):
            whole = mlstm_whole(pair.mlstm, cfg.n_heads, tp)
            y = mlstm_forward(tp_enter(h, pair.ln_m, tp, whole), pair.mlstm,
                              cfg.n_heads, chunk=cfg.ssd_chunk, tp=tp)[0]
            h = h + tp_leave(y, tp, whole)
            y = slstm_forward(tp_enter(h, pair.ln_s, tp, True), pair.slstm)[0]
            return h + tp_leave(y, tp, True)

        for pair in params.pairs:
            x = layer(lambda h, pair=pair: pair_fn(h, pair), x)
        return x
    shared = params.shared
    a_whole = attn_whole(shared.attn, cfg, tp)

    def attn_fn(h, e0):
        a_in = torch.cat([_whole(h, tp), e0], dim=-1) @ shared.w_concat
        a_in = rms_norm(a_in, shared.ln)
        if tp is not None and tp.residual != "tp" and not a_whole:
            a_in = replicated_copy(a_in, tp.axis, tp.mesh)
        return h + tp_leave(attn_forward(a_in, shared.attn, cfg, tp=tp), tp,
                            a_whole)

    def mamba_fn(h, blk):
        whole = mamba2_whole(blk.mamba, cfg, tp)
        y = mamba2_forward(tp_enter(h, blk.ln, tp, whole), blk.mamba, cfg,
                           tp)[0]
        return h + tp_leave(y, tp, whole)

    # a shared-attention application and a Mamba layer are two regions:
    # without remat each frees its input as the old value of x, as serving
    # always did; under remat each keeps only its input. The concat-skip's
    # embedding is one tensor of its own (gathered whole once under a
    # model axis), so the gradients of its uses add up in one place.
    emb0 = _whole(x, tp)
    for i, blk in enumerate(params.blocks):
        if i % cfg.shared_attn_every == 0:
            x = layer(attn_fn, x, emb0)
        x = layer(lambda h, blk=blk: mamba_fn(h, blk), x)
    return x


def forward(params: LM, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Logits of the full sequence: (B, T, V) for ``batch["tokens"]`` (B,
    T); for the vlm family (B, Np + T, V), the patches first; for the audio
    family the decoder's (B, Td, V) over the encoded ``batch["frames"]``.
    Each layer runs under ``cfg.remat`` (`_layers`). Under a model axis
    on this rank's blocks, the whole logits on every rank (module
    docstring)."""
    tp = tp_of(cfg)
    return _all_logits(params, _hidden(params, batch, cfg, tp), cfg, tp)


def loss_fn(params: LM, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy over ``batch["targets"]`` (B, T), in
    float32 from the logits, as `repro.models.loss_fn`: the vlm family
    scores only the text tail (the last T positions), and targets below 0
    are masked out. Under a model axis on this rank's blocks, the
    cross-entropy vocab-parallel (`_xent`); every rank returns the loss.
    Spans: ``model.loss`` from the logits to the loss, and under a
    profiler ``model.head.backward`` over the backward from the loss to
    the last layer's output (the loss's and the head's)."""
    tp = tp_of(cfg)
    h = _hidden(params, batch, cfg, tp)
    logits, lo = _logits(params, h, cfg, tp)
    targets = batch["targets"]
    with span("model.loss", logits):
        logits = logits.float()
        if cfg.family == "vlm":
            logits = logits[:, -targets.shape[1]:]
        cut = tp is not None and not whole_block(
            tp, params.lm_head.shape[1], cfg.vocab_size)
        nll = _xent(logits, targets, lo, tp if cut else None)
        mask = (targets >= 0).float()
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    backward_span("model.head.backward", loss, h)
    return loss


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """The decode cache: per-layer KV (dense, moe, vlm); per-layer KV and
    cross-attention KV of ``mem_len = min(max_len, 1500)`` positions with
    its (B,) lengths (audio); per-pair mLSTM state and sLSTM c, n, h
    (ssm); or per-layer SSM and conv states plus one KV slot per
    shared-attention application point (hybrid). ``pos`` (B,) int32."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt, hd = _DT[cfg.dtype], cfg.hd
    fam = cfg.family

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    pos = zeros((batch,), torch.int32)
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    if fam in ("dense", "moe", "vlm"):
        return {"k": zeros(kv), "v": zeros(kv), "pos": pos}
    if fam == "audio":
        mem_len = min(max_len, 1500)
        xkv = (cfg.n_layers, batch, mem_len, cfg.n_kv_heads, hd)
        return {"k": zeros(kv), "v": zeros(kv), "xk": zeros(xkv),
                "xv": zeros(xkv),
                "mem_len": torch.full((batch,), mem_len, dtype=torch.int32,
                                      device=dev),
                "pos": pos}
    if fam == "ssm":
        n_pairs, d = cfg.n_layers // 2, cfg.d_model
        hd_m = d // cfg.n_heads
        return {
            "mlstm": zeros((n_pairs, batch, cfg.n_heads, hd_m, hd_m),
                           torch.float32),
            "slstm_c": zeros((n_pairs, batch, d), torch.float32),
            "slstm_n": zeros((n_pairs, batch, d), torch.float32),
            "slstm_h": zeros((n_pairs, batch, d)),
            "pos": pos,
        }
    di, H, S = _mamba_dims(cfg.d_model, cfg)
    n_app = math.ceil(cfg.n_layers / cfg.shared_attn_every)
    kv = (n_app, batch, max_len, cfg.n_kv_heads, hd)
    return {
        "ssm": zeros((cfg.n_layers, batch, H, _HEAD_P, S), torch.float32),
        "conv": zeros((cfg.n_layers, batch, _CONV_K - 1, di + 2 * S)),
        "attn_k": zeros(kv),
        "attn_v": zeros(kv),
        "pos": pos,
    }


def decode_step(params: LM, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, max_len: int | None = None):
    """One decode step. tokens (B,) -> (logits (B, V), cache), the cache
    updated in place. Under a model axis `params` and `cache` are this
    rank's blocks (module docstring); ``max_len`` is the whole cache's
    length, which a rank holding a KV cache cut by sequence cannot read
    from its block: needed where the axis does not divide the kv heads
    (None: the cache is whole)."""
    _check_family(cfg)
    fam = cfg.family
    tp = tp_of(cfg)
    if tp is not None and max_len is None and cfg.n_kv_heads % tp.size and \
            fam != "ssm":
        raise ValueError(f"{cfg.n_kv_heads} kv heads over a model axis of "
                         f"{tp.size}: pass the cache's whole length "
                         "(max_len), which decides whether it is cut by "
                         "sequence")
    pos = cache["pos"]
    x = _embed(params, tokens, cfg, tp)                          # (B, d)

    def attn(h, blk_attn, k, v):
        whole = attn_whole(blk_attn, cfg, tp)
        return tp_leave(attn_decode(h, blk_attn, cfg, k, v, pos, tp,
                                    max_len)[0], tp, whole)

    def self_attn(h, blk, i):
        return attn(tp_enter(h, blk.ln1, tp, attn_whole(blk.attn, cfg, tp)),
                    blk.attn, cache["k"][i], cache["v"][i])

    def ffn(h, blk):
        return _ffn(h[:, None], blk, cfg, tp, decode=True)[:, 0]

    if fam in ("dense", "moe", "vlm"):
        for i, blk in enumerate(params.blocks):
            x = x + self_attn(x, blk, i)
            x = x + ffn(x, blk)
    elif fam == "audio":
        mem_max = None if max_len is None else min(max_len, 1500)
        for i, blk in enumerate(params.dec_blocks):
            x = x + self_attn(x, blk, i)
            # cross attention against the cached encoder memory, through B7
            whole = attn_whole(blk.xattn, cfg, tp)
            ax = xattn_decode(tp_enter(x, blk.ln_x, tp, whole), blk.xattn,
                              cfg, cache["xk"][i], cache["xv"][i],
                              cache["mem_len"], tp, mem_max)
            x = x + tp_leave(ax, tp, whole)
            x = x + ffn(x, blk)
    elif fam == "ssm":
        for i, pair in enumerate(params.pairs):
            whole = mlstm_whole(pair.mlstm, cfg.n_heads, tp)
            y, _ = mlstm_decode_step(tp_enter(x, pair.ln_m, tp, whole),
                                     cache["mlstm"][i], pair.mlstm,
                                     cfg.n_heads, tp)
            x = x + tp_leave(y, tp, whole)
            y, _ = slstm_decode_step(
                tp_enter(x, pair.ln_s, tp, True),
                (cache["slstm_c"][i], cache["slstm_n"][i], cache["slstm_h"][i]),
                pair.slstm)
            x = x + tp_leave(y, tp, True)
    else:
        # one KV slot per application point of the shared block (ceil(L /
        # every) slots), not per layer: 38 copies of a long cache would be
        # a 5x memory regression, as the reference notes
        shared = params.shared
        emb0 = _whole(x, tp)   # zamba2's concat-skip uses the embedding
        for i, blk in enumerate(params.blocks):
            if i % cfg.shared_attn_every == 0:
                slot = i // cfg.shared_attn_every
                a_in = torch.cat([_whole(x, tp), emb0], dim=-1) @ \
                    shared.w_concat
                x = x + attn(rms_norm(a_in, shared.ln), shared.attn,
                             cache["attn_k"][slot], cache["attn_v"][slot])
            whole = mamba2_whole(blk.mamba, cfg, tp)
            y, _ = mamba2_decode_step(
                tp_enter(x, blk.ln, tp, whole),
                {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
                blk.mamba, cfg, tp)
            x = x + tp_leave(y, tp, whole)
    pos += 1
    return _all_logits(params, x, cfg, tp), cache
