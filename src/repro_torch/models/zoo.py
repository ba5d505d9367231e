"""Family-level model assembly: init / forward / cache / decode per family.

Port of `repro.models.zoo` for every family: dense, moe, vlm, audio, ssm
(xLSTM) and hybrid.

  init_params(cfg, seed, device)             -> LM (an nn.Module)
  forward(params, batch, cfg)                -> logits (prefill)
  init_cache(cfg, batch, max_len, device)    -> decode cache dict
  decode_step(params, cache, tokens, cfg)    -> (logits, cache)

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
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel.sharding import current_ctx, parallel_ctx
from .config import ModelConfig
from .layers import decode_attention, init_dense, init_norm, mlp, param, rms_norm
from .moe import moe_ref
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
    mlstm_decode_step,
    mlstm_forward,
    slstm_decode_step,
    slstm_forward,
)
from .transformer import (
    Attention,
    Block,
    attn_decode,
    attn_forward,
    block_forward,
    init_attn,
    init_block,
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


def _layers(cfg: ModelConfig, params: LM):
    """How each layer's function is applied: in `torch.utils.checkpoint`
    (non-reentrant) under ``remat`` "block" or "dots" while autograd
    records, else directly. The recomputation runs inside the forward's
    parallel context: on the card autograd runs the backward, and so the
    recomputation, on a thread of its own, where the context (thread-local,
    as the reference's) would otherwise be empty and an MoE layer would
    recompute through `moe_ref` instead of `moe_sharded`."""
    remat = cfg.remat in ("block", "dots") and torch.is_grad_enabled() and \
        any(p.requires_grad for p in params.parameters())
    if not remat:
        return lambda fn, *args: fn(*args)
    ctx = current_ctx()

    def in_ctx(fn):
        def run(*args):
            with parallel_ctx(ctx.mesh, ctx.rules):
                return fn(*args)
        return run

    return lambda fn, *args: checkpoint(in_ctx(fn), *args,
                                        use_reentrant=False)


def forward(params: LM, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Logits of the full sequence: (B, T, V) for ``batch["tokens"]`` (B,
    T); for the vlm family (B, Np + T, V), the patches first; for the audio
    family the decoder's (B, Td, V) over the encoded ``batch["frames"]``.
    Each layer runs under ``cfg.remat`` (`_layers`)."""
    _check_family(cfg)
    fam = cfg.family
    layer = _layers(cfg, params)
    x = F.embedding(batch["tokens"], params.tok_emb)
    if fam == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    if fam in ("dense", "moe", "vlm"):
        for blk in params.blocks:
            x = layer(lambda h, blk=blk: block_forward(h, blk, cfg), x)
        return _head(params, x)
    if fam == "audio":
        enc = batch["frames"].to(_DT[cfg.dtype])
        for blk in params.enc_blocks:
            enc = layer(lambda h, blk=blk: block_forward(h, blk, cfg,
                                                         causal=False), enc)
        enc = rms_norm(enc, params.ln_enc)
        for blk in params.dec_blocks:
            x = layer(lambda h, m, blk=blk: block_forward(h, blk, cfg,
                                                          memory=m), x, enc)
        return _head(params, x)
    if fam == "ssm":
        def pair_fn(h, pair):
            h = h + mlstm_forward(rms_norm(h, pair.ln_m), pair.mlstm,
                                  cfg.n_heads, chunk=cfg.ssd_chunk)[0]
            return h + slstm_forward(rms_norm(h, pair.ln_s), pair.slstm)[0]

        for pair in params.pairs:
            x = layer(lambda h, pair=pair: pair_fn(h, pair), x)
        return _head(params, x)
    shared = params.shared

    def attn_fn(h, e0):
        a_in = torch.cat([h, e0], dim=-1) @ shared.w_concat
        return h + attn_forward(rms_norm(a_in, shared.ln), shared.attn, cfg)

    def mamba_fn(h, blk):
        return h + mamba2_forward(rms_norm(h, blk.ln), blk.mamba, cfg)[0]

    # a shared-attention application and a Mamba layer are two regions:
    # without remat each frees its input as the old value of x, as serving
    # always did; under remat each keeps only its input
    emb0 = x
    for i, blk in enumerate(params.blocks):
        if i % cfg.shared_attn_every == 0:
            x = layer(attn_fn, x, emb0)
        x = layer(lambda h, blk=blk: mamba_fn(h, blk), x)
    return _head(params, x)


def loss_fn(params: LM, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy over ``batch["targets"]`` (B, T), in
    float32 from `forward`'s logits, as `repro.models.loss_fn`: the vlm
    family scores only the text tail (the last T positions), and targets
    below 0 are masked out. The target's logit is picked by a select
    against the vocabulary index (the reference multiplies by a one-hot:
    the same value, a single non-zero term), whose backward is elementwise
    and so the same bits every run."""
    logits = forward(params, batch, cfg).float()
    targets = batch["targets"]
    if cfg.family == "vlm":
        logits = logits[:, -targets.shape[1]:]
    lse = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    hit = vocab == targets[..., None].long()
    picked = torch.where(hit, logits, torch.zeros((), device=logits.device)
                         ).sum(-1)
    mask = (targets >= 0).float()
    return ((lse - picked) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


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
                cfg: ModelConfig):
    """One decode step. tokens (B,) -> (logits (B, V), cache), the cache
    updated in place."""
    _check_family(cfg)
    fam = cfg.family
    pos = cache["pos"]
    x = F.embedding(tokens, params.tok_emb)                      # (B, d)

    def ffn(h, blk):
        h2 = rms_norm(h, blk.ln2)[:, None, :]
        if fam == "moe":
            return moe_ref(h2, blk.moe, cfg)[:, 0]
        return mlp(h2, blk.mlp, cfg.act)[:, 0]

    if fam in ("dense", "moe", "vlm"):
        for i, blk in enumerate(params.blocks):
            a, _, _ = attn_decode(rms_norm(x, blk.ln1), blk.attn, cfg,
                                  cache["k"][i], cache["v"][i], pos)
            x = x + a
            x = x + ffn(x, blk)
    elif fam == "audio":
        B, hd = x.shape[0], cfg.hd
        for i, blk in enumerate(params.dec_blocks):
            a, _, _ = attn_decode(rms_norm(x, blk.ln1), blk.attn, cfg,
                                  cache["k"][i], cache["v"][i], pos)
            x = x + a
            # cross attention against the cached encoder memory, through B7
            qx = (rms_norm(x, blk.ln_x) @ blk.xattn.w_q).reshape(
                B, cfg.heads_eff, hd)
            ax = decode_attention(qx, cache["xk"][i], cache["xv"][i],
                                  cache["mem_len"])
            x = x + ax.reshape(B, cfg.heads_eff * hd) @ blk.xattn.w_o
            x = x + ffn(x, blk)
    elif fam == "ssm":
        for i, pair in enumerate(params.pairs):
            y, _ = mlstm_decode_step(rms_norm(x, pair.ln_m), cache["mlstm"][i],
                                     pair.mlstm, cfg.n_heads)
            x = x + y
            y, _ = slstm_decode_step(
                rms_norm(x, pair.ln_s),
                (cache["slstm_c"][i], cache["slstm_n"][i], cache["slstm_h"][i]),
                pair.slstm)
            x = x + y
    else:
        # one KV slot per application point of the shared block (ceil(L /
        # every) slots), not per layer: 38 copies of a long cache would be
        # a 5x memory regression, as the reference notes
        shared = params.shared
        emb0 = x   # zamba2's concat-skip uses the original embedding
        for i, blk in enumerate(params.blocks):
            if i % cfg.shared_attn_every == 0:
                slot = i // cfg.shared_attn_every
                a_in = torch.cat([x, emb0], dim=-1) @ shared.w_concat
                a, _, _ = attn_decode(rms_norm(a_in, shared.ln), shared.attn,
                                      cfg, cache["attn_k"][slot],
                                      cache["attn_v"][slot], pos)
                x = x + a
            y, _ = mamba2_decode_step(
                rms_norm(x, blk.ln),
                {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
                blk.mamba, cfg)
            x = x + y
    pos += 1
    return _head(params, x), cache
