"""Mixture-of-Experts layer: top-k routing, capacity dispatch, shared experts.

Port of `repro.models.moe`'s single-device path, `moe_ref`, with the
same routing semantics. The expert-parallel `moe_sharded` (a mesh of
chips, all_to_all) waits for the multi-card slice (ROADMAP A); on one card
the reference's own path is `moe_ref`.

The capacity C = ceil(tokens·k / n_experts · capacity_factor) is computed
from the routed experts, while the buffers, the weights and the dispatch
buckets have `cfg.expert_slots` rows (padded for expert parallelism; the
slots past n_experts are never routed to), as in the reference. Slots past
a bucket's capacity are dropped and fall through the residual.

The reference scatters with ``.at[].add``. Here nothing is summed by
atomics, so every run gives the same bits on the card: kept (expert,
position) pairs are unique, so dispatch is a plain indexed write (dropped
slots are written to a spare row past the capacity, which is cut off);
the combine puts each slot's weighted output back in the order the router
chose its experts, (N, k, d), and adds a token's k slots one after the
other, in that order, in x's type. The reference's scatter adds the same
values, but in bucket order. The backward is as deterministic: a slot's
token row is picked from a k-fold broadcast of the tokens by its own
(token, j) pair, each pair once (its gradient writes each pair once, then
sums a token's k pairs), never by a token index repeated k times, whose
gradient torch would add by atomics.

The expert FFN is three batched products over the expert slots (the
reference computes them outside any Pallas kernel), in cuBLAS.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import init_dense, param

__all__ = ["MoE", "SharedExpert", "init_moe", "moe_ref", "router_topk"]


class SharedExpert(nn.Module):
    """w_gate and w_up (d, Fs), w_down (Fs, d); Fs = moe_d_ff x shared."""

    def __init__(self, d: int, f: int, dtype, device):
        super().__init__()
        self.w_gate = param((d, f), dtype, device)
        self.w_up = param((d, f), dtype, device)
        self.w_down = param((f, d), dtype, device)


class MoE(nn.Module):
    """w_router (d, n_experts) float32; w_gate and w_up (slots, d, F),
    w_down (slots, F, d); and, with shared experts, `shared`."""

    def __init__(self, d: int, cfg, dtype, device):
        super().__init__()
        E, Fe, ES = cfg.n_experts, cfg.moe_d_ff, cfg.expert_slots
        self.w_router = param((d, E), torch.float32, device)
        self.w_gate = param((ES, d, Fe), dtype, device)
        self.w_up = param((ES, d, Fe), dtype, device)
        self.w_down = param((ES, Fe, d), dtype, device)
        self.shared = (SharedExpert(d, Fe * cfg.n_shared_experts, dtype, device)
                       if cfg.n_shared_experts else None)


def init_moe(p: MoE, gen: torch.Generator) -> MoE:
    """Fill `p` from `gen` as the reference initialises: one draw for each
    expert weight, repeated over every slot, so that all experts start
    identical (`[None].repeat(ES, 0)`); returns p."""
    init_dense(p.w_router, gen)
    for w in (p.w_gate, p.w_up, p.w_down):
        init_dense(w[0], gen)
        w[1:] = w[0]
    if p.shared is not None:
        init_dense(p.shared.w_gate, gen)
        init_dense(p.shared.w_up, gen)
        init_dense(p.shared.w_down, gen)
    return p


def router_topk(x2d: torch.Tensor, w_router: torch.Tensor, k: int):
    """(N, d) tokens -> (weights (N, k) float32, sel (N, k) int32), in
    float32. `jax.lax.top_k` puts the lower index first among equal
    probabilities; a stable descending sort keeps the indices of equal
    values in increasing order, so its first k columns are that choice
    (`torch.topk` promises no order among ties)."""
    logits = x2d.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, sel = weights[:, :k], sel[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, sel.to(torch.int32)


def _capacity(n_slots: int, n_buckets: int, cf: float) -> int:
    return int(math.ceil(n_slots / n_buckets * cf))


def _dispatch_indices(sel_flat: torch.Tensor, n_buckets: int, capacity: int):
    """Sort token-slots by bucket (stably); return (order, bucket_sorted,
    pos, keep): each sorted slot's position in its bucket, kept below the
    capacity."""
    order = torch.sort(sel_flat, stable=True).indices
    sorted_b = sel_flat[order]
    counts = torch.bincount(sel_flat.long(), minlength=n_buckets)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(sel_flat.shape[0], device=sel_flat.device) \
        - starts[sorted_b.long()]
    return order, sorted_b, pos, pos < capacity


def _expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """buf (E, C, d) -> (E, C, d); each slot's gated FFN."""
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, w_down)


def _shared_expert(x: torch.Tensor, w: SharedExpert) -> torch.Tensor:
    g = x @ w.w_gate
    u = x @ w.w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w.w_down


def _dispatch(x_slots: torch.Tensor, order, sorted_e, pos, keep,
              n_slots: int, capacity: int) -> torch.Tensor:
    """The (slots, C, d) expert buffer: each kept slot's token row at (its
    expert, its position), zeros elsewhere. `x_slots` (N, k, d) holds slot
    (token, j) at [token, j] (a broadcast of the tokens: no copy); `order`
    lists the flat slots token * k + j in bucket order. A dropped slot goes
    to the spare row C, cut off after."""
    k = x_slots.shape[1]
    buf = torch.zeros((n_slots, capacity + 1, x_slots.shape[2]),
                      dtype=x_slots.dtype, device=x_slots.device)
    buf[sorted_e.long(), torch.where(keep, pos, capacity)] = \
        x_slots[order // k, order % k]
    return buf[:, :capacity]


def _combine(out_buf: torch.Tensor, w_sorted, order, sorted_e, pos, keep,
             n_tok: int, k: int) -> torch.Tensor:
    """(N, d): each token's k weighted expert outputs added in the router's
    order, a dropped slot adding 0."""
    safe = torch.where(keep, pos, 0)
    y_slot = out_buf[sorted_e.long(), safe]
    y_slot = torch.where(keep[:, None], y_slot, torch.zeros_like(y_slot)) \
        * w_sorted[:, None].to(out_buf.dtype)
    by_tok = torch.empty_like(y_slot)
    by_tok[order] = y_slot          # back to (token, j) order: unique rows
    by_tok = by_tok.reshape(n_tok, k, -1)
    y = by_tok[:, 0]
    for j in range(1, k):
        y = y + by_tok[:, j]
    return y


def moe_ref(x: torch.Tensor, p: MoE, cfg) -> torch.Tensor:
    """The MoE layer, x (B, T, d) -> (B, T, d)."""
    B, T, d = x.shape
    E, k, cf = cfg.expert_slots, cfg.experts_per_tok, cfg.capacity_factor
    xt = x.reshape(-1, d)
    N = xt.shape[0]
    weights, sel = router_topk(xt, p.w_router, k)
    C = _capacity(N * k, cfg.n_experts, cf)
    order, sorted_e, pos, keep = _dispatch_indices(sel.reshape(-1), E, C)
    buf = _dispatch(xt[:, None].expand(N, k, d), order, sorted_e, pos, keep,
                    E, C)
    out_buf = _expert_ffn(buf, p.w_gate, p.w_up, p.w_down)
    y = _combine(out_buf, weights.reshape(-1)[order], order, sorted_e, pos,
                 keep, N, k)
    if p.shared is not None:
        y = y + _shared_expert(xt, p.shared)
    return y.reshape(B, T, d)
