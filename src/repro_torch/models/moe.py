"""Mixture-of-Experts layer: top-k routing, capacity dispatch, shared
experts, expert parallelism.

Port of `repro.models.moe`, with the same routing semantics in both
paths:

`moe_ref`      — single-device capacity dispatch: the numerical oracle,
                 and the path of one process without an expert-parallel
                 mesh.
`moe_sharded`  — expert parallelism (EP) crossed with tensor parallelism
                 (TP) over a mesh that spans a process group, one process
                 a rank holding its own blocks (`repro_torch.parallel`):
                 tokens cut over the ep axes, d_model over tp, experts
                 over ep; router logits psum'd over tp; a first dispatch
                 to (groups, C, d_loc); all_to_all over ep; a second
                 dispatch to each local expert's (C2) buffer; the expert
                 FFN with its partial products psum_scatter'd over tp;
                 all_to_all back and the weighted combine at the sender.
                 `models.transformer` routes an MoE block here whenever
                 the parallel context spans a process group with ep axes.

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

__all__ = ["MoE", "SharedExpert", "init_moe", "moe_ref", "moe_sharded",
           "router_topk"]


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
    return _topk(x2d.float() @ w_router.float(), k)


def _topk(logits: torch.Tensor, k: int):
    probs = torch.softmax(logits, dim=-1)
    weights, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, sel = weights[:, :k], sel[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, sel.to(torch.int32)


def _capacity(n_slots: int, n_buckets: int, cf: float) -> int:
    return int(math.ceil(n_slots / n_buckets * cf))


def _bucket_counts(b: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """The number of entries of `b` in each of `n_buckets` buckets (int64):
    `torch.bincount`'s, by an integer scatter-add, which also runs on meta
    tensors (the census)."""
    return torch.zeros(n_buckets, dtype=torch.int64, device=b.device) \
        .scatter_add_(0, b.long(), torch.ones(b.shape, dtype=torch.int64,
                                               device=b.device))


def _dispatch_indices(sel_flat: torch.Tensor, n_buckets: int, capacity: int):
    """Sort token-slots by bucket (stably); return (order, bucket_sorted,
    pos, keep): each sorted slot's position in its bucket, kept below the
    capacity."""
    order = torch.sort(sel_flat, stable=True).indices
    sorted_b = sel_flat[order]
    counts = _bucket_counts(sel_flat, n_buckets)
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


# ---------------------------------------------------------------------------
# expert-parallel MoE over a process-group mesh
# ---------------------------------------------------------------------------

def _slot_experts(sel_flat, order, sorted_g, pos, keep, grp, n_groups: int,
                  capacity: int, e_loc: int) -> torch.Tensor:
    """(groups, C) int32: each first-stage slot's expert within its
    destination group, ``e_loc`` where no kept slot sits. The reference
    writes ``e_loc`` for every dropped slot at position 0 of its group
    (`.at[sorted_g, where(keep, pos, 0)].set`, where XLA's last write
    wins), so a group that overflows also loses its position-0 slot; the
    port writes the kept slots, then marks position 0 of each overflowing
    group, which gives the same table without duplicate writes."""
    eid = torch.full((n_groups, capacity + 1), e_loc, dtype=torch.int32,
                     device=sel_flat.device)
    eid[sorted_g.long(), torch.where(keep, pos, capacity)] = torch.where(
        keep, sel_flat[order] % e_loc, e_loc).to(torch.int32)
    eid = eid[:, :capacity].contiguous()
    overflow = _bucket_counts(grp, n_groups) > capacity
    eid[:, 0] = torch.where(overflow, e_loc, eid[:, 0])
    return eid


def moe_sharded(x: torch.Tensor, p: MoE, cfg, mesh, *, ep_axes,
                tp_axis: str = "model", capacity: tuple | None = None
                ) -> torch.Tensor:
    """The MoE layer on this rank's blocks, x (B / G, T, d / tp) -> the
    same block of the output, G the ranks along `ep_axes`; `p` holds this
    rank's blocks of the weights, cut as the reference's ``specs_in``:
    w_router (d / tp, n_experts), w_gate and w_up (slots / G, d / tp, F),
    w_down (slots / G, F / tp, d), the shared expert column- and
    row-parallel (its hidden columns over tp) or whole. Every rank of
    `mesh` (a process-group mesh) calls it together.

    It follows the reference step by step: the capacities C =
    ceil(N_loc k / G cf) a destination group and C2 = ceil(G C / E_loc cf)
    a local expert from the local counts; the invalid slot id E_loc and
    E_loc + 1 second-stage buckets; the router's logits psum'd over tp
    before softmax and top-k; the three partial expert products
    psum_scatter'd over tp on dim 2; the all_to_all back, the weighted
    combine, then the shared expert (on the tokens all-gathered over tp,
    reduce-scattered back to this rank's d block, or of a whole shared
    expert that block kept). What differs: dispatch is an indexed write
    of unique (group, position) and (expert, position) pairs, each dropped
    slot sent to a spare column; the first-stage expert table marks the
    overflow the reference's duplicate write leaves (`_slot_experts`);
    the combine adds a token's k slots in router order (`_combine`), where
    the reference's ``.at[src_tok].add`` adds them in bucket order: the
    same values summed in another order, within float32 rounding of the
    sum (the tests hold it to 1e-5). At G = 1 and tp = 1 every slot goes
    to group 0 in slot order, so the second stage is `moe_ref`'s dispatch
    at capacity C2, and the output and gradients are `moe_ref`'s, bitwise,
    at a capacity factor that makes its capacity C2.

    `capacity` (C, C2) replaces the two capacities. Decode passes C = N_loc
    k (no first-stage drop) and C2 = `moe_ref`'s capacity over all G N_loc
    tokens: the slots a rank receives lie in the senders' order, which is
    the whole batch's token order, so each expert keeps the first C2 of
    them, the slots `moe_ref` keeps on the whole batch."""
    from ..parallel.collectives import all_gather, all_to_all, psum, psum_scatter

    E, k, cf = cfg.expert_slots, cfg.experts_per_tok, cfg.capacity_factor
    G = mesh.axis_size(ep_axes)
    if E % G:
        raise ValueError(f"{E} expert slots do not split over {G} ep ranks: "
                         "pad n_expert_slots to a multiple of the EP size")
    E_loc = E // G
    if p.w_gate.shape[0] != E_loc:
        raise ValueError(f"w_gate holds {p.w_gate.shape[0]} slots; this "
                         f"rank's block is {E_loc} of {E}")
    B, T, d_loc = x.shape
    xt = x.reshape(-1, d_loc)
    N = xt.shape[0]
    if capacity is None:
        C = _capacity(N * k, G, cf)        # per destination group
        C2 = _capacity(G * C, E_loc, cf)   # per local expert after the a2a
    else:
        C, C2 = capacity

    # router: partial logits + psum over tp
    weights, sel = _topk(psum(xt.float() @ p.w_router.float(), tp_axis, mesh), k)

    # first-stage dispatch: destination EP group = expert // E_loc
    sel_flat = sel.reshape(-1)
    grp = sel_flat // E_loc
    order, sorted_g, pos, keep = _dispatch_indices(grp, G, C)
    send = _dispatch(xt[:, None].expand(N, k, d_loc), order, sorted_g, pos,
                     keep, G, C)
    send_eid = _slot_experts(sel_flat, order, sorted_g, pos, keep, grp, G, C,
                             E_loc)

    # tokens to the group that owns their expert
    recv = all_to_all(send, ep_axes, mesh)
    recv_eid = all_to_all(send_eid, ep_axes, mesh)

    # second-stage dispatch to each local expert (invalid -> bucket E_loc)
    flat_tok = recv.reshape(G * C, d_loc)
    order2, sorted_e, pos2, keep2 = _dispatch_indices(recv_eid.reshape(G * C),
                                                      E_loc + 1, C2)
    keep2 = keep2 & (sorted_e < E_loc)
    rows = torch.clamp(sorted_e.long(), max=E_loc - 1)
    ebuf = torch.zeros((E_loc, C2 + 1, d_loc), dtype=x.dtype, device=x.device)
    ebuf[rows, torch.where(keep2, pos2, C2)] = flat_tok[order2]
    ebuf = ebuf[:, :C2]

    # expert FFN: row-parallel over d_loc, psum_scatter to F_loc, then d_loc
    g = psum_scatter(torch.bmm(ebuf, p.w_gate), tp_axis, 2, mesh)
    u = psum_scatter(torch.bmm(ebuf, p.w_up), tp_axis, 2, mesh)
    h = F.silu(g.float()).to(ebuf.dtype) * u
    o = psum_scatter(torch.bmm(h, p.w_down), tp_axis, 2, mesh)

    # back to the a2a slots (order2 is a permutation), return trip, combine
    vals = o[rows, torch.where(keep2, pos2, 0)]
    vals = torch.where(keep2[:, None], vals, torch.zeros_like(vals))
    y_slots = torch.empty_like(vals)
    y_slots[order2] = vals
    y_back = all_to_all(y_slots.reshape(G, C, d_loc), ep_axes, mesh)
    y = _combine(y_back, weights.reshape(-1)[order], order, sorted_g, pos,
                 keep, N, k)

    if p.shared is not None:
        # column- and row-parallel on the tokens all-gathered over tp
        # (this rank's block of its hidden columns, reduce-scattered back
        # to d_loc), or whole where the hidden size does not divide tp
        s = _shared_expert(all_gather(xt, tp_axis, 1, mesh), p.shared)
        tp = mesh.axis_size(tp_axis)
        if tp > 1 and p.shared.w_up.shape[1] == cfg.moe_d_ff * \
                cfg.n_shared_experts:
            y = y + s.narrow(1, mesh.axis_index(tp_axis) * d_loc, d_loc)
        else:
            y = y + psum_scatter(s, tp_axis, 1, mesh)
    return y.reshape(B, T, d_loc)
