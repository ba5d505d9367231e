"""Oracles for the port's kernels, and the straddle rule for comparing
pipelines whose feature columns agree only to float32 rounding.

`forest_infer_ref` is the port of `repro.kernels.ref.forest_infer_ref`: the
plain mean over all trees, with no tree blocking. `flow_stats_ref` ports
`repro.kernels.ref.flow_stats_ref`, the masked per-flow statistics. `flash_attention_ref`,
`decode_attention_ref` and `mamba_scan_ref` port the reference's oracles of
the LM kernels: full-softmax attention masked with -inf (a row with no
valid key gives NaN, as the jnp oracle does; the kernels give 0) and the
sequential SSD recurrence, one time step at a time.

`straddled_flows` says which flows may legitimately get different forest
outputs from two feature matrices that agree to rounding. The forest's
thresholds are quantile edges of training features, so a threshold can
equal a feature value exactly, and a column one ulp off then takes the
other branch. A flow is *straddled* when some tree's path, walked with
either matrix, meets a node whose two feature values differ and whose
threshold lies between them (inclusive). Every other flow must agree.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["decode_attention_ref", "flash_attention_ref", "flow_stats_ref",
           "forest_infer_ref", "mamba_scan_ref", "straddled_flows"]


def forest_infer_ref(x, feature, threshold, leaf, depth: int) -> torch.Tensor:
    """Mean leaf payload over trees, (N, K). Matches forest_apply_np."""
    N, T = x.shape[0], feature.shape[0]
    rows = torch.arange(N, device=x.device)[:, None]
    trees = torch.arange(T, device=x.device)[None, :]
    feature = feature.long()
    node = torch.zeros((N, T), dtype=torch.long, device=x.device)
    for _ in range(depth):
        f = feature[trees, node]
        node = 2 * node + 1 + (x[rows, f] > threshold[trees, node]).long()
    return leaf[trees, node - (2 ** depth - 1)].mean(dim=1)


def flow_stats_ref(values, mask) -> torch.Tensor:
    """Masked per-flow stats over packets: (N, 5) = count, sum, sumsq, min,
    max, with min and max 0 on a row with no valid packet."""
    valid = mask != 0
    m = valid.to(torch.float32)
    cnt = m.sum(dim=1)
    s = (values * m).sum(dim=1)
    sq = (values * values * m).sum(dim=1)
    big = torch.tensor(3.4e38, dtype=torch.float32, device=values.device)
    zero = torch.zeros((), dtype=torch.float32, device=values.device)
    mn = torch.where(cnt > 0, torch.where(valid, values, big).amin(dim=1), zero)
    mx = torch.where(cnt > 0, torch.where(valid, values, -big).amax(dim=1), zero)
    return torch.stack([cnt, s, sq, mn, mx], dim=1)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """GQA attention, q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D) -> q's shape and
    type; causal rows see keys up to their position plus ``Tk - Tq``."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    kr = k.repeat_interleave(g, dim=1).float()
    vr = v.repeat_interleave(g, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if causal:
        mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device).tril(Tk - Tq)
        logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vr).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths, *,
                         scale: float | None = None) -> torch.Tensor:
    """One new token per sequence, q (B, Hq, D), against a (B, S, Hkv, D)
    cache whose positions at or past ``lengths`` (B,) are masked."""
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, g, D).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def mamba_scan_ref(x, dt, A, Bm, Cm) -> torch.Tensor:
    """The sequential SSD / Mamba-2 recurrence, one step at a time:

        h_t = exp(dt_t * A) * h_{t-1} + dt_t * (x_t ⊗ B_t);   y_t = C_t · h_t

    x (B, T, H, P), dt (B, T, H), A (H,), Bm/Cm (B, T, S); state (B, H, P,
    S) in float32; returns y (B, T, H, P) in x's type."""
    Bsz, T, H, P = x.shape
    S = Bm.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = Bm.float(), Cm.float(), A.float()
    h = torch.zeros((Bsz, H, P, S), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dtf[:, t] * Af)[:, :, None, None]          # (B,H,1,1)
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] * Bf[:, t, None, None, :]
        h = decay * h + upd
        ys.append((h * Cf[:, t, None, None, :]).sum(-1))             # (B,H,P)
    return torch.stack(ys, dim=1).to(x.dtype)


def straddled_flows(xa, xb, feature, threshold, depth: int) -> np.ndarray:
    """(N,) bool: flows whose path in some tree, under `xa` or `xb`, meets a
    node with ``xa[f] != xb[f]`` and ``min <= threshold <= max``.

    Arguments are numpy arrays (or anything `np.asarray` takes): two
    (N, F) feature matrices and the forest's (T, 2**depth - 1) tables.
    """
    xa = np.asarray(xa, np.float32)
    xb = np.asarray(xb, np.float32)
    feature = np.asarray(feature)
    threshold = np.asarray(threshold, np.float32)
    lo, hi = np.minimum(xa, xb), np.maximum(xa, xb)
    differs = xa != xb
    rows = np.arange(xa.shape[0])
    out = np.zeros(xa.shape[0], bool)
    for x in (xa, xb):
        for t in range(feature.shape[0]):
            node = np.zeros(xa.shape[0], np.int64)
            for _ in range(depth):
                f = feature[t, node]
                th = threshold[t, node]
                out |= (differs[rows, f] & (lo[rows, f] <= th)
                        & (th <= hi[rows, f]))
                node = 2 * node + 1 + (x[rows, f] > th)
    return out
