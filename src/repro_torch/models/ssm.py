"""SSM-family mixers: Mamba-2 (SSD) and xLSTM (mLSTM / sLSTM).

Port of `repro.models.ssm`. Mamba-2's prefill runs the chunked
SSD decomposition through the kernel B8 (`repro_torch.kernels.ops.
mamba_scan`: one launch per layer gives y and the final state; a CPU
tensor runs its plain version, `chunked_ssd` with one shared B/C group).
Decode is the O(1)-per-token state recurrence in plain torch, as in the
reference, which has no kernel there; `mamba2_decode_step` updates the
state it is given in place (JAX returns a new one).

The mLSTM is gated linear attention in the same chunked form, with
per-head keys (G = H groups of head dim d / H: 256 at xlstm-350m), which
B8 does not take (one shared B/C group, as the TPU kernel): its prefill
runs `chunked_ssd`, the reference's own jnp path, in torch ops, and its
decode the O(1) recurrence. The sLSTM is a per-unit scalar recurrence,
scanned over time by a Python loop, one step per token, as the reference
scans it. The decode steps update the states they are given in place.

Under a model axis (`tp`, `layers.tp_of`; the forwards take the whole
normed input and return the row-parallel product's partial sum, or of a
block replicated whole its whole output) Mamba2 runs on this rank's heads:
`w_in`'s z, x and dt columns and `conv_w`'s x columns are its heads',
B and C whole (one group shared by every head), B8/B8b over its heads, the
gated norm over the cut inner dimension with its mean of squares summed
over the axis (`layers.rms_norm_tp`), `w_out` row-parallel. The mLSTM runs
on its heads the same way (`w_gates` cut per gate). The sLSTM runs whole
on every rank: cutting its gates would need an all-gather of h at every
one of its T steps. The decode steps run the same way: Mamba2's on its
local heads, with the conv state cut as `conv_w` (its x channels this
rank's heads', B and C whole) and the inner norm through `rms_norm_tp`;
the mLSTM's on its local heads; the sLSTM's whole.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.mamba_scan import chunked_ssd
from .layers import init_dense, init_norm, param, rms_norm, rms_norm_tp, whole_block

__all__ = [
    "MLSTM",
    "Mamba2",
    "SLSTM",
    "chunked_ssd",
    "init_mamba2",
    "init_mlstm",
    "init_slstm",
    "mamba2_decode_step",
    "mamba2_forward",
    "mamba2_init_state",
    "mamba2_whole",
    "mlstm_decode_step",
    "mlstm_forward",
    "mlstm_whole",
    "slstm_decode_step",
    "slstm_forward",
]

_CONV_K = 4
_HEAD_P = 64


def _mamba_dims(d: int, cfg):
    di = cfg.ssm_expand * d
    return di, di // _HEAD_P, cfg.ssm_state


class Mamba2(nn.Module):
    """w_in (d, 2di + 2S + H), conv_w (4, di + 2S), A_log, D and dt_bias
    (H,) in float32, norm (di,), w_out (di, d)."""

    def __init__(self, d: int, cfg, dtype, device):
        super().__init__()
        di, H, S = _mamba_dims(d, cfg)
        self.w_in = param((d, 2 * di + 2 * S + H), dtype, device)
        self.conv_w = param((_CONV_K, di + 2 * S), dtype, device)
        self.A_log = param((H,), torch.float32, device)
        self.D = param((H,), torch.float32, device)
        self.dt_bias = param((H,), torch.float32, device)
        self.norm = param((di,), dtype, device)
        self.w_out = param((di, d), dtype, device)


def init_mamba2(p: Mamba2, gen: torch.Generator) -> Mamba2:
    """Fill `p` from `gen` as the reference initialises; returns p."""
    init_dense(p.w_in, gen)
    init_dense(p.conv_w, gen, scale=0.2)
    p.A_log.zero_()
    p.D.fill_(1.0)
    p.dt_bias.zero_()
    init_norm(p.norm)
    init_dense(p.w_out, gen)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor):
    """Depthwise causal conv along T from a zero state. x (B,T,C), w (K,C).
    Returns (y, tail)."""
    K = w.shape[0]
    pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    y = xp[:, 0:T] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + T] * w[i]
    return F.silu(y.float()).to(x.dtype), xp[:, -(K - 1):]


def _mamba_split(zxbcdt: torch.Tensor, di: int, H: int, S: int):
    return torch.split(zxbcdt, [di, di, S, S, H], dim=-1)


def _inner_norm(y: torch.Tensor, w: torch.Tensor, tp, whole: bool):
    """The norm over a block's inner dimension: cut over the model axis
    unless the block is whole."""
    if tp is None or whole:
        return rms_norm(y, w)
    return rms_norm_tp(y, w, tp)


def mamba2_whole(p: Mamba2, cfg, tp) -> bool:
    """Whether this Mamba2 block runs whole on every rank."""
    return whole_block(tp, p.A_log.shape[0],
                       _mamba_dims(cfg.d_model, cfg)[1])


def mamba2_forward(x: torch.Tensor, p: Mamba2, cfg, tp=None):
    """x (B,T,d) -> (out (B,T,d), {"ssm": final state (B,H,P,S) float32,
    "conv": the conv input's last K-1 steps}); under a model axis on this
    rank's H heads (module docstring)."""
    B, T, d = x.shape
    S = cfg.ssm_state
    H = p.A_log.shape[0]
    di = H * _HEAD_P
    zxbcdt = x @ p.w_in
    z, xs, B_, C_, dt = _mamba_split(zxbcdt, di, H, S)
    conv_out, conv_tail = _causal_conv(torch.cat([xs, B_, C_], dim=-1), p.conv_w)
    xs, B_, C_ = torch.split(conv_out, [di, S, S], dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    xh = xs.reshape(B, T, H, _HEAD_P)
    y, h_last = ops.mamba_scan(xh.contiguous(), dt.contiguous(), A,
                               B_.contiguous(), C_.contiguous(),
                               chunk=cfg.ssd_chunk)
    y = (y + p.D[None, None, :, None] * xh).to(x.dtype).reshape(B, T, di)
    y = _inner_norm(y * F.silu(z.float()).to(y.dtype), p.norm, tp,
                    mamba2_whole(p, cfg, tp))
    out = (y @ p.w_out).to(x.dtype)
    return out, {"ssm": h_last, "conv": conv_tail}


def mamba2_init_state(batch: int, d: int, cfg, dtype, device) -> dict:
    di, H, S = _mamba_dims(d, cfg)
    return {
        "ssm": torch.zeros((batch, H, _HEAD_P, S), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, _CONV_K - 1, di + 2 * S), dtype=dtype,
                            device=device),
    }


def mamba2_decode_step(x: torch.Tensor, state: dict, p: Mamba2, cfg,
                       tp=None):
    """x (B, d) single token; updates ``state["ssm"]`` and ``state["conv"]``
    in place and returns (out (B, d), state); under a model axis on this
    rank's heads (module docstring), out the row-parallel partial sum."""
    B, d = x.shape
    S = cfg.ssm_state
    H = p.A_log.shape[0]
    di = H * _HEAD_P
    z, xs, B_, C_, dt = _mamba_split(x @ p.w_in, di, H, S)
    conv_in = torch.cat([xs, B_, C_], dim=-1)[:, None, :]
    window = torch.cat([state["conv"], conv_in], dim=1)          # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, p.conv_w)
    y = F.silu(y.float()).to(x.dtype)
    xs, B_, C_ = torch.split(y, [di, S, S], dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias)                      # (B,H)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)                                    # (B,H)
    xh = xs.reshape(B, H, _HEAD_P).float()
    upd = (dt[..., None] * xh)[..., None] * B_.float()[:, None, None, :]
    h = decay[..., None, None] * state["ssm"] + upd              # (B,H,P,S)
    yh = (h * C_.float()[:, None, None, :]).sum(-1)              # (B,H,P)
    yh = yh + p.D[None, :, None] * xh
    yv = yh.reshape(B, di).to(x.dtype)
    yv = _inner_norm(yv * F.silu(z.float()).to(x.dtype), p.norm, tp,
                     mamba2_whole(p, cfg, tp))
    state["ssm"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return yv @ p.w_out, state


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (chunked gated linear attention) and sLSTM (scalar recurrence)
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """w_q, w_k, w_v (d, d), w_gates (d, 2H) float32, norm (d,), w_out
    (d, d)."""

    def __init__(self, d: int, n_heads: int, dtype, device):
        super().__init__()
        self.w_q = param((d, d), dtype, device)
        self.w_k = param((d, d), dtype, device)
        self.w_v = param((d, d), dtype, device)
        self.w_gates = param((d, 2 * n_heads), torch.float32, device)
        self.norm = param((d,), dtype, device)
        self.w_out = param((d, d), dtype, device)


def init_mlstm(p: MLSTM, gen: torch.Generator) -> MLSTM:
    for w in (p.w_q, p.w_k, p.w_v, p.w_gates):
        init_dense(w, gen)
    init_norm(p.norm)
    init_dense(p.w_out, gen)
    return p


def mlstm_whole(p: MLSTM, n_heads: int, tp) -> bool:
    """Whether this mLSTM block runs whole on every rank."""
    return whole_block(tp, p.w_gates.shape[1] // 2, n_heads)


def mlstm_forward(x: torch.Tensor, p: MLSTM, n_heads: int, chunk: int = 128,
                  tp=None):
    """x (B, T, d) -> (out (B, T, d), final state (B, H, hd, hd) float32);
    under a model axis on this rank's H heads (module docstring)."""
    B, T, d = x.shape
    hd = d // n_heads
    H = p.w_gates.shape[1] // 2
    q = (x @ p.w_q).reshape(B, T, H, hd)
    k = (x @ p.w_k).reshape(B, T, H, hd)
    v = (x @ p.w_v).reshape(B, T, H, hd)
    gates = x.float() @ p.w_gates
    i_g, f_g = torch.chunk(gates, 2, dim=-1)                  # (B, T, H)
    y, h_last = chunked_ssd(v, F.logsigmoid(f_g), torch.sigmoid(i_g),
                            k * (hd ** -0.5), q, chunk=chunk)
    y = _inner_norm(y.reshape(B, T, H * hd), p.norm, tp,
                    mlstm_whole(p, n_heads, tp))
    return y @ p.w_out, h_last


def mlstm_decode_step(x: torch.Tensor, state: torch.Tensor, p: MLSTM,
                      n_heads: int, tp=None):
    """x (B, d); state (B, H, hd_v, hd_k) float32, updated in place.
    Returns (out (B, d), state); under a model axis on this rank's H heads
    (module docstring), out the row-parallel partial sum."""
    B, d = x.shape
    hd = d // n_heads
    H = p.w_gates.shape[1] // 2
    q = (x @ p.w_q).reshape(B, H, hd)
    k = (x @ p.w_k).reshape(B, H, hd) * (hd ** -0.5)
    v = (x @ p.w_v).reshape(B, H, hd)
    gates = x.float() @ p.w_gates
    i_g, f_g = torch.chunk(gates, 2, dim=-1)                  # (B, H)
    f_s, i_s = torch.sigmoid(f_g), torch.sigmoid(i_g)
    upd = (i_s[..., None] * v.float())[..., None] * k.float()[:, :, None, :]
    h = f_s[..., None, None] * state + upd                    # (B, H, hd, hd)
    y = (h * q.float()[:, :, None, :]).sum(-1)                # (B, H, hd)
    y = _inner_norm(y.reshape(B, H * hd).to(x.dtype), p.norm, tp,
                    mlstm_whole(p, n_heads, tp))
    state.copy_(h)
    return y @ p.w_out, state


class SLSTM(nn.Module):
    """w_x and w_h (d, 4d), norm (d,), w_out (d, d)."""

    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.w_x = param((d, 4 * d), dtype, device)
        self.w_h = param((d, 4 * d), dtype, device)
        self.norm = param((d,), dtype, device)
        self.w_out = param((d, d), dtype, device)


def init_slstm(p: SLSTM, gen: torch.Generator) -> SLSTM:
    init_dense(p.w_x, gen)
    init_dense(p.w_h, gen)
    init_norm(p.norm)
    init_dense(p.w_out, gen)
    return p


def _slstm_cell(g: torch.Tensor, c: torch.Tensor, n: torch.Tensor, dtype):
    """One step from the gate pre-activations g (B, 4d): (c, n, h)."""
    i, f, z, o = torch.chunk(g.float(), 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c = f * c + i * torch.tanh(z)
    n = f * n + i
    return c, n, (o * c / torch.clamp(n, min=1.0)).to(dtype)


def slstm_forward(x: torch.Tensor, p: SLSTM):
    """Scalar LSTM scanned over time. x (B, T, d) -> (out (B, T, d),
    (c, n, h) after the last step). On meta tensors (the census,
    `launch.step_stats`) the T steps run as one batch of the same
    products and elementwise ops, the recurrence's h standing in for a
    slice of the gates (it has no values to carry), so that counting them
    does not walk every step in Python."""
    B, T, d = x.shape
    gx = x @ p.w_x                                            # (B, T, 4d)
    if x.is_meta:
        state = torch.empty((B, T, d), dtype=torch.float32, device=x.device)
        c, n, h = _slstm_cell(gx + gx[..., :d] @ p.w_h, state, state, x.dtype)
        y = rms_norm(h, p.norm)
        return y @ p.w_out, (c[:, -1], n[:, -1], h[:, -1])
    c = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    n = torch.zeros_like(c)
    h = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(T):
        c, n, h = _slstm_cell(gx[:, t] + h @ p.w_h, c, n, x.dtype)
        ys.append(h)
    y = rms_norm(torch.stack(ys, dim=1), p.norm)
    return y @ p.w_out, (c, n, h)


def slstm_decode_step(x: torch.Tensor, state, p: SLSTM):
    """x (B, d); state (c, n, h), updated in place. Returns (out (B, d),
    state)."""
    c, n, h = state
    c2, n2, h2 = _slstm_cell(x @ p.w_x + h @ p.w_h, c, n, x.dtype)
    c.copy_(c2)
    n.copy_(n2)
    h.copy_(h2)
    return rms_norm(h2, p.norm) @ p.w_out, state
