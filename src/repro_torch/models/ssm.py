"""SSM-family mixers: Mamba-2 (SSD).

Port of the Mamba-2 half of `repro.models.ssm`. Prefill runs the chunked
SSD decomposition through the kernel B8 (`repro_torch.kernels.ops.
mamba_scan`: one launch per layer gives y and the final state; a CPU
tensor runs its plain version, `chunked_ssd` with one shared B/C group).
Decode is the O(1)-per-token state recurrence in plain torch, as in the
reference, which has no kernel there; `mamba2_decode_step` updates the
state it is given in place (JAX returns a new one).

The xLSTM mixers (mLSTM with per-head keys, G = H, and sLSTM) wait for
ROADMAP A12e.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.mamba_scan import chunked_ssd
from .layers import init_dense, init_norm, param, rms_norm

__all__ = [
    "Mamba2",
    "chunked_ssd",
    "init_mamba2",
    "mamba2_decode_step",
    "mamba2_forward",
    "mamba2_init_state",
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


def mamba2_forward(x: torch.Tensor, p: Mamba2, cfg):
    """x (B,T,d) -> (out (B,T,d), {"ssm": final state (B,H,P,S) float32,
    "conv": the conv input's last K-1 steps})."""
    B, T, d = x.shape
    di, H, S = _mamba_dims(d, cfg)
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
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p.norm)
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


def mamba2_decode_step(x: torch.Tensor, state: dict, p: Mamba2, cfg):
    """x (B, d) single token; updates ``state["ssm"]`` and ``state["conv"]``
    in place and returns (out (B, d), state)."""
    B, d = x.shape
    di, H, S = _mamba_dims(d, cfg)
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
    yv = rms_norm(yv * F.silu(z.float()).to(x.dtype), p.norm)
    state["ssm"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return yv @ p.w_out, state
