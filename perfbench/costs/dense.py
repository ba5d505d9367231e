"""Whole-step costs of the dense family (qwen3): a training step and the
prefill of one sequence. Products with weights count 2 a multiply-add;
attention is B6's or B6b's closed form (`kernels`)."""
from __future__ import annotations

from . import kernels

__all__ = ["layer_matmul", "prefill", "train_step"]


def layer_matmul(m: dict) -> int:
    """Operations of one layer's products with weights, per token."""
    d, hd, ff = m["d_model"], m["head_dim"], m["d_ff"]
    H, Hkv = m["n_heads"], m["n_kv_heads"]
    return 2 * d * (H * hd + 2 * Hkv * hd) + 2 * H * hd * d + 3 * 2 * d * ff


def _head(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab_size"]


def prefill(m: dict, T: int) -> int:
    """Operations of a forward over one sequence of T tokens, logits at
    every position."""
    attn = kernels.b6(1, m["n_heads"], m["n_kv_heads"], T, T,
                      m["head_dim"])[0]
    return T * (m["n_layers"] * layer_matmul(m) + _head(m)) + \
        m["n_layers"] * attn


def train_step(m: dict, B: int, T: int) -> dict:
    """A training step of B sequences of T tokens: ``model`` the forward
    (products, B6, the head) and the backward (twice the products, B6b),
    recomputation not counted; ``remat`` what recomputing each layer in
    the backward adds, which stops at the last tensor the backward needs,
    so the layer's last product (the MLP's W_down) is not run again."""
    N, L = B * T, m["n_layers"]
    b6 = kernels.b6(B, m["n_heads"], m["n_kv_heads"], T, T, m["head_dim"])[0]
    b6b = kernels.b6b(B, m["n_heads"], m["n_kv_heads"], T, m["head_dim"])[0]
    model = 3 * N * (L * layer_matmul(m) + _head(m)) + L * (b6 + b6b)
    remat = N * L * (layer_matmul(m) - 2 * m["d_ff"] * m["d_model"]) + L * b6
    return {"model": model, "remat": remat}
