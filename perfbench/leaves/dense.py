"""The leaves of a dense model (qwen3): the embedding, the final norm, the
head and per layer its attention (qk-norm where the configuration has it)
and SwiGLU, in the port's names, with how the reference initialises each:
``1/sqrt(d_in)`` for a projection, 0.02 for the embedding, ones for a
norm."""
from __future__ import annotations

__all__ = ["leaves"]


def _block(p: str, m: dict, dt) -> list:
    d, hd = m["d_model"], m["head_dim"]
    H, Hkv, ff = m["n_heads"], m["n_kv_heads"], m["d_ff"]
    out = [(f"{p}.ln1", (d,), dt, ("const", 1.0)),
           (f"{p}.attn.w_q", (d, H * hd), dt, ("normal", d ** -0.5)),
           (f"{p}.attn.w_k", (d, Hkv * hd), dt, ("normal", d ** -0.5)),
           (f"{p}.attn.w_v", (d, Hkv * hd), dt, ("normal", d ** -0.5)),
           (f"{p}.attn.w_o", (H * hd, d), dt, ("normal", (H * hd) ** -0.5))]
    if m.get("qk_norm"):
        out += [(f"{p}.attn.q_norm", (hd,), dt, ("const", 1.0)),
                (f"{p}.attn.k_norm", (hd,), dt, ("const", 1.0))]
    out += [(f"{p}.ln2", (d,), dt, ("const", 1.0)),
            (f"{p}.mlp.w_up", (d, ff), dt, ("normal", d ** -0.5)),
            (f"{p}.mlp.w_down", (ff, d), dt, ("normal", ff ** -0.5)),
            (f"{p}.mlp.w_gate", (d, ff), dt, ("normal", d ** -0.5))]
    return out


def leaves(m: dict, dt) -> list:
    """[(name, shape, dtype, (how, value))] of a model of `m` (a
    configuration file's ``model``) whose weights are of type `dt`."""
    d, V = m["d_model"], m["vocab_size"]
    out = [("tok_emb", (V, d), dt, ("normal", 0.02)),
           ("ln_f", (d,), dt, ("const", 1.0)),
           ("lm_head", (d, V), dt, ("normal", d ** -0.5))]
    for i in range(m["n_layers"]):
        out += _block(f"blocks.{i}", m, dt)
    return out
