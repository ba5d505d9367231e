"""Plain PyTorch models for the references, in float32 with TF32 off.

Written from the models' equations, independent of the port: no kernel,
no cache object, no batching across requests. The leaves are the
benchmark's, by the port's names (`perfbench.weights.leaf_specs`), and
arrive in the type they are served in; everything is computed in float32
from them. `Arith` carries the precision: ``"float32"``, or ``"fp8"``, the
control, which rounds both operands of every product with weights and of
attention's two products to float8 e4m3 (a scale per tensor, the
amax over 448), the gradient passing straight through the rounding.

The model (the dense family, qwen3): x = emb[t]; per layer x += W_o
attn(rope(qk-norm(W_q h)), rope(qk-norm(W_k h)), W_v h) with h = rms(x)
ln1, then x += W_down (silu(W_gate h) * W_up h) with h = rms(x) ln2;
logits = rms(x) ln_f W_head. GQA: q head j reads kv head j // (H / Hkv).
RoPE rotates the halves (x1, x2) of each head by pos * theta^(-i / (D/2)).
A family that another configuration brings adds its own layer code beside
this, in the new configuration's ``refs/<config>.py``.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["Arith", "gaps", "hidden", "logits", "no_tf32", "train"]

F8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


class Arith:
    """The precision of the products: "float32" or "fp8" (the control)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        s = t.detach().abs().amax().clamp(min=1e-30) / F8_MAX
        r = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
        return t + (r - t).detach()

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(w.float())


def rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D) at positions `pos` (T,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attend(q, k, v, q_pos, a: Arith) -> torch.Tensor:
    """Softmax attention of q (..., Tq, H, D) at positions `q_pos` over k,
    v (..., Tk, Hkv, D) at positions 0..Tk-1, each query seeing keys at or
    before its position: (..., Tq, H * D)."""
    Tq, H, D = q.shape[-3:]
    G = H // k.shape[-2]
    k = k.repeat_interleave(G, dim=-2)
    v = v.repeat_interleave(G, dim=-2)
    s = torch.einsum("...qhd,...khd->...hqk", a.q(q), a.q(k)) * D ** -0.5
    keys = torch.arange(k.shape[-3], device=q.device)
    s = s.masked_fill(keys[None, None, :] > q_pos[None, :, None],
                      float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("...hqk,...khd->...qhd", a.q(p), a.q(v))
    return o.reshape(*o.shape[:-2], H * D)


def _qkv(h, L, pre, m, a: Arith):
    lead, hd = h.shape[:-1], m["head_dim"]
    q = a.mm(h, L[pre + "w_q"]).view(*lead, -1, hd)
    k = a.mm(h, L[pre + "w_k"]).view(*lead, -1, hd)
    v = a.mm(h, L[pre + "w_v"]).view(*lead, -1, hd)
    if m.get("qk_norm"):
        q, k = rms(q, L[pre + "q_norm"]), rms(k, L[pre + "k_norm"])
    return q, k, v


def _dense_layer(x, L, i, m, a: Arith, pos):
    p = f"blocks.{i}."
    q, k, v = _qkv(rms(x, L[p + "ln1"]), L, p + "attn.", m, a)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    x = x + a.mm(attend(q, k, v, pos, a), L[p + "attn.w_o"])
    return x + _mlp(rms(x, L[p + "ln2"]), L, p, a)


def _mlp(h, L, p, a: Arith):
    g = F.silu(a.mm(h, L[p + "mlp.w_gate"]))
    return a.mm(g * a.mm(h, L[p + "mlp.w_up"]), L[p + "mlp.w_down"])


def hidden(L: dict, tokens: torch.Tensor, m: dict, a: Arith,
           remat: bool = False) -> torch.Tensor:
    """The residual stream after the last layer, (R, T, d), of R sequences
    of T tokens each (tokens (R, T)); with `remat` each layer is
    recomputed in the backward (memory only: the same values)."""
    run = ((lambda f, *xs: checkpoint(f, *xs, use_reentrant=False))
           if remat else (lambda f, *xs: f(*xs)))
    T = tokens.shape[-1]
    pos = torch.arange(T, device=tokens.device)
    x = L["tok_emb"][tokens.long()].float()
    if m["family"] != "dense":
        raise ValueError(m["family"])
    for i in range(m["n_layers"]):
        x = run(lambda x, i=i: _dense_layer(x, L, i, m, a, pos), x)
    return x


def logits(L: dict, x: torch.Tensor, a: Arith) -> torch.Tensor:
    return a.mm(rms(x, L["ln_f"]), L["lm_head"])


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per row, how far the logit of `tokens` lies below the row's best
    in `ref` (rows, V)."""
    best = ref.max(dim=-1).values
    return best - ref.gather(-1, tokens.long()[:, None])[:, 0]


# ---------------------------------------------------------------------------
# training: AdamW with global-norm clipping, as the configuration states it
# ---------------------------------------------------------------------------

def _lr(k: int, hp: dict) -> float:
    """The schedule's rate at update k (1-based): linear warmup, then a
    cosine to a tenth of the peak at `schedule_steps`."""
    peak, warm, total = hp["lr"], hp["warmup"], hp["schedule_steps"]
    if k < warm:
        return peak * k / max(warm, 1)
    t = min(max((k - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


def train(leaves: dict, batches: list, m: dict, hp: dict, a: Arith,
          rows=None, row_block: int = 1) -> dict:
    """Follow ``len(batches)`` training steps from `leaves` (the drawn
    parameters, which are left as they are): per step the mean next-token
    cross-entropy over the batch's `rows` (all by default), its gradient,
    the global norm's clip and the AdamW update, each parameter kept in
    its stored type after the update; `row_block` rows go through the
    model at a time. Returns the losses, each leaf's
    gradient norm at the first step as the optimizer takes it (clipped)
    and each leaf's change over all the steps."""
    dev = next(iter(leaves.values())).device
    P = {n: t.detach().float().clone().requires_grad_(True)
         for n, t in leaves.items()}
    mom = {n: torch.zeros_like(t) for n, t in P.items()}
    vel = {n: torch.zeros_like(t) for n, t in P.items()}
    losses, g1 = [], {}
    for k, batch in enumerate(batches, start=1):
        toks = torch.as_tensor(batch["tokens"], device=dev)
        tgts = torch.as_tensor(batch["targets"], device=dev)
        use = list(range(toks.shape[0]) if rows is None else rows)
        n_tok = len(use) * toks.shape[1]
        total = 0.0
        for lo in range(0, len(use), row_block):
            r = use[lo:lo + row_block]
            lg = logits(P, hidden(P, toks[r], m, a, remat=True), a)
            nll = torch.logsumexp(lg, -1) - lg.gather(
                -1, tgts[r].long()[..., None])[..., 0]
            loss = nll.sum() / n_tok
            loss.backward()
            total += float(loss.detach())
            del lg, nll, loss
        losses.append(total)
        with torch.no_grad():
            gsq = sum(torch.sum(p.grad * p.grad) for p in P.values())
            scale = min(1.0, hp["clip_norm"] / max(float(gsq) ** 0.5, 1e-9))
            lr = _lr(k, hp)
            c1, c2 = 1 - hp["b1"] ** k, 1 - hp["b2"] ** k
            for n, p in P.items():
                g = p.grad * scale
                if k == 1:
                    g1[n] = float(torch.linalg.vector_norm(g))
                mom[n].mul_(hp["b1"]).add_((1 - hp["b1"]) * g)
                vel[n].mul_(hp["b2"]).add_((1 - hp["b2"]) * g * g)
                step = (mom[n] / c1) / (torch.sqrt(vel[n] / c2) + hp["eps"]) \
                    + hp["weight_decay"] * p
                p.sub_(lr * step)
                p.copy_(p.to(leaves[n].dtype).float())
                p.grad = None
    with torch.no_grad():
        delta = {n: float(torch.linalg.vector_norm(P[n] - leaves[n].float()))
                 for n in P}
    return {"losses": losses, "g1": g1, "delta": delta}
