"""Prefill: the port's `serve.serve_step.make_prefill` on batches of
concurrent prompts, in a closed loop, from ``traffic/prefill_stream.py``.

Set-up binds the seed's weights and runs a batch of every prompt length
of the mix once (the warm-up). In the window the requests of a batch are
due when the batch before it has its first tokens (``batch`` clients that
send their next prompts together); each request's time to first token
runs from then until the batch's first tokens' ids (the greedy picks at
the last position) are on the host. The host draws the next batch's
prompts while the card serves the current one. The window serves whole
blocks of the mix (every length once): it ends with the block under way
once its seconds are over. The requests that the check reads are drawn
from the seed among the first block, with a longest prompt among them;
for those the window also keeps the greedy pick at every position. The
check runs the plain reference over each of their prompts alone and
compares each pick with the reference's logits (`logit_gap`)."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import harness, weights

__all__ = ["check", "readings", "setup", "traced", "window"]


def setup(cell):
    from repro_torch.serve.serve_step import make_prefill

    t, dev = cell.traffic, cell.device
    st = SimpleNamespace()
    st.leaves = weights.draw(cell.model, cell.seed, dev)
    st.params = weights.program_model(cell.cfg, st.leaves)
    st.prefill = make_prefill(cell.cfg, dev)
    st.block = len(cell.gen.lengths(t))
    for n in cell.gen.lengths(t):
        st.prefill(st.params, {"tokens": torch.zeros((t["batch"], n),
                                                     dtype=torch.int32)})
    first = st.block * t["batch"]
    sizes = [cell.gen.batch_length(cell.seed, i // t["batch"], t)
             for i in range(first)]
    rng = np.random.default_rng(harness.subseed(cell.seed, "prefill", "check"))
    longest = int(np.argmax(sizes))
    others = [i for i in range(first) if i != longest]
    st.checked = sorted({longest, *rng.choice(others, t["checked"] - 1,
                                               replace=False).tolist()})
    st.served, st.next = {}, 0
    st.tokens = _tokens(cell, 0)
    return st


def _tokens(cell, j: int) -> torch.Tensor:
    return torch.from_numpy(cell.gen.batch(cell.seed, j, cell.traffic,
                                           cell.model["vocab_size"]))


def _one(cell, st) -> tuple[int, float]:
    """Serve the next batch: (its prompts' length, its requests' time to
    first token in seconds)."""
    j, B = st.next, cell.traffic["batch"]
    tok = st.tokens
    t_due = time.perf_counter()
    logits = st.prefill(st.params, {"tokens": tok})
    st.tokens = _tokens(cell, j + 1)
    first = logits[:, -1].argmax(-1).tolist()
    ttft = time.perf_counter() - t_due
    for r in range(B):
        if j * B + r in st.checked:
            st.served[j * B + r] = (logits[r].argmax(-1), first[r])
    st.next += 1
    return tok.shape[1], ttft


def window(cell, st) -> dict:
    lengths, ttfts = [], []
    B = cell.traffic["batch"]
    t0 = time.perf_counter()
    # whole blocks; the checked requests lie in the first
    while time.perf_counter() - t0 < cell.seconds or st.next % st.block or \
            not st.served.keys() >= set(st.checked):
        n, ttft = _one(cell, st)
        lengths += [n] * B
        ttfts += [ttft] * B
    elapsed = time.perf_counter() - t0
    return {"metrics": {"prefill_tokens_per_s": sum(lengths) / elapsed,
                        "ttft_ms_p95": 1e3 * harness.p95(ttfts)},
            "attempted": len(lengths), "failed": 0, "lengths": lengths,
            "seconds": elapsed}


def traced(cell, st):
    """The next few batches, profiled with the host's operations."""
    t = cell.traffic
    start, n = st.next, t.get("traced", 2)
    tr = harness.profile_window(
        lambda: [_one(cell, st) for _ in range(n)], host_ops=True)
    return tr, {"lengths": [cell.gen.batch_length(cell.seed, j, t)
                            for j in range(start, start + n)
                            for _ in range(t["batch"])]}


def reference_logits(cell, st, i: int, precision: str = "float32"):
    from perfbench.refs.common import no_tf32

    ref = cell.ref
    tok = torch.from_numpy(cell.gen.request(cell.seed, i, cell.traffic,
                                            cell.model["vocab_size"]))
    a = ref.Arith(precision)
    with torch.no_grad(), no_tf32():
        return ref.logits(st.leaves, ref.hidden(
            st.leaves, tok.to(cell.device)[None], cell.model, a), a)[0]


def readings(cell, st, controls: bool = False) -> dict:
    """The widest gap between a pick of the program and the reference's
    best logit over the checked requests; with `controls` also that of
    the control's picks, the reference computed in fp8."""
    st.params = st.prefill = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    prog = ctrl = 0.0
    for i in st.checked:
        if i not in st.served:
            return {"program": {"logit_gap": float("inf")}}
        picks, first = st.served[i]
        want = reference_logits(cell, st, i)
        gap = float(cell.ref.gaps(want, picks).max())
        prog = max(prog, gap if first == int(picks[-1]) else float("inf"))
        if controls:
            low = reference_logits(cell, st, i, "fp8").argmax(-1)
            ctrl = max(ctrl, float(cell.ref.gaps(want, low).max()))
        del want
    out = {"program": {"logit_gap": prog}}
    if controls:
        out["control"] = {"logit_gap": ctrl}
    return out


def check(cell, st, win) -> list[dict]:
    return [{"name": "logit_gap",
             "value": readings(cell, st)["program"]["logit_gap"],
             "limit": cell.spec["limits"]["logit_gap"]}]
