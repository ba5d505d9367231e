"""Training: the port's step (`repro_torch.train.make_train_step` over its
model and AdamW, in the one-device parallel context `launch.train` runs
it in), on batches from ``traffic/train.py``.

Set-up builds the training state from the seed's weights and drives it
through ``warmup_steps`` steps of the window's own call and feed, on
batches of their own (the kernels' build and load, cuBLAS's plans, the
allocator's pools); then it frees that state and builds it again from
the seed's weights and fresh AdamW moments. The window runs the steps of
that fresh state, each ending in a host read of its loss, as
`launch.train` does; its first ``checked_steps`` steps are the checked
ones: their losses, each leaf's gradient as the optimizer took it at the
first (its first moment over 1 - b1, from zero moments) and each leaf's
change over them (against the seed's draw again), read on the device
between steps. The check frees the state, then the reference follows
the same steps from the same draw (`refs/<config>.py:train`)."""
from __future__ import annotations

import contextlib
import gc
import statistics
import time
from types import SimpleNamespace

import torch

from perfbench import harness, weights

__all__ = ["check", "compare", "setup", "traced", "window"]


def _hp(t: dict) -> dict:
    keys = ("lr", "warmup", "schedule_steps", "b1", "b2", "eps",
            "weight_decay", "clip_norm")
    return {k: t[k] for k in keys}


def _batch(cell, step) -> dict:
    return cell.gen.batch(cell.seed, step, cell.traffic, cell.model["vocab_size"])


def _norms(ts) -> list[float]:
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in ts]
                       ).tolist()


def _state(cell, st) -> None:
    """The training state of the seed's weights and zero moments."""
    params = weights.program_model(cell.cfg, weights.draw(
        cell.model, cell.seed, cell.device))
    params.requires_grad_(True)
    st.state = {"params": params, "opt": st.opt.init(params)}


def setup(cell):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import parallel_ctx
    from repro_torch.train import AdamW, cosine_schedule, make_train_step

    t, dev = cell.traffic, cell.device
    st = SimpleNamespace(stack=contextlib.ExitStack())
    st.stack.enter_context(parallel_ctx(make_local_mesh(1, 1, dev)))
    hp = _hp(t)
    st.opt = AdamW(lr=cosine_schedule(hp["lr"], hp["warmup"],
                                      hp["schedule_steps"]),
                   b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                   weight_decay=hp["weight_decay"], clip_norm=hp["clip_norm"])
    _state(cell, st)
    st.step = make_train_step(cell.cfg, st.opt, t["microbatches"])
    st.names = [n for n, _ in st.state["params"].named_parameters()]
    for i in range(t["warmup_steps"]):
        _one(cell, st, _batch(cell, f"warmup-{i}"))
    st.state = None
    gc.collect()
    _state(cell, st)
    st.losses, st.next = [], 0
    return st


def _one(cell, st, batch: dict) -> float:
    batch = {k: torch.from_numpy(v).to(cell.device) for k, v in batch.items()}
    st.state, metrics = st.step(st.state, batch)
    return float(metrics["loss"])


def _timed(cell, st) -> float:
    """The window's next step; after each of its checked steps, what the
    check compares."""
    loss = _one(cell, st, _batch(cell, st.next))
    st.next += 1
    if st.next <= cell.traffic["checked_steps"]:
        st.losses.append(loss)
        if st.next == 1:
            m = st.state["opt"]["m"]
            st.g1 = [x / (1 - cell.traffic["b1"])
                     for x in _norms(m[n] for n in st.names)]
        if st.next == cell.traffic["checked_steps"]:
            with torch.no_grad():
                p0 = weights.draw(cell.model, cell.seed, cell.device)
                now = dict(st.state["params"].named_parameters())
                st.delta = _norms(now[n].float() - p0[n].float()
                                  for n in st.names)
                del p0, now
    return loss


def window(cell, st) -> dict:
    t = cell.traffic
    losses = []
    t0 = time.perf_counter()
    while True:
        losses.append(_timed(cell, st))
        elapsed = time.perf_counter() - t0
        # a window too short for the checked steps runs on to them
        if elapsed >= cell.seconds and st.next >= t["checked_steps"]:
            break
    n = len(losses)
    tokens = n * t["batch"] * t["seq"]
    failed = sum(1 for x in losses if not torch.isfinite(torch.tensor(x)))
    return {"metrics": {"train_tokens_per_s": tokens / elapsed},
            "attempted": n, "failed": failed, "steps": n,
            "seconds": elapsed, "step_s": elapsed / n}


def traced(cell, st):
    """One more step, its device activity profiled."""
    tr = harness.profile_window(lambda: _timed(cell, st), host_ops=False)
    t = cell.traffic
    return tr, {"steps": 1, "rows": t["batch"] // t["microbatches"],
                "microbatches": t["microbatches"]}


def _release(st) -> None:
    st.stack.close()
    st.state = st.step = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def compare(prog: dict, ref: dict, names: list) -> dict:
    """The numbers compared: the relative gap of the first step's loss
    (the later steps' gaps are listed beside it); and, by the worst leaf,
    the gap between the program's and the reference's norm of the first
    gradient and of the change, over the larger of the reference's norm
    of that leaf and of the median leaf. Leaves whose reference gradient
    is under a thousandth of the median leaf's are left out of both (they
    move by round-off alone)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"])]
    g_ref = [ref["g1"][n] for n in names]
    med_g = statistics.median(g_ref)
    keep = [i for i, g in enumerate(g_ref) if g >= 1e-3 * med_g]
    d_ref = [ref["delta"][n] for n in names]
    med_d = statistics.median(d_ref[i] for i in keep)

    def gaps(p, r, med):
        return {names[i]: abs(p[i] - r[i]) / max(r[i], med) for i in keep}

    g, d = gaps(prog["g1"], g_ref, med_g), gaps(prog["delta"], d_ref, med_d)
    return {"loss_gap": losses[0],
            "grad_norm_gap": max(g.values()),
            "change_norm_gap": max(d.values()),
            "later_loss_gaps": losses[1:],
            "worst_grad_leaf": max(g, key=g.get),
            "worst_change_leaf": max(d, key=d.get),
            "median_change_gap": statistics.median(d.values()),
            "leaves_left_out": len(names) - len(keep)}


def reference(cell, precision: str = "float32", rows=None) -> dict:
    """The reference's readings of the checked steps, from the seed's
    draw; `rows` None takes every row of each batch."""
    from perfbench.refs.common import no_tf32

    leaves = weights.draw(cell.model, cell.seed, cell.device)
    batches = [_batch(cell, i) for i in range(cell.traffic["checked_steps"])]
    with no_tf32():
        out = cell.ref.train(leaves, batches, cell.model, _hp(cell.traffic),
                             cell.ref.Arith(precision), rows)
    del leaves
    return out


def readings(cell, st, controls: bool = False) -> dict:
    """The numbers compared (`compare`) of the program's checked steps;
    with `controls` also of the control, the reference computed in fp8
    (the precision below the configuration's bf16), and of the reference
    with half of each batch left out (the mean over the rest)."""
    prog = {"losses": st.losses, "g1": st.g1, "delta": st.delta}
    names = st.names
    _release(st)
    ref = reference(cell)
    out = {"program": compare(prog, ref, names)}
    if controls:
        def as_lists(r):
            return {"losses": r["losses"], "g1": [r["g1"][n] for n in names],
                    "delta": [r["delta"][n] for n in names]}

        out["control"] = compare(as_lists(reference(cell, "fp8")), ref, names)
        half = range(cell.traffic["batch"] // 2)
        out["half_batch"] = compare(as_lists(reference(cell, rows=half)), ref,
                                    names)
    return out


def check(cell, st, win) -> list[dict]:
    """The numbers the cell's limits name. The first step's loss gap is
    read but not compared: neither the control nor a fault reads ten
    times it (PERF.md)."""
    got = readings(cell, st)["program"]
    return [{"name": k, "value": got[k], "limit": v}
            for k, v in cell.spec["limits"].items()]
