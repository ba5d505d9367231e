"""The ranks' side of the multi-rank CPU tests (`_torch_dist.run_world`):
each function runs on every rank of a gloo process group and returns
what its test compares, as numpy. This file imports no JAX."""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.convert import train_state_shard_from_numpy
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.parallel import (
    all_gather,
    all_to_all,
    compressed_pod_psum,
    gather_full,
    hierarchical_psum,
    local_shard,
    parallel_ctx,
    psum,
    psum_scatter,
)
from repro_torch.parallel.collectives import counts, reset_counts

CPU = torch.device("cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# collectives on a (pod 2, data 2) mesh
# ---------------------------------------------------------------------------

OPS = {"psum": lambda x, axes, dim: psum(x, axes),
       "psum_scatter": lambda x, axes, dim: psum_scatter(x, axes, dim),
       "all_gather": lambda x, axes, dim: all_gather(x, axes, dim),
       "all_to_all": lambda x, axes, dim: all_to_all(x, axes)}


def collectives(rank, world, payload):
    mesh = make_mesh((2, 2), ("pod", "data"), "cpu")
    out = {}
    with parallel_ctx(mesh):
        x = torch.from_numpy(payload["x"][rank])
        reset_counts()
        out["hierarchical"] = _np(hierarchical_psum(x, "pod", "data"))
        out["compressed"] = _np(compressed_pod_psum(x, "pod", "data"))
        out["counts"] = counts()
        for key, (op, axes, dim) in payload["grad_cases"].items():
            xg = torch.from_numpy(payload["xg"][rank]).requires_grad_(True)
            y = OPS[op](xg, axes, dim)
            w = torch.from_numpy(payload["w"][key][rank])
            (g,) = torch.autograd.grad((y * w).sum(), [xg])
            out[key] = (_np(y), _np(g))
    return out


def collectives_exact(rank, world, payload):
    """Each collective over a (data world, model 1) mesh on small integers
    (exact in float32): what each rank got, and what it should get."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else CPU
    mesh = make_local_mesh(world, 1, dev)
    W = world
    x = torch.arange(W * 6, dtype=torch.float32, device=dev).reshape(W * 2, 3) \
        + 100 * rank
    allx = [torch.arange(W * 6, dtype=torch.float32).reshape(W * 2, 3) + 100 * r
            for r in range(W)]
    total = sum(allx)
    want = {"psum": total,
            "psum_scatter": total[2 * rank:2 * rank + 2],
            "all_gather": torch.cat([a[:2] for a in allx], 0),
            "all_to_all": torch.cat([a[2 * rank:2 * rank + 2] for a in allx])}
    with parallel_ctx(mesh):
        got = {"psum": psum(x, "data"),
               "psum_scatter": psum_scatter(x, "data", 0),
               "all_gather": all_gather(x[:2], "data", 0),
               "all_to_all": all_to_all(x, "data")}
    return {k: (_np(got[k]), want[k].numpy()) for k in want}


# ---------------------------------------------------------------------------
# moe_sharded against the reference, and moe_ref at a world of one
# ---------------------------------------------------------------------------

def _moe_cfg(arch: str, cf: float):
    return dataclasses.replace(configs.get_reduced(arch), n_expert_slots=8,
                               capacity_factor=cf)


def _moe_params(tree: dict, cfg) -> tmoe.MoE:
    p = tmoe.MoE(cfg.d_model, cfg, torch.float32, CPU)
    with torch.no_grad():
        for name, w in p.named_parameters():
            node = tree
            for part in name.split("."):
                node = node[part]
            w.copy_(torch.from_numpy(np.asarray(node)))
    return p.requires_grad_(True)


# specs of the reference's `moe_sharded` (`specs_in`), per parameter
MOE_SPECS = {"w_router": ("model", None), "w_gate": ("data", "model", None),
             "w_up": ("data", "model", None), "w_down": ("data", "model", None)}


def moe_sharded(rank, world, payload):
    results = {}
    for key, case in payload.items():
        ep, tp = case["mesh"]
        mesh = make_mesh((ep, tp), ("data", "model"), "cpu")
        cfg = _moe_cfg(case["arch"], case["cf"])
        p = _moe_params(case["params"], cfg)
        with torch.no_grad():
            for name, w in p.named_parameters():
                if name in MOE_SPECS:
                    w.data = local_shard(w.data, MOE_SPECS[name], mesh)
        x_spec = ("data", None, "model")
        x = local_shard(torch.from_numpy(case["x"]), x_spec, mesh)
        x.requires_grad_(True)
        dy = local_shard(torch.from_numpy(case["dy"]), x_spec, mesh)
        reset_counts()
        y = tmoe.moe_sharded(x, p, cfg, mesh, ep_axes=("data",),
                             tp_axis="model")
        names = [n for n, _ in p.named_parameters()]
        grads = torch.autograd.grad((y * dy).sum(), [x, *p.parameters()])
        out = {"y": gather_full(y, x_spec, mesh),
               "x": gather_full(grads[0], x_spec, mesh)}
        with torch.no_grad():
            for name, g in zip(names, grads[1:]):
                spec = MOE_SPECS.get(name, ())
                # a block replicated over some axes holds only its own
                # tokens' (or d columns') part of the gradient: sum them
                for axes in ("data", "model"):
                    if not any(axes == e for e in spec):
                        g = psum(g, axes, mesh)
                out[name] = gather_full(g, spec, mesh)
        results[key] = {k: _np(v) for k, v in out.items()}
        results[key]["counts"] = counts()
        results[key]["drops"] = _drops(case, cfg, mesh)
    return results


def _drops(case, cfg, mesh) -> tuple:
    """(first-stage, second-stage) slots over capacity, summed over the ep
    groups, from the router's choices on each group's tokens (the second
    stage counted before the first's drops: 0 means none at all)."""
    G = mesh.shape["data"]
    x = torch.from_numpy(case["x"]).reshape(G, -1, cfg.d_model)
    w = torch.from_numpy(np.asarray(case["params"]["w_router"]))
    k, E_loc = cfg.experts_per_tok, cfg.expert_slots // G
    C = tmoe._capacity(x.shape[1] * k, G, cfg.capacity_factor)
    C2 = tmoe._capacity(G * C, E_loc, cfg.capacity_factor)
    first, per_expert = 0, torch.zeros(cfg.expert_slots, dtype=torch.long)
    for g in range(G):
        sel = tmoe.router_topk(x[g], w, k)[1].reshape(-1).long()
        first += int(torch.clamp(torch.bincount(sel // E_loc, minlength=G)
                                 - C, min=0).sum())
        per_expert += torch.bincount(sel, minlength=cfg.expert_slots)
    return first, int(torch.clamp(per_expert - C2, min=0).sum())


def moe_one_rank(rank, world, payload):
    """At a world of one: `moe_sharded` and `moe_ref` at the capacity
    factor that makes its capacity C2, forward and backward."""
    mesh = make_local_mesh(1, 1, "cpu")
    results = {}
    for key, case in payload.items():
        cfg = _moe_cfg(case["arch"], case["cf"])
        p = _moe_params(case["params"], cfg)
        x = torch.from_numpy(case["x"]).requires_grad_(True)
        dy = torch.from_numpy(case["dy"])
        N, k = x.shape[0] * x.shape[1], cfg.experts_per_tok
        C = tmoe._capacity(N * k, 1, cfg.capacity_factor)
        C2 = tmoe._capacity(C, cfg.expert_slots, cfg.capacity_factor)
        cf2 = (C2 - 0.5) * cfg.n_experts / (N * k)
        assert tmoe._capacity(N * k, cfg.n_experts, cf2) == C2
        ref_cfg = dataclasses.replace(cfg, capacity_factor=cf2)
        with parallel_ctx(mesh):
            ys = tmoe.moe_sharded(x, p, cfg, mesh, ep_axes=("data",))
            gs = torch.autograd.grad((ys * dy).sum(), [x, *p.parameters()])
        yr = tmoe.moe_ref(x, p, ref_cfg)
        gr = torch.autograd.grad((yr * dy).sum(), [x, *p.parameters()])
        results[key] = {"C2": C2, "y": (_np(ys), _np(yr)),
                        "grads": [(_np(a), _np(b)) for a, b in zip(gs, gr)]}
    return results


def moe_remat_backward(rank, world, payload):
    """`loss_fn` of a reduced MoE model under remat "block", its forward
    inside the parallel context (so through `moe_sharded`); the backward
    recomputes each layer. Its gradients taken inside the context, after
    it, and on another thread (where autograd runs a CUDA backward)."""
    import threading

    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train.data import make_batch

    mesh = make_local_mesh(1, 1, "cpu")
    cfg = dataclasses.replace(configs.get_reduced("qwen2-moe-a2.7b"),
                              remat="block")
    params = init_params(cfg, 0, "cpu").requires_grad_(True)
    batch = make_batch(cfg, ShapeSpec("t", 16, 2, "train"), 0, 0, "cpu")
    out = {}
    for where in ("inside", "after", "thread"):
        with parallel_ctx(mesh):
            loss = loss_fn(params, batch, cfg)
            if where == "inside":
                g = torch.autograd.grad(loss, list(params.parameters()))
        if where == "after":
            g = torch.autograd.grad(loss, list(params.parameters()))
        if where == "thread":
            box = {}

            def backward():
                box["g"] = torch.autograd.grad(loss, list(params.parameters()))

            t = threading.Thread(target=backward)
            t.start()
            t.join()
            g = box["g"]
        out[where] = [_np(x) for x in g]
    return out


def sharding_helpers(rank, world, payload):
    """`local_shard` and `gather_full` round trips by several specs, and
    `constrain` on a local block against its global shape."""
    from repro_torch.parallel import constrain

    mesh = make_local_mesh(world, 1, "cpu")
    full = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    out = {}
    for spec in [("data",), (None, "data"), (None, ("data", "model")),
                 ("model", "data", None), ()]:
        block = local_shard(full, spec, mesh)
        out[str(spec)] = (tuple(block.shape),
                          bool(torch.equal(gather_full(block, spec, mesh),
                                           full)))
    with parallel_ctx(mesh):
        block = local_shard(full, ("data",), mesh)
        out["constrain"] = constrain(block, "dp", None, "tp",
                                     shape=full.shape) is block
        try:
            constrain(full, "dp", None, "tp", shape=full.shape)
            out["constrain_refuses"] = False
        except ValueError:
            out["constrain_refuses"] = True
    return out


# ---------------------------------------------------------------------------
# the train step, checkpoints and the launcher
# ---------------------------------------------------------------------------

def _cfg(case):
    cfg = dataclasses.replace(configs.get_reduced(case["arch"]),
                              dtype="float32", **case.get("replace", {}))
    return cfg


def _step(state, cfg, batch, mesh, microbatches=1, lr=1e-3, eps=1e-8):
    from repro_torch.launch.specs import batch_pspecs
    from repro_torch.train import AdamW, make_train_step

    step = make_train_step(cfg, AdamW(lr=lr, eps=eps, zero1=True),
                           microbatches)
    with parallel_ctx(mesh) as ctx:
        specs = batch_pspecs(batch, ctx)
        local = {k: local_shard(v, specs[k], mesh) for k, v in batch.items()}
        return step(state, local)


def _full_params(state) -> dict:
    pl = state["placement"]
    return {n: _np(gather_full(p, pl.params[n], pl.mesh))
            for n, p in state["params"].named_parameters()}


def train_step(rank, world, payload):
    """One ZeRO-1 step of each case over a (data world, model 1) mesh; the
    loss, the gathered parameters after it, and the step's collectives."""
    mesh = make_local_mesh(world, 1, "cpu")
    out = {}
    for key, case in payload.items():
        cfg = _cfg(case)
        state = train_state_shard_from_numpy(case["state"], cfg, mesh, "cpu")
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        reset_counts()
        state, met = _step(state, cfg, batch, mesh,
                           case.get("microbatches", 1))
        out[key] = {"loss": float(met["loss"]),
                    "grad_norm": float(met["grad_norm"]),
                    "params": _full_params(state), "counts": counts()}
    return out


def checkpoint_write(rank, world, payload):
    """Step 0, a checkpoint of step 1, step 1 (the uninterrupted run);
    then a fresh state restored from the checkpoint takes step 1 again."""
    from repro_torch.train.checkpoint import restore, save

    mesh = make_local_mesh(world, 1, "cpu")
    cfg = _cfg(payload)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in payload["batches"]]
    state = train_state_shard_from_numpy(payload["state"], cfg, mesh, "cpu")
    state, _ = _step(state, cfg, batches[0], mesh)
    with parallel_ctx(mesh):
        save(payload["dir"], 1, state)
    dist.barrier()
    _, met = _step(state, cfg, batches[1], mesh)
    fresh = train_state_shard_from_numpy(payload["state"], cfg, mesh, "cpu")
    restore(payload["dir"], 1, fresh)
    _, again = _step(fresh, cfg, batches[1], mesh)
    return {"loss": float(met["loss"]), "restored": float(again["loss"])}


def checkpoint_restore(rank, world, payload):
    """A state restored from another world's checkpoint takes step 1."""
    from repro_torch.train.checkpoint import restore

    mesh = make_local_mesh(world, 1, "cpu")
    cfg = _cfg(payload)
    batch = {k: torch.from_numpy(v) for k, v in payload["batches"][1].items()}
    state = train_state_shard_from_numpy(payload["state"], cfg, mesh, "cpu")
    restore(payload["dir"], 1, state)
    _, met = _step(state, cfg, batch, mesh)
    return {"loss": float(met["loss"])}


def launcher(rank, world, payload):
    """`launch.train.main` on the CPU over the group: 4 steps; then in
    another directory the same command with ``--steps 2`` (which
    checkpoints at step 2 by ``--ckpt-every``) and the command again with
    ``--steps 4``, resuming there; then the same over the model axis
    (``--data 1 --model 2``): 4 steps, and 2 steps resumed to 4."""
    from repro_torch.launch import train as launch_train

    d = pathlib.Path(payload["dir"])
    argv = [*payload["argv"], "--device", "cpu"]
    full = {}
    losses = launch_train.main([*argv, "--steps", "4",
                                "--ckpt-dir", str(d / "full")], report=full)
    sliced = launch_train.main([*argv, "--steps", "2",
                                "--ckpt-dir", str(d / "sliced")])
    resumed = {}
    launch_train.main([*argv, "--steps", "4", "--ckpt-dir", str(d / "sliced")],
                      report=resumed)
    tp = [*argv, "--data", "1", "--model", "2"]
    tp_full = {}
    tp_losses = launch_train.main([*tp, "--steps", "4", "--ckpt-dir",
                                   str(d / "tp_full")], report=tp_full)
    tp_sliced = launch_train.main([*tp, "--steps", "2", "--ckpt-dir",
                                   str(d / "tp_sliced")])
    tp_resumed = {}
    launch_train.main([*tp, "--steps", "4", "--ckpt-dir", str(d / "tp_sliced")],
                      report=tp_resumed)
    return {"losses": losses, "sliced": sliced, "resumed": resumed["losses"],
            "start": resumed["start"], "collectives": full["collectives"],
            "mesh": full["mesh"].shape,
            "model": {"losses": tp_losses, "sliced": tp_sliced,
                      "resumed": tp_resumed["losses"],
                      "start": tp_resumed["start"],
                      "mesh": tp_full["mesh"].shape,
                      "collectives": tp_full["collectives"]}}


# ---------------------------------------------------------------------------
# tensor parallelism over the model axis
# ---------------------------------------------------------------------------

def _named(t: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in t.items()}


def tp_conjugates(rank, world, payload):
    """On (data 1, model world): the gradients of small consumers through
    each sum (the ranks' blocks `u`, a replicated `z`, per-rank weights
    `a`), and `Segments` blocks round trips."""
    from repro_torch.parallel.collectives import (
        pmax,
        psum_replicated,
        replicated_copy,
    )
    from repro_torch.parallel.sharding import Segments

    mesh = make_local_mesh(1, world, "cpu")
    c = torch.from_numpy(payload["c"])
    out = {}
    with parallel_ctx(mesh):
        # a sum every rank consumes whole: L = sum(c * s^2), s = sum_r u_r
        for key, op in (("psum_replicated", psum_replicated), ("psum", psum)):
            u = torch.from_numpy(payload["u"][rank]).requires_grad_(True)
            loss = (c * op(u, "model") ** 2).sum()
            out[key] = _np(torch.autograd.grad(loss, u)[0])
        # a replicated z entering work each rank does a part of:
        # L = sum_r sum((a_r * z)^2), summed whole on every rank
        a = torch.from_numpy(payload["a"][rank])
        for key, enter in (("replicated_copy",
                            lambda z: replicated_copy(z, "model")),
                           ("no_copy", lambda z: z)):
            z = torch.from_numpy(payload["z"]).requires_grad_(True)
            part = ((a * enter(z)) ** 2).sum()
            loss = psum_replicated(part, "model")
            out[key] = _np(torch.autograd.grad(loss, z)[0])
        # a vocab-parallel logsumexp: the shift by pmax, the sum of
        # exponentials through psum_replicated
        x = torch.from_numpy(payload["x"][rank]).requires_grad_(True)
        m = pmax(torch.amax(x.detach(), -1), "model")
        se = psum_replicated(torch.exp(x - m[..., None]).sum(-1), "model")
        lse = torch.log(se) + m
        out["pmax"] = (_np(m), m.requires_grad)
        w = torch.from_numpy(payload["w"])
        out["lse"] = (_np(lse), _np(torch.autograd.grad((w * lse).sum(),
                                                        x)[0]))
        full = torch.arange(2 * 22, dtype=torch.float32).reshape(2, 22)
        seg = Segments((4, 4, 2, 2, 10), (True, True, False, False, True), "model")
        block = local_shard(full, (None, seg), mesh)
        out["segments"] = (tuple(block.shape), _np(block),
                           bool(torch.equal(gather_full(block, (None, seg),
                                                        mesh), full)))
    return out


def tp_counts(rank, world, payload):
    """One step of the reduced qwen3-8b on (1, world) under each residual
    layout: the step's collectives and their closed form."""
    from repro_torch.launch.specs import train_collectives
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import AdamW, init_state
    from repro_torch.train.data import make_batch

    mesh = make_local_mesh(1, world, "cpu")
    shape = ShapeSpec("t", payload["seq"], payload["batch"], "train")
    out = {}
    for residual in ("tp", "replicated"):
        for mb in (1, 2):
            cfg = dataclasses.replace(configs.get_reduced("qwen3-8b"),
                                      dtype="float32", residual=residual)
            with parallel_ctx(mesh):
                state = init_state(cfg, 0, AdamW(lr=1e-3), "cpu", mesh)
            batch = make_batch(cfg, shape, 0, 0, "cpu")
            reset_counts()
            _step(state, cfg, batch, mesh, mb)
            out[(residual, mb)] = (counts(), train_collectives(
                cfg, shape, 1, world, mb))
    return out


def tp_train_step(rank, world, payload):
    """One step of each case on its own (data, model) mesh: the loss, the
    global gradient norm, the gathered parameters and the collectives;
    with ``"one_device"`` also the port's one-device step from the same
    state in this process."""
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.train import AdamW, make_train_step

    out = {}
    for key, case in payload.items():
        cfg = _cfg(case)
        mesh = make_local_mesh(*case["mesh"], "cpu")
        state = train_state_shard_from_numpy(case["state"], cfg, mesh, "cpu")
        batch = _named(case["batch"])
        eps = case.get("eps", 1e-8)
        reset_counts()
        state, met = _step(state, cfg, batch, mesh, eps=eps)
        res = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
               "params": _full_params(state), "counts": counts()}
        if case.get("one_device"):
            st = train_state_from_numpy(case["state"], cfg, "cpu")
            st, m1 = make_train_step(cfg, AdamW(lr=1e-3, eps=eps, zero1=True),
                                     1)(st, batch)
            res["one_device"] = {
                "loss": float(m1["loss"]), "grad_norm": float(m1["grad_norm"]),
                "params": {n: _np(p) for n, p in
                           st["params"].named_parameters()}}
        out[key] = res
    return out


def _tp_ckpt_setup(payload, mesh):
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import AdamW, init_state
    from repro_torch.train.data import make_batch

    cfg = dataclasses.replace(configs.get_reduced(payload["arch"]),
                              dtype="float32")
    shape = ShapeSpec("t", 16, 4, "train")
    batches = [make_batch(cfg, shape, i, 0, "cpu") for i in range(2)]
    with parallel_ctx(mesh):
        state = init_state(cfg, 0, AdamW(lr=1e-3), "cpu", mesh)
    return cfg, batches, state


def tp_checkpoint(rank, world, payload):
    """On the first mesh: step 0, a checkpoint of step 1, step 1 (the
    uninterrupted run), then a fresh state restored from the checkpoint
    takes step 1 again; on each further mesh a fresh state restored from
    that checkpoint takes step 1. ``"write"`` False: only restore (the
    checkpoint another world wrote)."""
    from repro_torch.train.checkpoint import restore, save

    out = {}
    meshes = payload["meshes"]
    if payload["write"]:
        mesh = make_local_mesh(*meshes[0], "cpu")
        cfg, batches, state = _tp_ckpt_setup(payload, mesh)
        state, _ = _step(state, cfg, batches[0], mesh)
        save(payload["dir"], 1, state)
        dist.barrier()
        _, met = _step(state, cfg, batches[1], mesh)
        out["loss"] = float(met["loss"])
    for shape in meshes:
        mesh = make_local_mesh(*shape, "cpu")
        cfg, batches, state = _tp_ckpt_setup(payload, mesh)
        restore(payload["dir"], 1, state)
        _, met = _step(state, cfg, batches[1], mesh)
        out[tuple(shape)] = float(met["loss"])
    return out


def _serve_cfg(case):
    return dataclasses.replace(configs.get_reduced(case["arch"]),
                               dtype="float32", **case.get("replace", {}))


def _serve_one_device(params, cfg, batch, toks, max_len):
    """The port's one-device serving of `batch` (this rank's sequences):
    prefill logits, each forced decode step's logits, the cache after."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.serve import make_prefill

    prefill = _np(make_prefill(cfg, "cpu")(params, batch))
    cache = init_cache(cfg, toks.shape[0], max_len, "cpu")
    steps = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            steps.append(_np(decode_step(params, cache, toks[:, t], cfg)[0]))
    return {"prefill": prefill, "decode": np.stack(steps),
            "cache": {k: _np(v) for k, v in cache.items()}}


def tp_serve(rank, world, payload):
    """Each case served on its own (data, model) mesh from the reference's
    parameters cut by `tp_pspecs`: the prefill logits and each forced
    decode step's logits (gathered over data: the whole batch's), the
    cache after the last step gathered whole by `tp_cache_pspecs`, this
    rank's own blocks of all three, the collectives of the prefill and of
    one decode step; with ``"one_device"`` also the port's one-device
    serving of this rank's sequences in this process."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.specs import batch_pspecs
    from repro_torch.models import decode_step, init_cache
    from repro_torch.parallel import shard_module
    from repro_torch.parallel.sharding import tp_cache_pspecs, tp_pspecs
    from repro_torch.serve import make_prefill

    out = {}
    for key, case in payload.items():
        cfg = _serve_cfg(case)
        mesh = make_local_mesh(*case["mesh"], "cpu")
        max_len = case["max_len"]
        full = lm_params_from_numpy(case["params"], cfg, CPU)
        with parallel_ctx(mesh) as ctx:
            shapes = {n: tuple(t.shape) for n, t in full.named_parameters()}
            params = lm_params_from_numpy(case["params"], cfg, CPU)
            shard_module(params, tp_pspecs(shapes, cfg, ctx)[0], mesh)
            batch = _named(case["batch"])
            b_specs = batch_pspecs(batch, ctx)
            batch = {k: local_shard(v, b_specs[k], mesh)
                     for k, v in batch.items()}
            toks = torch.from_numpy(case["tokens"])
            tok_spec = batch_pspecs(toks, ctx)
            toks = local_shard(toks, tok_spec, mesh)
            cache = init_cache(cfg, case["tokens"].shape[0], max_len, "cpu")
            c_specs = tp_cache_pspecs(cache, cfg, ctx)
            cache = {k: local_shard(v, c_specs[k], mesh)
                     for k, v in cache.items()}
            dp = (tok_spec[0],)
            reset_counts()
            logits = make_prefill(cfg, "cpu")(params, batch)
            res = {"prefill_counts": counts(),
                   "prefill": _np(gather_full(logits, dp, mesh)),
                   "local": {"prefill": _np(logits)}}
            steps, local = [], []
            with torch.no_grad():
                for t in range(toks.shape[1]):
                    reset_counts()
                    lg = decode_step(params, cache, toks[:, t], cfg, max_len)[0]
                    if t == 0:
                        res["decode_counts"] = counts()
                    local.append(_np(lg))
                    steps.append(_np(gather_full(lg, dp, mesh)))
            res["decode"] = np.stack(steps)
            res["local"]["decode"] = np.stack(local)
            res["local"]["cache"] = {k: _np(v) for k, v in cache.items()}
            res["cache"] = {k: _np(gather_full(v, c_specs[k], mesh))
                            for k, v in cache.items()}
            res["cuts"] = {k: tuple(str(e) if e is not None else None
                                    for e in v) for k, v in c_specs.items()}
        if case.get("one_device"):
            res["one_device"] = _serve_one_device(full, cfg, batch, toks,
                                                  max_len)
        out[key] = res
    return out


def b7_merge(rank, world, payload):
    """`layers.decode_attention_merged` on (1, world): each rank's block
    of the cache cut by sequence, the merged output every rank returns."""
    from repro_torch.models.layers import TP, decode_attention_merged

    mesh = make_local_mesh(1, world, "cpu")
    k, v = (torch.from_numpy(payload[n]) for n in ("k", "v"))
    n = k.shape[1] // world
    tp = TP(mesh, "model", world, rank, "tp")
    out = {}
    for key, lens in payload["lengths"].items():
        out[key] = _np(decode_attention_merged(
            torch.from_numpy(payload["q"]), k[:, rank * n:(rank + 1) * n],
            v[:, rank * n:(rank + 1) * n], torch.from_numpy(lens), tp))
    return out
