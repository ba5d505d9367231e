"""Training launcher: end-to-end driver with fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-8b --data 1 --model 4 --batch 4 --seq 4096 \
        --microbatches 2

Port of `repro.launch.train`, with ``--device`` (default ``cuda``; the
CPU runs the kernels' plain versions, and nothing falls back to it):
data pipeline -> train step -> metrics -> async checkpoints; resumes from
the latest checkpoint on restart (crash or preemption), restoring the
state onto this run's device whatever device wrote it. On SIGTERM it
checkpoints the step it finished and stops.

Under torchrun, or in a process whose caller has started a process group
(`repro_torch.launch.mesh.init_distributed`), it trains over a (data,
model) mesh of the whole group: ``--data 0`` means world // model, as the
reference's. Every rank draws the same global parameters from the seed
and keeps its blocks by the port's tensor-parallel layout
(`parallel.sharding.tp_pspecs`: heads, columns and vocabulary rows over
the model axis, the expert weights over ep, the AdamW moments by
ZeRO-1), takes its block of each global batch (`launch.specs.
batch_pspecs`), and steps through the model's tensor-parallel
collectives, the gradient reduction and ZeRO-1 (`repro_torch.train`) at
any world size, one rank included. A checkpoint is gathered and written
whole by rank 0, and restores onto any mesh. On the card every rank is a
process on its own card over NCCL (``torchrun --nproc-per-node W``, or
`chip_smoke.py --multicard-only` on four cards); ``--device cpu`` runs
the same path over gloo. Without a process group it trains on one
device, as before (``--data`` and ``--model`` 1).

Straggler mitigation: per-step wall times (each step ends in a host read
of its loss, so the card has finished it) feed an EWMA; steps slower than
`--straggler-factor` x EWMA are counted and logged.
"""
from __future__ import annotations

import argparse
import os
import signal
import time

import torch
import torch.distributed as dist

from .. import configs
from ..device import resolve_device
from ..models.config import ShapeSpec
from ..parallel import parallel_ctx, psum
from ..parallel.collectives import counts, reset_counts
from ..parallel.sharding import local_shard
from ..train import AdamW, cosine_schedule, init_state, make_train_step
from ..train.checkpoint import Checkpointer, latest_step, restore
from ..train.data import SyntheticTokens
from .mesh import init_distributed, make_local_mesh
from .specs import batch_pspecs

__all__ = ["main"]


def main(argv=None, report: dict | None = None):
    """Train and return the losses of the steps run. With `report` (a
    dict), also fill in what a caller measuring the run needs: per step
    its seconds, grad norm, lr and collectives (`parallel.collectives.
    counts` of the step), the step resumed from, the straggler count, the
    final state and the mesh."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=0,
                    help="data-mesh size (0: world size // model)")
    ap.add_argument("--model", type=int, default=1, help="model-mesh size")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")

    # a group this call starts (under torchrun) it also ends; a caller's
    # group is the caller's
    owned = not dist.is_initialized() and "WORLD_SIZE" in os.environ
    if owned:
        device = init_distributed(args.device)
    else:
        device = resolve_device(args.device)
        if dist.is_initialized() and device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        world = dist.get_world_size()
        mesh = make_local_mesh(args.data or max(1, world // args.model),
                               args.model, device)
    else:
        mesh = make_local_mesh(args.data or 1, args.model, device)
    lead = mesh.axis_index(mesh.axis_names) == 0 if mesh.distributed else True

    def say(msg):
        if lead:
            print(msg)

    say(f"[train] {cfg.name} device={device} mesh={mesh.shape} "
        f"process_group={mesh.distributed}")

    opt = AdamW(lr=cosine_schedule(args.lr, 10, args.steps), zero1=True)
    step_fn = make_train_step(cfg, opt, args.microbatches)
    try:
        with parallel_ctx(mesh) as pctx:
            return _run(args, cfg, shape, mesh, device, opt, step_fn, pctx,
                        say, report)
    finally:
        if owned:
            dist.destroy_process_group()


def _run(args, cfg, shape, mesh, device, opt, step_fn, pctx, say, report):
    state = init_state(cfg, args.seed, opt, device,
                       mesh if mesh.distributed else None)

    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            say(f"[train] resuming from step {last} onto {device} "
                f"(mesh {mesh.shape})")
            restore(args.ckpt_dir, last, state)
            start = last

    def local(batch):
        if not mesh.distributed:
            return batch
        specs = batch_pspecs(batch, pctx)
        return {k: local_shard(v, specs[k], mesh) for k, v in batch.items()}

    def stopping(flag: bool) -> bool:
        if not mesh.distributed:
            return flag
        # every rank stops together, if any of them was told to
        f = torch.tensor(float(flag), device=device)
        return bool(psum(f, mesh.axis_names, mesh) > 0)

    stop = {"flag": False}
    prev_handler = signal.signal(signal.SIGTERM,
                                 lambda *_: stop.update(flag=True))
    try:
        data = iter(SyntheticTokens(cfg, shape, args.seed, device,
                                    start_step=start))
        ewma, stragglers = None, 0
        losses, seconds, gnorms, lrs, colls = [], [], [], [], []
        for i in range(start, args.steps):
            batch = local(next(data))
            reset_counts()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            colls.append(counts())
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > args.straggler_factor * ewma:
                stragglers += 1
                say(f"[train] straggler step {i}: {dt:.2f}s vs ewma "
                    f"{ewma:.2f}s")
            losses.append(loss)
            seconds.append(dt)
            gnorms.append(float(metrics["grad_norm"]))
            lrs.append(float(metrics["lr"]))
            if i % 10 == 0 or i == args.steps - 1:
                say(f"[train] step {i:5d} loss={loss:.4f} "
                    f"gnorm={gnorms[-1]:.3f} {dt*1e3:.0f}ms")
            saved = ckpt and (i + 1) % args.ckpt_every == 0
            if saved:
                ckpt.save_async(i + 1, state)
            if stopping(stop["flag"]):
                say("[train] SIGTERM — checkpointing and exiting")
                if ckpt and not saved:
                    ckpt.save_async(i + 1, state)
                break
        if ckpt:
            ckpt.wait()
        if mesh.distributed:
            # rank 0 writes the checkpoints: no rank leaves (to restart
            # from LATEST, say) before the last one is on disk
            psum(torch.zeros((), device=device), mesh.axis_names, mesh)
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
    if losses:
        say(f"[train] done. first loss={losses[0]:.4f} "
            f"last={losses[-1]:.4f} stragglers={stragglers}")
    if report is not None:
        report.update(start=start, losses=losses, step_seconds=seconds,
                      grad_norms=gnorms, lrs=lrs, stragglers=stragglers,
                      collectives=colls, state=state, mesh=mesh)
    return losses


if __name__ == "__main__":
    main()
