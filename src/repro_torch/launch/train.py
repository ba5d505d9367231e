"""Training launcher: end-to-end driver with fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Port of `repro.launch.train`, with ``--device`` (default ``cuda``; the
CPU runs the kernels' plain versions, and nothing falls back to it):
data pipeline -> train step -> metrics -> async checkpoints; resumes from
the latest checkpoint on restart (crash or preemption), restoring the
state onto this run's device whatever device wrote it. On SIGTERM it
checkpoints the step it finished and stops.

The port trains on one device: the mesh is (data, model) = (1, 1) unless
``--data``/``--model`` ask otherwise, and one over more devices raises
(data- and model-parallel training, and with it placing the state by
`repro_torch.parallel.param_pspecs`, comes with the multi-card slice; on
one device every spec is replicated).

Straggler mitigation: per-step wall times (each step ends in a host read
of its loss, so the card has finished it) feed an EWMA; steps slower than
`--straggler-factor` x EWMA are counted and logged.
"""
from __future__ import annotations

import argparse
import signal
import time

from .. import configs
from ..models.config import ShapeSpec
from ..train import AdamW, cosine_schedule, init_state, make_train_step
from ..train.checkpoint import Checkpointer, latest_step, restore
from ..train.data import SyntheticTokens
from .mesh import make_local_mesh

__all__ = ["main"]


def main(argv=None, report: dict | None = None):
    """Train and return the losses of the steps run. With `report` (a
    dict), also fill in what a caller measuring the run needs: per step
    its seconds, grad norm and lr, the step resumed from, the straggler
    count."""
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
    ap.add_argument("--data", type=int, default=0, help="data-mesh size (0=1)")
    ap.add_argument("--model", type=int, default=1, help="model-mesh size")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")

    mesh = make_local_mesh(args.data or 1, args.model, args.device)
    if mesh.size > 1:
        raise NotImplementedError(
            f"mesh {mesh.shape}: the port trains on one device; data- and "
            "model-parallel training comes with the multi-card slice")
    print(f"[train] {cfg.name} device={args.device} mesh={mesh.shape}")

    opt = AdamW(lr=cosine_schedule(args.lr, 10, args.steps), zero1=True)
    step_fn = make_train_step(cfg, opt, args.microbatches)
    state = init_state(cfg, args.seed, opt, args.device)

    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            print(f"[train] resuming from step {last} onto {args.device}")
            restore(args.ckpt_dir, last, state)
            start = last

    stop = {"flag": False}
    prev_handler = signal.signal(signal.SIGTERM,
                                 lambda *_: stop.update(flag=True))
    try:
        data = iter(SyntheticTokens(cfg, shape, args.seed, args.device,
                                    start_step=start))
        ewma, stragglers = None, 0
        losses, seconds, gnorms, lrs = [], [], [], []
        for i in range(start, args.steps):
            batch = next(data)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > args.straggler_factor * ewma:
                stragglers += 1
                print(f"[train] straggler step {i}: {dt:.2f}s vs ewma "
                      f"{ewma:.2f}s")
            losses.append(loss)
            seconds.append(dt)
            gnorms.append(float(metrics["grad_norm"]))
            lrs.append(float(metrics["lr"]))
            if i % 10 == 0 or i == args.steps - 1:
                print(f"[train] step {i:5d} loss={loss:.4f} "
                      f"gnorm={gnorms[-1]:.3f} {dt*1e3:.0f}ms")
            if ckpt and (i + 1) % args.ckpt_every == 0:
                ckpt.save_async(i + 1, state)
            if stop["flag"]:
                print("[train] SIGTERM — checkpointing and exiting")
                if ckpt:
                    ckpt.save_async(i + 1, state)
                break
        if ckpt:
            ckpt.wait()
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
    if losses:
        print(f"[train] done. first loss={losses[0]:.4f} "
              f"last={losses[-1]:.4f} stragglers={stragglers}")
    if report is not None:
        report.update(start=start, losses=losses, step_seconds=seconds,
                      grad_norms=gnorms, lrs=lrs, stragglers=stragglers,
                      state=state)
    return losses


if __name__ == "__main__":
    main()
