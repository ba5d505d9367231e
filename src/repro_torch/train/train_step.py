"""Train step: loss -> grads -> AdamW, with microbatched gradient
accumulation.

Port of `repro.train.train_step`. `make_train_step(cfg, opt,
microbatches)` builds the step. With microbatches > 1 the global batch is
split along its first axis and each microbatch's gradients are added into
float32 accumulators in microbatch order (the reference's `lax.scan`);
loss and gradients are then divided by the count. The state is {"params":
LM (an nn.Module with gradients on), "opt": AdamW state}; the step updates
it in place and returns it with {"loss", "grad_norm", "lr"}.

Over a mesh that spans a process group (`init_state(..., mesh=)`), the
state also holds its `Placement` and each rank its blocks: the parameters
cut by their specs (the expert weights over ep, the heads, columns and
vocabulary rows over the model axis), the moments by ZeRO-1's; each rank
takes its block of the batch (`launch.specs.batch_pspecs`). `loss_fn`
then runs the model's tensor-parallel collectives, the step reduces the
gradients (the partial ones over the model axis too) and updates through
ZeRO-1 (`AdamW.update`), and the loss, which every model rank computes
whole, is averaged over the data-parallel axes only. It takes this path
at any world size, one rank included: nothing shortcuts the reductions.
"""
from __future__ import annotations

import torch

from ..models import init_params, loss_fn
from ..models.config import ModelConfig
from ..parallel import default_rules, psum
from ..parallel.sharding import local_shard, shard_module
from .optimizer import AdamW, make_placement

__all__ = ["TrainState", "init_state", "make_train_step", "shard_state"]

TrainState = dict  # {"params": LM, "opt": {"m", "v", "step"}[, "placement"]}


def init_state(cfg: ModelConfig, seed: int, opt: AdamW,
               device: str | torch.device = "cuda", mesh=None) -> TrainState:
    """A model of `cfg` from `seed` (`init_params`) on `device`, its
    gradients turned on, and the optimizer's state. With `mesh` (a mesh
    over a process group) every rank draws the same global parameters and
    keeps its blocks (`shard_state`)."""
    params = init_params(cfg, seed, device)
    params.requires_grad_(True)
    if mesh is None:
        return {"params": params, "opt": opt.init(params)}
    pl = make_placement({n: p.shape for n, p in params.named_parameters()},
                        mesh, cfg)
    shard_module(params, pl.params, mesh)
    return {"params": params, "opt": opt.init(params, pl), "placement": pl}


def shard_state(state: TrainState, mesh, cfg: ModelConfig) -> TrainState:
    """Cut a full train state of a model of `cfg` (one device's, or a
    converted reference state) to this rank's blocks on `mesh`, in place:
    the parameters by
    their specs, the moments by ZeRO-1's; returns it with its placement."""
    params = state["params"]
    pl = make_placement({n: p.shape for n, p in params.named_parameters()},
                        mesh, cfg)
    shard_module(params, pl.params, mesh)
    opt = state["opt"]
    for key in ("m", "v"):
        opt[key] = {n: local_shard(t, pl.state[n], mesh)
                    for n, t in opt[key].items()}
    state["placement"] = pl
    return state


def _split_mb(batch: dict, n: int, i: int) -> dict:
    """Microbatch i of n: rows [i * b / n, (i + 1) * b / n) of every
    tensor."""
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} microbatches")
        out[k] = x.reshape(n, b // n, *x.shape[1:])[i]
    return out


def make_train_step(cfg: ModelConfig, opt: AdamW, microbatches: int = 1):
    def grads_of(params, plist, batch):
        loss = loss_fn(params, batch, cfg)
        return loss.detach(), list(torch.autograd.grad(loss, plist))

    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        placement = state.get("placement")
        names, plist = zip(*params.named_parameters())
        if microbatches <= 1:
            loss, grads = grads_of(params, plist, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=plist[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in plist]
            for i in range(microbatches):
                mb_loss, g = grads_of(params, plist,
                                      _split_mb(batch, microbatches, i))
                loss = loss + mb_loss
                grads = [a + b.float() for a, b in zip(grads, g)]
                del g
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        grads = dict(zip(names, grads))
        kw = {} if placement is None else {"placement": placement}
        _, new_opt, metrics = opt.update(grads, state["opt"], params, **kw)
        if placement is not None:
            dp = default_rules(placement.mesh)["dp"]
            loss = psum(loss, dp, placement.mesh) / placement.mesh.axis_size(dp)
        metrics["loss"] = loss
        out = {"params": params, "opt": new_opt}
        if placement is not None:
            out["placement"] = placement
        return out, metrics

    return train_step
