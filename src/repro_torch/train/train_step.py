"""Train step: loss -> grads -> AdamW, with microbatched gradient
accumulation.

Port of `repro.train.train_step`. `make_train_step(cfg, opt,
microbatches)` builds the step. With microbatches > 1 the global batch is
split along its first axis and each microbatch's gradients are added into
float32 accumulators in microbatch order (the reference's `lax.scan`);
loss and gradients are then divided by the count. The state is {"params":
LM (an nn.Module with gradients on), "opt": AdamW state}; the step updates
it in place and returns it with {"loss", "grad_norm", "lr"}.
"""
from __future__ import annotations

import torch

from ..models import init_params, loss_fn
from ..models.config import ModelConfig
from .optimizer import AdamW

__all__ = ["TrainState", "init_state", "make_train_step"]

TrainState = dict  # {"params": LM, "opt": {"m", "v", "step"}}


def init_state(cfg: ModelConfig, seed: int, opt: AdamW,
               device: str | torch.device = "cuda") -> TrainState:
    """A model of `cfg` from `seed` (`init_params`) on `device`, its
    gradients turned on, and the optimizer's state."""
    params = init_params(cfg, seed, device)
    params.requires_grad_(True)
    return {"params": params, "opt": opt.init(params)}


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
        _, new_opt, metrics = opt.update(dict(zip(names, grads)), state["opt"],
                                         params)
        metrics["loss"] = loss
        return {"params": params, "opt": new_opt}, metrics

    return train_step
