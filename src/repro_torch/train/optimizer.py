"""AdamW with global-norm clipping, and ZeRO-1 optimizer-state specs.

Port of `repro.train.optimizer`. Moment tensors are float32 whatever the
parameter's type; the update computes in float32 and casts back to the
parameter's type. The schedule, the bias corrections and the clip scale
are float32 tensors on the parameters' device, as the reference's jnp
computes them (not Python floats). The port updates the parameters and
the moments in place (JAX returns new arrays); the step count is a new
tensor. The optimizer state is {"m": {name: tensor}, "v": {name: tensor},
"step": int32 scalar}, keyed by parameter name.

`zero1_pspecs` is the reference's spec logic: each parameter's spec
extended with the data-parallel axes on its first replicated, divisible
dimension. The reference's layers are stacked on a leading axis, which
that rule may take; the port's layers are tensors of their own, so it
takes the first divisible dimension of the layer's own shape (the
reference's rule applied to one layer). A spec it does not extend comes
back as it is: on one device (no mesh, or a mesh of one) every spec.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..parallel import ParallelCtx, current_ctx

__all__ = ["AdamW", "cosine_schedule", "zero1_pspecs"]


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """lr(step): a linear warmup to `peak_lr`, then a cosine to `floor` x
    `peak_lr` at `total`; float32, as the reference's jnp."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def zero1_pspecs(param_specs: dict, params_shapes: dict,
                 ctx: Optional[ParallelCtx] = None) -> dict:
    """Extend param specs ({name: spec}) with DP axes for optimizer-state
    sharding; `params_shapes` is {name: shape or tensor}."""
    ctx = ctx or current_ctx()
    dp = ctx.axes("dp") if ctx.mesh is not None else None
    if not dp:
        return dict(param_specs)

    def extend(spec: tuple, shape) -> tuple:
        shape = tuple(getattr(shape, "shape", shape))
        parts = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for ax in parts:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    used.add(a)
        # only mesh axes not already consumed by the param sharding (e.g.
        # expert weights already use the dp axes for expert parallelism)
        free = tuple(a for a in dp if a not in used)
        size = math.prod(ctx.mesh.shape[a] for a in free)
        for i, (ax, dim) in enumerate(zip(parts, shape)):
            if ax is None and size > 1 and dim % size == 0 and dim >= size:
                parts[i] = free if len(free) > 1 else free[0]
                return tuple(parts)
        return tuple(spec)  # nothing divisible: stays param-sharded only

    return {name: extend(spec, params_shapes[name])
            for name, spec in param_specs.items()}


@dataclasses.dataclass
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    zero1: bool = True

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    def init(self, params: torch.nn.Module) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        named = list(params.named_parameters())
        dev = named[0][1].device
        return {"m": {n: zeros(p) for n, p in named},
                "v": {n: zeros(p) for n, p in named},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def opt_state_pspecs(self, param_specs: dict, params_shapes: dict) -> dict:
        base = (zero1_pspecs(param_specs, params_shapes) if self.zero1
                else dict(param_specs))
        return {"m": base, "v": base, "step": ()}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: torch.nn.Module):
        """One step: grads {name: tensor} (any float type) -> (params,
        state, {"grad_norm", "lr"}), the parameters and moments updated in
        place. The global norm adds the leaves' float32 sums of squares in
        parameter order."""
        step = state["step"] + 1
        lr = self._lr(step)
        gsq = torch.zeros((), dtype=torch.float32, device=step.device)
        for g in grads.values():
            gsq = gsq + torch.sum(torch.square(g.float()))
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=step.device), stepf)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=step.device), stepf)
        for name, p in params.named_parameters():
            g = grads[name].float() * scale
            m = state["m"][name]
            v = state["v"][name]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            mh = m / c1
            vh = v / c2
            delta = mh / (torch.sqrt(vh) + self.eps) + \
                self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        return params, {"m": state["m"], "v": state["v"], "step": step}, {
            "grad_norm": gnorm, "lr": lr}
