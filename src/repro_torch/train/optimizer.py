"""AdamW with global-norm clipping, and ZeRO-1 optimizer-state sharding.

Port of `repro.train.optimizer`. Moment tensors are float32 whatever the
parameter's type; the update computes in float32 and casts back to the
parameter's type. The schedule, the bias corrections and the clip scale
are float32 tensors on the parameters' device, as the reference's jnp
computes them (not Python floats). The port updates the parameters and
the moments in place (JAX returns new arrays); the step count is a new
tensor. The optimizer state is {"m": {name: tensor}, "v": {name: tensor},
"step": int32 scalar}, keyed by parameter name.

`make_placement` is the one rule by which the port cuts a train state:
each parameter's global shape, its spec (the port's tensor-parallel
layout, `parallel.sharding.tp_pspecs`: the reference's `param_pspecs`
but where a rank's block could not compute on its heads), whether its
gradient is partial over the model axis, and its moments' spec, which is
its spec with the data-parallel axes it leaves free on its first
replicated dimension that they divide. The reference's
layers are stacked on a leading axis, which that rule may take; the
port's layers are tensors of their own, so it takes the first divisible
dimension of the layer's own shape. A free axis of size 1 is named too
(it cuts nothing), so that a world of one runs the same reduce-scatter
and all-gather as a world of W. `zero1_pspecs` is the reference's own
rule, which leaves a spec whose free axes have size 1 as it is; it is
kept to hold the port's specs to the reference's on abstract meshes.

Under a mesh that spans a process group, each
rank holds its block of the moments (ZeRO-1). `AdamW.update` then reduces
each gradient over the data-parallel axes that its parameter does not
use (a reduce-scatter straight into the moments' block where ZeRO-1 cuts
the parameter, else an all-reduce), sums the partial parts of the
gradients over the model axis in one all-reduce (`Placement.tp_sum`: a
replicated parameter whose every rank computed only its own part, the
replicated segments of a `Segments` one), and divides them by the
data-parallel size; the expert
weights, cut over ep = dp, are not reduced (the all_to_all's backward has
already summed every rank's tokens into them) but divided alike. The clip
uses the global norm: each rank adds the squares of the gradient blocks
it owns, a block replicated over some axes counted only by the rank at
coordinate 0 on them (of a `Segments` parameter, its replicated segments
only at model coordinate 0), and the sum is all-reduced over the mesh. Each rank updates its block of the parameter
and the parameter is all-gathered over the axes ZeRO-1 cut it by.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..parallel import (
    ParallelCtx,
    current_ctx,
    default_rules,
    parallel_ctx,
)
from ..parallel.collectives import all_gather, psum, psum_scatter
from ..parallel.sharding import Segments, local_shape, spec_axes, tp_pspecs

__all__ = ["AdamW", "Placement", "cosine_schedule", "make_placement",
           "zero1_pspecs"]


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


def _free(spec: tuple, dp: tuple) -> tuple:
    """The dp axes that `spec` leaves unused (expert weights already use
    the dp axes for expert parallelism)."""
    used = {a for ax in spec for a in spec_axes(ax)}
    return tuple(a for a in dp if a not in used)


def _extend(spec: tuple, shape, mesh, dp: tuple) -> tuple:
    """`spec` with the dp axes it leaves free on the first replicated
    dimension that they divide (ZeRO-1's cut of the moments)."""
    shape = tuple(getattr(shape, "shape", shape))
    parts = list(spec) + [None] * (len(shape) - len(spec))
    free = _free(spec, dp)
    size = math.prod(mesh.shape[a] for a in free)
    for i, (ax, dim) in enumerate(zip(parts, shape)):
        if free and ax is None and dim % size == 0 and dim >= size:
            parts[i] = free if len(free) > 1 else free[0]
            return tuple(parts)
    return tuple(spec)  # nothing divisible: stays param-sharded only


def zero1_pspecs(param_specs: dict, params_shapes: dict,
                 ctx: Optional[ParallelCtx] = None) -> dict:
    """The reference's rule: param specs ({name: spec}) extended with the
    free DP axes where their size is above 1; `params_shapes` is {name:
    shape or tensor}. The port's trained state is cut by `make_placement`,
    which also names free axes of size 1."""
    ctx = ctx or current_ctx()
    dp = ctx.axes("dp") if ctx.mesh is not None else None
    if not dp:
        return dict(param_specs)
    mesh = ctx.mesh
    return {name: (_extend(spec, params_shapes[name], mesh, dp)
                   if math.prod(mesh.shape[a] for a in _free(spec, dp)) > 1
                   else tuple(spec))
            for name, spec in param_specs.items()}


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a train state is cut over `mesh` (a process-group mesh): per
    parameter name its global shape, its spec, its moments' spec, and
    whether the replicated part of its gradient is partial over the model
    axis (`parallel.sharding.tp_pspecs`)."""
    mesh: object
    shapes: dict
    params: dict
    state: dict
    partial: dict = dataclasses.field(default_factory=dict)

    def _tp(self):
        return default_rules(self.mesh)["tp"]

    def _segments(self, name: str):
        """(dim, `Segments`) of a packed parameter, else (None, None)."""
        for i, e in enumerate(self.params[name]):
            if isinstance(e, Segments):
                return i, e
        return None, None

    def partial_parts(self, name: str, g: torch.Tensor) -> list:
        """The views of `g` (this rank's gradient block, or ZeRO-1's block
        of it) that are partial over the model axis: all of it, the
        replicated segments of a `Segments` parameter, or none."""
        if not self.partial.get(name):
            return []
        dim, seg = self._segments(name)
        if seg is None:
            return [g]
        return [g.narrow(dim, a, n) for a, n in
                seg.replicated_ranges(self.mesh.axis_size(seg.axes))]

    def tp_sum(self, grads: dict) -> None:
        """Sum the partial parts of `grads` ({name: block}) over the model
        axis in place, in one all-reduce of them laid end to end."""
        parts = [v for n, g in grads.items() for v in self.partial_parts(n, g)]
        if not parts:
            return
        flat = torch.cat([v.reshape(-1) for v in parts])
        flat = psum(flat, self._tp(), self.mesh)
        at = 0
        for v in parts:
            v.copy_(flat[at:at + v.numel()].view_as(v))
            at += v.numel()

    def sq_norm(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """This rank's share of the squared global norm from its block `g`
        of the gradient of `name` (whole after `tp_sum`): all of it where
        it `owns` the block, and of a `Segments` parameter off model
        coordinate 0 only its cut segments."""
        if not self.owns(name):
            return torch.zeros((), dtype=torch.float32, device=g.device)
        dim, seg = self._segments(name)
        if seg is None or self.mesh.axis_index(seg.axes) == 0:
            return torch.sum(torch.square(g))
        n = self.mesh.axis_size(seg.axes)
        sizes = seg.local_sizes(n)
        parts = torch.split(g, list(sizes), dim=dim)
        return sum(torch.sum(torch.square(p)) for p, c in zip(parts, seg.cut)
                   if c)

    def leaf_specs(self) -> dict:
        """{checkpoint leaf name: spec}: parameters, ``m.*``, ``v.*``,
        ``step``."""
        out = dict(self.params)
        out.update({f"m.{n}": s for n, s in self.state.items()})
        out.update({f"v.{n}": s for n, s in self.state.items()})
        out["step"] = ()
        return out

    def cut(self, name: str):
        """(dim, axes) by which the moments cut the local parameter block,
        or (None, ()) where they hold all of it."""
        state, spec = self.state[name], tuple(self.params[name])
        spec += (None,) * (len(state) - len(spec))
        for i, (a, b) in enumerate(zip(state, spec)):
            if a != b:
                return i, spec_axes(a)
        return None, ()

    def free(self, name: str) -> tuple:
        """The data-parallel axes the parameter's own spec leaves unused:
        those its gradient is reduced over."""
        return _free(self.params[name], default_rules(self.mesh)["dp"])

    def owns(self, name: str) -> bool:
        """Whether this rank counts its gradient block of `name` in the
        global norm: at coordinate 0 on every axis the block is
        replicated over."""
        mesh = self.mesh
        used = {a for e in self.state[name] for a in spec_axes(e)}
        return all(c == 0 for a, c in zip(mesh.axis_names, mesh.coords)
                   if a not in used)


def make_placement(shapes: dict, mesh, cfg) -> Placement:
    """The placement of parameters of global `shapes` ({name: shape}) of a
    model of `cfg` on `mesh`, by `tp_pspecs` and ZeRO-1 (on axes of any
    size)."""
    with parallel_ctx(mesh) as ctx:
        p_specs, partial = tp_pspecs(shapes, cfg, ctx)
        dp = ctx.axes("dp") or ()
    state = {n: _extend(p_specs[n], shapes[n], mesh, dp) for n in shapes}
    return Placement(mesh, {n: tuple(s) for n, s in shapes.items()}, p_specs,
                     state, partial)


def _scalar(x: float, device) -> torch.Tensor:
    """`x` rounded to a float32 scalar tensor, filled on `device`: on the
    card a tensor made from a Python float is a copy from pageable host
    memory that the host waits for."""
    return torch.full((), x, dtype=torch.float32, device=device)


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
        return _scalar(self.lr, step.device)

    def init(self, params: torch.nn.Module,
             placement: Optional[Placement] = None) -> dict:
        """Zero moments: of each parameter's shape, or under `placement`
        of this rank's block of its moments' spec."""
        named = list(params.named_parameters())
        dev = named[0][1].device

        def zeros(n, p):
            shape = p.shape if placement is None else local_shape(
                placement.shapes[n], placement.state[n], placement.mesh)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return {"m": {n: zeros(n, p) for n, p in named},
                "v": {n: zeros(n, p) for n, p in named},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: torch.nn.Module,
               placement: Optional[Placement] = None):
        """One step: grads {name: tensor} (any float type) -> (params,
        state, {"grad_norm", "lr"}), the parameters and moments updated in
        place. The global norm adds the leaves' float32 sums of squares in
        parameter order. Under `placement` the step is ZeRO-1's (module
        docstring); `grads` is emptied as each gradient is reduced."""
        if placement is not None:
            return self._update_zero1(grads, state, params, placement)
        step = state["step"] + 1
        lr = self._lr(step)
        gsq = torch.zeros((), dtype=torch.float32, device=step.device)
        for g in grads.values():
            gsq = gsq + torch.sum(torch.square(g.float()))
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        c1, c2 = self._corrections(step)
        for name, p in params.named_parameters():
            self._adam(p, grads[name].float() * scale, state["m"][name],
                       state["v"][name], lr, c1, c2)
        return params, {"m": state["m"], "v": state["v"], "step": step}, {
            "grad_norm": gnorm, "lr": lr}

    def _corrections(self, step: torch.Tensor):
        stepf = step.to(torch.float32)
        c1 = 1 - torch.pow(_scalar(self.b1, step.device), stepf)
        c2 = 1 - torch.pow(_scalar(self.b2, step.device), stepf)
        return c1, c2

    def _adam(self, p, g, m, v, lr, c1, c2) -> None:
        """One AdamW step of p (a parameter or its block) and its moments
        m, v, in place."""
        b1, b2 = self.b1, self.b2
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + self.eps) + \
            self.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    def _update_zero1(self, grads: dict, state: dict, params, pl: Placement):
        mesh = pl.mesh
        dp = default_rules(mesh)["dp"]
        n_dp = mesh.axis_size(dp) if dp else 1
        step = state["step"] + 1
        lr = self._lr(step)
        named = list(params.named_parameters())
        shards = {}
        for name, _ in named:
            g = grads.pop(name).float()
            dim, axes = pl.cut(name)
            if dim is not None:
                g = psum_scatter(g, axes, dim, mesh)
            elif pl.free(name):
                g = psum(g, pl.free(name), mesh)
            shards[name] = g
        pl.tp_sum(shards)
        gsq = torch.zeros((), dtype=torch.float32, device=step.device)
        for name, _ in named:
            g = shards[name] / n_dp
            gsq = gsq + pl.sq_norm(name, g)
            shards[name] = g
        gsq = psum(gsq, mesh.axis_names, mesh)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        c1, c2 = self._corrections(step)
        for name, p in named:
            g = shards.pop(name) * scale
            dim, axes = pl.cut(name)
            block = p if dim is None else p.narrow(
                dim, mesh.axis_index(axes) * g.shape[dim], g.shape[dim])
            self._adam(block, g, state["m"][name], state["v"][name], lr, c1, c2)
            if dim is not None:
                p.copy_(all_gather(block, axes, dim, mesh))
        return params, {"m": state["m"], "v": state["v"], "step": step}, {
            "grad_norm": gnorm, "lr": lr}
