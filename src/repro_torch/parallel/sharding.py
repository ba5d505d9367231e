"""Logical-axis sharding: rules, divisibility-aware mapping, param specs,
and cutting tensors by a spec over a process-group mesh.

Port of `repro.parallel.sharding`. Logical axes:
  dp  — data parallel      -> ("pod", "data") when multi-pod, else ("data",)
  tp  — tensor parallel    -> ("model",)
  ep  — expert parallel    -> same mesh axes as dp
  sp  — sequence parallel  -> ("model",)

A spec is a tuple with one entry per dimension of a tensor: None
(replicated), a mesh-axis name, or a tuple of names; ``()`` is fully
replicated (the reference's ``PartitionSpec()``); dimensions past the
spec's end are replicated. Mapping is divisibility-aware, as the
reference's: a dimension that does not divide the axes' size is
replicated along them (or takes a prefix of them).

`param_pspecs` derives a spec per parameter from its leaf name by the
reference's rules (`_PARAM_RULES`). The port's layers are an
`nn.ModuleList`, not a stacked leading axis, so a layer's spec is the
reference's without its leading None. The meshes are
`repro_torch.launch.mesh.Mesh`.

Where the reference places global arrays and lets GSPMD move them, the
port runs one process a rank, each holding its own block of every
tensor: `local_shard` cuts a full tensor to this rank's block by a spec,
`gather_full` joins the blocks back (all-gathers over the spec's axes),
`shard_module` cuts an `nn.Module`'s parameters in place. `constrain`,
the reference's sharding constraint, moves nothing: under an active mesh
it checks that a tensor is the local block of the global shape it is
given (a dimension cut over axes of total size s holds dim / s rows).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import torch

__all__ = [
    "ParallelCtx",
    "constrain",
    "current_ctx",
    "default_rules",
    "gather_full",
    "local_shape",
    "local_shard",
    "maybe_axis",
    "param_pspecs",
    "parallel_ctx",
    "shard_module",
    "spec_axes",
]

_STATE = threading.local()


@dataclasses.dataclass
class ParallelCtx:
    mesh: Optional[object]    # a repro_torch.launch.mesh.Mesh, or None
    rules: dict

    @property
    def active(self) -> bool:
        return self.mesh is not None and math.prod(self.mesh.shape.values()) > 1

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans a process group, of any size: the
        collectives run (even over one rank)."""
        return self.mesh is not None and getattr(self.mesh, "distributed", False)

    def axes(self, logical: Optional[str]):
        if logical is None:
            return None
        return self.rules.get(logical)

    def axis_size(self, logical: str) -> int:
        axes = self.rules.get(logical)
        if not axes or self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in axes)


def default_rules(mesh) -> dict:
    if mesh is None:
        return {}
    names = mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = ("model",) if "model" in names else ()
    return {"dp": dp, "tp": tp, "ep": dp, "sp": tp}


@contextlib.contextmanager
def parallel_ctx(mesh, rules: Optional[dict] = None):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ParallelCtx(mesh, rules or default_rules(mesh))
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def current_ctx() -> ParallelCtx:
    ctx = getattr(_STATE, "ctx", None)
    return ctx if ctx is not None else ParallelCtx(None, {})


def maybe_axis(ctx: ParallelCtx, logical: Optional[str], dim: int):
    """Mesh axes for `logical` if `dim` divides their product, else None."""
    axes = ctx.axes(logical)
    if not axes:
        return None
    size = math.prod(ctx.mesh.shape[a] for a in axes)
    if size <= 1 or dim % size != 0:
        # try a prefix of the axes (e.g. ("pod","data") -> ("pod",))
        for cut in range(len(axes) - 1, 0, -1):
            sub = axes[:cut]
            s = math.prod(ctx.mesh.shape[a] for a in sub)
            if s > 1 and dim % s == 0:
                return sub
        return None
    return axes if len(axes) > 1 else axes[0]


def constrain(x: torch.Tensor, *logical: Optional[str],
              shape: Optional[tuple] = None) -> torch.Tensor:
    """The reference's sharding constraint by logical axes. Without an
    active mesh it is the identity, as the reference's. With one, x is
    this rank's block and is returned unchanged; its rank is checked
    against the axes and, given the global `shape`, its shape against the
    block that `shape` cut by the spec of `logical` leaves each rank."""
    ctx = current_ctx()
    if not (ctx.active or ctx.distributed):
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"{len(logical)} logical axes for shape "
                         f"{tuple(x.shape)}")
    if shape is not None:
        spec = tuple(maybe_axis(ctx, ax, d) for ax, d in zip(logical, shape))
        want = local_shape(shape, spec, ctx.mesh)
        if tuple(x.shape) != want:
            raise ValueError(f"shape {tuple(x.shape)} is not the block "
                             f"{want} of {tuple(shape)} cut by {spec}")
    return x


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry: () for None, (name,) for a name."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """Each rank's block of a tensor of `shape` cut by `spec`."""
    out = list(shape)
    for i, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            n = mesh.axis_size(axes)
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"over {axes} ({n})")
            out[i] //= n
    return tuple(out)


def local_shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor `t` cut by `spec` (a copy)."""
    out = t
    for i, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            n = mesh.axis_size(axes)
            if out.shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(t.shape)} does not split"
                                 f" over {axes} ({n})")
            c = out.shape[i] // n
            out = out.narrow(i, mesh.axis_index(axes) * c, c)
    return out.clone(memory_format=torch.contiguous_format)


def gather_full(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor from each rank's block `t` cut by `spec`: an
    all-gather over each cut dimension's axes (every rank of those groups
    must call it)."""
    from .collectives import all_gather

    out = t.detach()
    with torch.no_grad():
        for i, entry in enumerate(spec):
            axes = spec_axes(entry)
            if axes:
                out = all_gather(out, axes, i, mesh)
    return out


def shard_module(module: torch.nn.Module, specs: dict, mesh) -> torch.nn.Module:
    """Cut every parameter of `module` to this rank's block of its spec
    (`specs`: {name: spec}, as `param_pspecs`), in place; returns it."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if any(spec_axes(e) for e in specs[name]):
                p.data = local_shard(p.data, specs[name], mesh)
    return module


# leaf-name -> logical axes, aligned to the LAST ndim of the leaf
# (leading layer-stack axes are replicated). None = replicated dim.
_PARAM_RULES: dict[str, tuple] = {
    "tok_emb": ("tp", None),          # (V, d) vocab-sharded
    "pos_emb": (None, None),
    "lm_head": (None, "tp"),          # (d, V)
    "w_q": (None, "tp"),
    "w_k": (None, "tp"),
    "w_v": (None, "tp"),
    "w_o": ("tp", None),
    "w_gate": (None, "tp"),
    "w_up": (None, "tp"),
    "w_down": ("tp", None),
    "w_router": ("tp", None),
    # MoE experts: (E, d, F) / (E, F, d) — E over ep, contraction over tp
    "moe_w_gate": ("ep", "tp", None),
    "moe_w_up": ("ep", "tp", None),
    "moe_w_down": ("ep", "tp", None),
    # mamba / xlstm
    "w_in": (None, "tp"),
    "w_out": ("tp", None),
    "conv_w": (None, "tp"),
    "A_log": ("tp",),
    "D": ("tp",),
    "dt_bias": ("tp",),
    "w_gates": (None, "tp"),
    "w_x": (None, "tp"),
    "w_h": (None, "tp"),
    # concat-skip projections (hybrid)
    "w_concat": (None, None),
}


def _spec_for(name: str, shape, ctx: ParallelCtx) -> tuple:
    parts = name.split(".")
    leaf = parts[-1]
    # expert weights sit under a 'moe' module (its shared expert is a
    # plain MLP: plain rules)
    in_moe = "moe" in parts and "shared" not in parts
    key = f"moe_{leaf}" if in_moe and f"moe_{leaf}" in _PARAM_RULES else leaf
    rule = _PARAM_RULES.get(key)
    if rule is None or ctx.mesh is None:
        return ()
    ndim, k = len(shape), len(rule)
    logical = (None,) * (ndim - k) + tuple(rule) if ndim >= k else rule[-ndim:]
    return tuple(maybe_axis(ctx, ax, d) for ax, d in zip(logical, shape))


def param_pspecs(params, ctx: Optional[ParallelCtx] = None) -> dict:
    """{parameter name: spec} for an `nn.Module` (its `named_parameters`)
    or a dict of name -> tensor (or shape), by leaf name."""
    ctx = ctx or current_ctx()
    items = (params.named_parameters() if isinstance(params, torch.nn.Module)
             else params.items())
    return {name: _spec_for(name, tuple(getattr(t, "shape", t)), ctx)
            for name, t in items}
