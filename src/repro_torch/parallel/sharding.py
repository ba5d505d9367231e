"""Logical-axis sharding: rules, divisibility-aware mapping, param specs.

Port of `repro.parallel.sharding`. Logical axes:
  dp  — data parallel      -> ("pod", "data") when multi-pod, else ("data",)
  tp  — tensor parallel    -> ("model",)
  ep  — expert parallel    -> same mesh axes as dp
  sp  — sequence parallel  -> ("model",)

A spec is a tuple with one entry per dimension of a tensor: None
(replicated), a mesh-axis name, or a tuple of names; ``()`` is fully
replicated (the reference's ``PartitionSpec()``). Mapping is
divisibility-aware, as the reference's: a dimension that does not divide
the axes' size is replicated along them (or takes a prefix of them).

`param_pspecs` derives a spec per parameter from its leaf name by the
reference's rules (`_PARAM_RULES`). The port's layers are an
`nn.ModuleList`, not a stacked leading axis, so a layer's spec is the
reference's without its leading None. The meshes are
`repro_torch.launch.mesh.Mesh`. The port runs one process on one device:
`constrain` checks its spec and returns the tensor as it is (with no mesh
or a mesh of one device the reference's is the identity too); placing
tensors across cards comes with the multi-card slice.
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
    "maybe_axis",
    "param_pspecs",
    "parallel_ctx",
]

_STATE = threading.local()


@dataclasses.dataclass
class ParallelCtx:
    mesh: Optional[object]    # a repro_torch.launch.mesh.Mesh, or None
    rules: dict

    @property
    def active(self) -> bool:
        return self.mesh is not None and math.prod(self.mesh.shape.values()) > 1

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


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint by logical axes. Without an
    active mesh it is the identity, as the reference's; with one, the spec
    is checked against x and x is returned unchanged (one process holds
    the whole tensor)."""
    ctx = current_ctx()
    if not ctx.active:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"{len(logical)} logical axes for shape "
                         f"{tuple(x.shape)}")
    return x


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
