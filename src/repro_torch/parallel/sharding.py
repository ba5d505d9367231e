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
The port's layers run their own collectives on their blocks instead
(`models.layers`: the tensor-parallel helpers).

`tp_pspecs` is the port's tensor-parallel layout, the one the trained
state is cut by (`train.optimizer.make_placement`); `param_pspecs` stays
the reference's rule. They differ where the reference's rule would cut
inside a head or across a packed projection, which GSPMD can move but a
rank's local block cannot compute on:
  - a block whose heads the model axis does not divide is replicated
    whole (attention by `heads_eff`, Mamba2 by its di / 64 heads, mLSTM
    by `n_heads`), as `maybe_axis` replicates a dimension it does not
    divide (yi-34b-reduced's 7 heads on 2 ranks);
  - `w_k`/`w_v` when `n_kv_heads` does not divide the axis: replicated,
    each rank projecting the kv heads its q heads use;
  - Mamba2's packed `w_in` (z, x, B, C, dt) and `conv_w` (x, B, C): a
    `Segments` entry, z, x and dt cut by heads, B and C (one group shared
    by every head) replicated;
  - mLSTM's `w_gates` (i, f): `Segments`, each gate cut by heads;
  - the sLSTM (`w_x`, `w_h`, `w_out`): replicated: its recurrence would
    need an all-gather of h at every one of T steps.
It also says which replicated parameters' gradients are partial, each
rank holding only the part its own work produced, and so must be summed
over the model axis before the data-parallel reduction: under
``cfg.residual == "tp"`` every one but a replicated `lm_head` (norms
over the cut residual, replicated blocks, `w_concat`); under
"replicated" those used inside a cut block (the per-head q/k norms,
replicated `w_k`/`w_v`, the Mamba and mLSTM norms over their cut inner
dimension, a replicated MoE shared expert). Of a `Segments` parameter
the replicated segments are the partial part.

`tp_cache_pspecs` is the decode cache's layout matched to `tp_pspecs`
(the reference's `cache_pspecs` but where the port's layers hold a block
otherwise; its docstring lists where): a KV cache cut by kv heads where
the model axis divides them, else by sequence where it divides the
cache's length, else replicated (`kv_cache_cut`), and each state cut as
the block that updates it.
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
    "Segments",
    "constrain",
    "current_ctx",
    "default_rules",
    "gather_full",
    "kv_cache_cut",
    "local_shape",
    "local_shard",
    "maybe_axis",
    "param_pspecs",
    "parallel_ctx",
    "shard_module",
    "spec_axes",
    "tp_cache_pspecs",
    "tp_pspecs",
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


@dataclasses.dataclass(frozen=True)
class Segments:
    """A spec entry for a dimension packed of segments (Mamba2's `w_in`
    columns z, x, B, C, dt): segment i has global size ``sizes[i]`` and is
    cut over `axes` where ``cut[i]``, else replicated. A rank's block is
    its block of every cut segment and the whole of every other, in the
    segments' order."""
    sizes: tuple
    cut: tuple
    axes: object

    def local_sizes(self, n: int) -> tuple:
        for s, c in zip(self.sizes, self.cut):
            if c and s % n:
                raise ValueError(f"segment {s} of {self.sizes} does not "
                                 f"split over {self.axes} ({n})")
        return tuple(s // n if c else s for s, c in zip(self.sizes, self.cut))

    def replicated_ranges(self, n: int) -> list:
        """[(start, length)] of the replicated segments in a rank's block."""
        out, at = [], 0
        for size, c in zip(self.local_sizes(n), self.cut):
            if not c:
                out.append((at, size))
            at += size
        return out


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry: () for None, (name,) for a name."""
    if entry is None:
        return ()
    if isinstance(entry, Segments):
        return spec_axes(entry.axes)
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """Each rank's block of a tensor of `shape` cut by `spec`."""
    out = list(shape)
    for i, entry in enumerate(spec):
        axes = spec_axes(entry)
        if isinstance(entry, Segments):
            if sum(entry.sizes) != out[i]:
                raise ValueError(f"dim {i} of {tuple(shape)} is not "
                                 f"{entry.sizes}")
            out[i] = sum(entry.local_sizes(mesh.axis_size(axes)))
        elif axes:
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
        if isinstance(entry, Segments):
            n, r = mesh.axis_size(axes), mesh.axis_index(axes)
            local_shape(out.shape, (None,) * i + (entry,), mesh)
            parts = torch.split(out, list(entry.sizes), dim=i)
            out = torch.cat([p.narrow(i, r * (p.shape[i] // n), p.shape[i] // n)
                             if c else p for p, c in zip(parts, entry.cut)],
                            dim=i)
        elif axes:
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
    must call it); of a `Segments` dimension, one all-gather of its cut
    segments."""
    from .collectives import all_gather

    out = t.detach()
    with torch.no_grad():
        for i, entry in enumerate(spec):
            axes = spec_axes(entry)
            if isinstance(entry, Segments):
                n = mesh.axis_size(axes)
                parts = torch.split(out, list(entry.local_sizes(n)), dim=i)
                cut = [p for p, c in zip(parts, entry.cut) if c]
                got = all_gather(torch.cat(cut, dim=i), axes, i, mesh)
                # rank-major blocks of the cut segments, back in order
                blocks = torch.split(got, [sum(p.shape[i] for p in cut)] * n,
                                     dim=i)
                pieces, k = [], 0
                for p, c in zip(parts, entry.cut):
                    if c:
                        w = p.shape[i]
                        pieces.append(torch.cat([b.narrow(i, k, w)
                                                 for b in blocks], dim=i))
                        k += w
                    else:
                        pieces.append(p)
                out = torch.cat(pieces, dim=i)
            elif axes:
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


def tp_pspecs(shapes: dict, cfg, ctx: Optional[ParallelCtx] = None):
    """The port's tensor-parallel layout of parameters of global `shapes`
    ({name: shape}) for `cfg`: ({name: spec}, {name: partial}). The specs
    are `param_pspecs`'s but for the departures the module docstring
    lists; ``partial[name]`` says that the replicated part of the
    parameter's gradient is partial over the model axis."""
    ctx = ctx or current_ctx()
    specs = param_pspecs(shapes, ctx)
    tp_axes = ctx.axes("tp") if ctx.mesh is not None else None
    if not tp_axes:
        return specs, {n: False for n in specs}
    tp = ctx.axis_size("tp")
    ax = tp_axes[0] if len(tp_axes) == 1 else tuple(tp_axes)
    if cfg.residual == "tp" and cfg.d_model % tp:
        raise ValueError(f"d_model {cfg.d_model} does not split over the "
                         f"model axis ({tp}) under residual 'tp'")
    by_default = cfg.residual == "tp"
    d, S = cfg.d_model, cfg.ssm_state
    di = cfg.ssm_expand * d
    Hm = di // 64
    out, partial = {}, {}
    for name, shape in shapes.items():
        shape = tuple(getattr(shape, "shape", shape))
        parts = name.split(".")
        leaf, mod = parts[-1], (parts[-2] if len(parts) > 1 else "")
        spec, part = specs[name], by_default
        whole = (None,) * len(shape)
        # cut over the axis (at size 1, where `maybe_axis` names no axis,
        # every block is its whole: cut, as the layers treat it)
        cut = tp == 1 or any(spec_axes(e) for e in spec)
        if mod in ("attn", "xattn"):
            if cfg.heads_eff % tp:
                spec = whole
            elif leaf in ("w_k", "w_v") and cfg.n_kv_heads % tp:
                spec, part = whole, True
            else:
                part = leaf in ("q_norm", "k_norm")
        elif mod == "mamba":
            if Hm % tp:
                spec = whole
            elif leaf == "w_in":
                spec = (None, Segments((di, di, S, S, Hm),
                                       (True, True, False, False, True), ax))
                part = True
            elif leaf == "conv_w":
                spec = (None, Segments((di, S, S), (True, False, False), ax))
                part = True
            else:
                part = leaf == "norm"
        elif mod == "mlstm":
            H = cfg.n_heads
            if H % tp:
                spec = whole
            elif leaf == "w_gates":
                spec, part = (None, Segments((H, H), (True, True), ax)), False
            else:
                part = leaf == "norm"
        elif mod == "slstm":
            spec = whole
        elif mod == "shared" and "moe" in parts:
            part = not cut
        elif mod in ("moe", "mlp") or leaf == "tok_emb":
            part = part and not cut
        elif leaf == "lm_head":
            part = False
        out[name], partial[name] = tuple(spec), bool(part)
    return out, partial


def kv_cache_cut(n_kv_heads: int, length: int, tp: int) -> str:
    """How a KV cache of `n_kv_heads` heads and `length` positions is cut
    over a model axis of `tp` ranks, in the reference's `maybe_axis`
    order: "heads" where tp divides the kv heads (at tp 1 too), else
    "seq" where it divides the length, else "whole" (replicated)."""
    if n_kv_heads % tp == 0:
        return "heads"
    return "seq" if length % tp == 0 else "whole"


def tp_cache_pspecs(cache: dict, cfg, ctx: Optional[ParallelCtx] = None
                    ) -> dict:
    """{name: spec} of a decode cache of global shapes (`models.init_cache`)
    in the layout the port's decode runs on, matched to `tp_pspecs`. The
    reference's `cache_pspecs` but for these departures:
      - ``conv`` (L, B, K-1, di + 2S): `Segments` (x, B, C) with x cut by
        heads and B, C whole, as `conv_w`; the reference cuts the last
        dimension contiguously, across the segments;
      - ``ssm`` and ``mlstm``: by heads only where the block is cut, else
        whole, as the block's weights (the reference's `maybe_axis` cuts
        any heads the axis divides);
      - ``slstm_*``: whole, as the sLSTM's weights; the reference cuts
        them by channel.
    The KV caches (``k``, ``v``, ``xk``, ``xv``, ``attn_k``, ``attn_v``)
    follow `kv_cache_cut`; ``pos`` and ``mem_len`` are cut over dp, and
    every batch dimension is, where dp divides it."""
    ctx = ctx or current_ctx()
    tp_axes = ctx.axes("tp") if ctx.mesh is not None else None
    tp = ctx.axis_size("tp") if tp_axes else 1
    ax = None
    if tp > 1:
        ax = tp_axes[0] if len(tp_axes) == 1 else tuple(tp_axes)
    d, S = cfg.d_model, cfg.ssm_state
    di = cfg.ssm_expand * d

    def dp(n):
        return maybe_axis(ctx, "dp", n) if ctx.mesh is not None else None

    def spec(name, x):
        shape = tuple(x.shape)
        if name in ("k", "v", "xk", "xv", "attn_k", "attn_v"):
            _, B, T, H, _ = shape
            cut = kv_cache_cut(H, T, tp)
            return (None, dp(B), ax if cut == "seq" else None,
                    ax if cut == "heads" else None, None)
        if name == "ssm":
            return (None, dp(shape[1]), ax if shape[2] % tp == 0 else None,
                    None, None)
        if name == "conv":
            if (di // 64) % tp or ax is None:
                return (None, dp(shape[1]), None, None)
            return (None, dp(shape[1]), None,
                    Segments((di, S, S), (True, False, False), ax))
        if name == "mlstm":
            return (None, dp(shape[1]), ax if cfg.n_heads % tp == 0 else None,
                    None, None)
        if name.startswith("slstm"):
            return (None, dp(shape[1]), None)
        if name in ("pos", "mem_len"):
            return (dp(shape[0]),)
        return ()

    return {name: spec(name, x) for name, x in cache.items()}
