"""Collective communication over the mesh's process groups.

Port of `repro.parallel.collectives`, through `torch.distributed` (NCCL
on the card, gloo on the CPU), over the groups of a
`repro_torch.launch.mesh.Mesh` that spans a process group (by default
the one `parallel_ctx` holds). Axes are named as in the reference: one
mesh axis, or a tuple of them in the mesh's order.

`hierarchical_psum` — two-phase reduction for multi-pod meshes:
reduce-scatter inside the pod, all-reduce of the 1/N-sized shards across
pods, all-gather back inside the pod; it cuts cross-pod traffic by the
intra-pod world size.

`compressed_pod_psum` — the same with int8 cross-pod traffic (per-tensor
absmax scaling): the pods' int8 shards and scales are gathered, decoded
and summed in pod order. The reference's docstring names a trainer flag
for it that its trainer does not have; the port adds none either.

Beside them, the differentiable collectives that `models.moe.moe_sharded`,
the tensor-parallel layers and the train step use, each tiled as the
reference's ``tiled=True``: `psum_scatter` along a dim, `all_gather`
along a dim and `all_to_all` on dim 0 (chunk j of this rank goes to rank
j of the group; the chunks received are laid out in the senders' order),
whose backward passes are the reference's transposes (psum_scatter <->
all_gather, all_to_all <-> all_to_all), and three sums.

Which sum gets which backward. A rank's gradient of a tensor is either
whole (every rank holds all of it) or partial (the ranks' gradients add
up to it). After a sum over the axis every rank holds the same value, and
what its gradient is depends on who consumes that value:
  `psum`: backward `psum`, the reference's transpose. For a sum whose
    consumer each rank does only a part of, so that each rank's incoming
    gradient is partial: `moe_sharded`'s router logits, a norm's sum of
    squares over a dimension cut over the axis (each rank scales only its
    own block).
  `psum_replicated`: backward the identity. For a sum whose consumer
    every rank repeats whole: a replicated residual stream after a
    row-parallel product, the loss's sums over a vocabulary cut over the
    axis. Each rank's incoming gradient is already whole; `psum` there
    would make it the axis size times too large.
  `replicated_copy`: forward the identity (no collective), backward
    `psum`. For a replicated tensor entering work each rank does only a
    part of (a column-parallel product on a replicated residual): each
    rank's gradient is partial, and the sum makes it whole.
  `pmax`: the maximum, outside autograd (the logsumexp's shift, whose
    gradient is zero).
Every call, forward or backward, adds one to its kind's count and its
input's bytes to the kind's bytes (`counts`, `reset_counts`; the sums and
the maximum count as "all_reduce"), so that a run can show which
collectives its path ran. `payloads` gives the same calls in the
reference dry-run's convention (`repro.launch.hlo_stats`): its kind
names, and a call's payload its output's size, an all-reduce's twice
(an all-gather's output is its input times the group's size, a
reduce-scatter's its input over it).
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_to_all", "compressed_pod_psum", "counts",
           "hierarchical_psum", "int8_decode", "int8_encode", "payloads",
           "pmax", "psum",
           "psum_replicated", "psum_scatter", "replicated_copy",
           "reset_counts"]

_COUNTS: dict = {}
_PAYLOADS: dict = {}
# the reference's kind names, and each kind's payload over its input's
# bytes for a group of n ranks
_REF_KIND = {"all_reduce": ("all-reduce", lambda n: 2.0),
             "all_gather": ("all-gather", lambda n: float(n)),
             "reduce_scatter": ("reduce-scatter", lambda n: 1.0 / n),
             "all_to_all": ("all-to-all", lambda n: 1.0)}


def reset_counts() -> None:
    _COUNTS.clear()
    _PAYLOADS.clear()


def counts() -> dict:
    """{kind: {"calls": n, "bytes": b}} since the last `reset_counts`."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def payloads() -> dict:
    """{reference kind: bytes, ..., "count": calls} since the last
    `reset_counts`, in the reference dry-run's convention (module
    docstring)."""
    out = {k: 0.0 for k, _ in _REF_KIND.values()}
    out.update(_PAYLOADS)
    out["count"] = sum(c["calls"] for c in _COUNTS.values())
    return out


def _count(kind: str, t: torch.Tensor, group) -> None:
    c = _COUNTS.setdefault(kind, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    nbytes = t.numel() * t.element_size()
    c["bytes"] += nbytes
    ref, factor = _REF_KIND[kind]
    _PAYLOADS[ref] = _PAYLOADS.get(ref, 0.0) + nbytes * factor(
        dist.get_world_size(group))


def int8_encode(x: torch.Tensor):
    """(q int8, absmax float32 scalar): x / absmax * 127 rounded half to
    even (as `jnp.round`) and clipped to +-127; absmax = max |x| + 1e-12,
    in float32."""
    absmax = torch.max(torch.abs(x.float())) + 1e-12
    q = torch.clamp(torch.round(x.float() / absmax * 127.0), -127, 127)
    return q.to(torch.int8), absmax


def int8_decode(q: torch.Tensor, absmax: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * (absmax / 127.0)).to(dtype)


# ---------------------------------------------------------------------------
# the collectives on one group (counted; no autograd)
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    _count("all_reduce", x, group)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Rank i's block i of the sum along `dim`: x viewed as (..., n, size
    / n, ...) with the blocks moved first (one copy, none for dim 0), so
    that each rank's output is its block, contiguous."""
    _count("reduce_scatter", x, group)
    n = dist.get_world_size(group)
    dim = dim % x.ndim
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    blocks = x.reshape(*x.shape[:dim], n, x.shape[dim] // n,
                       *x.shape[dim + 1:])
    xt = blocks.movedim(dim, 0).contiguous()
    out = xt.new_empty(xt.shape[1:])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)   # renamed in 2.13
        dist.reduce_scatter_tensor(
            out, xt.reshape(n * out.shape[0], *out.shape[1:]), group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' blocks joined along `dim` in rank order: gathered as
    (n, *x.shape), then the rank axis moved beside `dim` and merged with
    it (one copy, none for dim 0)."""
    _count("all_gather", x, group)
    n = dist.get_world_size(group)
    dim = dim % x.ndim
    xt = x.contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)   # renamed in 2.13
        dist.all_gather_into_tensor(out, xt, group=group)
    out = out.reshape(n, *xt.shape).movedim(0, dim)
    return out.reshape(*out.shape[:dim], n * x.shape[dim],
                       *out.shape[dim + 2:]).contiguous()


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    _count("all_to_all", x, group)
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    xt = x.contiguous()
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _group(axes, mesh):
    if mesh is None:
        from .sharding import current_ctx

        mesh = current_ctx().mesh
    if mesh is None or not getattr(mesh, "distributed", False):
        raise RuntimeError("collectives run over a mesh that spans a process "
                           "group (launch.mesh.make_mesh, or parallel_ctx "
                           "with one)")
    return mesh.group(axes)


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The sum of x over the ranks along `axes`, on each of them."""
    return _Psum.apply(x, _group(axes, mesh))


def psum_replicated(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The sum of x over the ranks along `axes`, for a consumer every rank
    repeats whole: its backward is the identity."""
    return _PsumReplicated.apply(x, _group(axes, mesh))


def replicated_copy(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """x itself, entering work each rank along `axes` does a part of: its
    backward sums the ranks' partial gradients."""
    return _ReplicatedCopy.apply(x, _group(axes, mesh))


def pmax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The elementwise maximum over the ranks along `axes`, detached."""
    return _all_reduce(x.detach(), _group(axes, mesh), dist.ReduceOp.MAX)


def psum_scatter(x: torch.Tensor, axes, dim: int = 0, mesh=None) -> torch.Tensor:
    """The sum over `axes`, cut along `dim`: rank i keeps block i."""
    return _PsumScatter.apply(x, _group(axes, mesh), dim)


def all_gather(x: torch.Tensor, axes, dim: int = 0, mesh=None) -> torch.Tensor:
    """The ranks' blocks along `axes` joined along `dim`, in rank order."""
    return _AllGather.apply(x, _group(axes, mesh), dim)


def all_to_all(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """Block j of dim 0 sent to rank j along `axes`; the blocks received
    stacked on dim 0 in the senders' order."""
    return _AllToAll.apply(x, _group(axes, mesh))


def hierarchical_psum(x: torch.Tensor, pod_axis: str, inner_axis: str,
                      mesh=None) -> torch.Tensor:
    """psum over (pod, inner) with pod traffic 1/|inner| of the plain
    all-reduce's."""
    # phase 1: reduce-scatter within the pod (shards the tensor 1/N)
    shard = psum_scatter(x, inner_axis, 0, mesh)
    # phase 2: small all-reduce across pods
    shard = psum(shard, pod_axis, mesh)
    # phase 3: all-gather within the pod
    return all_gather(shard, inner_axis, 0, mesh)


def compressed_pod_psum(x: torch.Tensor, pod_axis: str, inner_axis: str,
                        mesh=None) -> torch.Tensor:
    """Hierarchical psum with int8-compressed cross-pod traffic."""
    shard = psum_scatter(x, inner_axis, 0, mesh)
    q, absmax = int8_encode(shard)
    # gather the int8 shards and scales across pods, decode, sum in order
    qs = all_gather(q[None], pod_axis, 0, mesh)              # (pods, ...)
    scales = all_gather(absmax.reshape(1), pod_axis, 0, mesh)  # (pods,)
    acc = int8_decode(qs[0], scales[0])
    for i in range(1, qs.shape[0]):
        acc = acc + int8_decode(qs[i], scales[i])
    return all_gather(acc.to(x.dtype), inner_axis, 0, mesh)
