"""Device meshes over a process group.

Port of `repro.launch.mesh`. A mesh is axis names and sizes
(`Mesh.shape`, name -> size, as `jax.sharding.Mesh.shape`). A mesh made
by `make_local_mesh` or `make_mesh` spans the initialized
`torch.distributed` process group, one rank a device: rank r sits at the
row-major coordinates of r over the axes (as `jax.make_mesh` lays out its
devices), and the mesh holds, for each axis and each tuple of axes that a
logical axis maps to (``("pod", "data")`` for ``dp`` and ``ep`` on a
two-pod mesh), the process group of the ranks that differ only along
those axes. A group's ranks are in row-major order over its axes, so its
rank i is the i-th block of a dimension cut over them, as in a
`PartitionSpec`. Without a process group a local mesh is one device;
`make_production_mesh` stays abstract (no devices, no groups): it
describes the layout that the specs are computed for.

`init_distributed` starts the process group: NCCL on ``cuda:LOCAL_RANK``
for the card, gloo only when the caller passes ``device="cpu"``; from
torchrun's environment, or from an explicit rank, world size and
``init_method`` (a ``file://`` or ``tcp://localhost`` address). Nothing
falls back from NCCL to gloo.

`census_mesh` stands in for a production mesh in one process: rank 0 of
its 256 or 512 ranks on torch's fake process group, whose collectives
move nothing, for the census (`launch.dryrun`) to run a step on meta
tensors with every collective and every rank's block as rank 0 sees them.

Defined as functions, so importing this module touches no device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "census_mesh", "init_distributed", "make_local_mesh",
           "make_mesh", "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    sizes: tuple
    devices: tuple = ()      # empty for an abstract mesh
    coords: tuple = ()       # this rank's coordinate on each axis
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     hash=False, repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans a process group (of any size)."""
        return bool(self.groups)

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        """The number of ranks along `axes` (a name or a tuple of names)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along `axes`: its coordinates on them read
        row-major, its rank in `group(axes)`."""
        idx = 0
        for a in self._axes(axes):
            i = self.axis_names.index(a)
            idx = idx * self.sizes[i] + self.coords[i]
        return idx

    def group(self, axes):
        """The process group of the ranks that share this rank's
        coordinates off `axes`."""
        key = self._axes(axes)
        if key not in self.groups:
            raise KeyError(f"the mesh holds no group for axes {key}; it "
                           f"has {sorted(self.groups)}")
        return self.groups[key]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips), as the
    reference's; abstract (no devices): it describes the layout the specs
    are computed for."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def init_distributed(device: str | torch.device = "cuda", rank: int | None = None,
                     world: int | None = None, init_method: str | None = None,
                     local_rank: int | None = None) -> torch.device:
    """Start the default process group and return this rank's device.

    ``device="cuda"``: NCCL, on ``cuda:local_rank`` (set as the current
    device). ``device="cpu"``: gloo. Rank and world size come from the
    arguments, else from torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``
    (``init_method`` then defaults to ``env://``). An already initialized
    group is kept as it is."""
    dev = resolve_device(device)
    if rank is None:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank} needs card "
                               f"{local_rank}; torch sees "
                               f"{torch.cuda.device_count()}")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, rank=rank,
                                world_size=world)
    return dev


def _group_keys(names: tuple) -> list:
    """Each axis, and each tuple of axes a logical axis maps to (the
    data-parallel axes of `default_rules`), then all the axes."""
    keys = [(a,) for a in names]
    dp = tuple(a for a in ("pod", "data") if a in names)
    for key in (dp, names):
        if len(key) > 1 and key not in keys:
            keys.append(key)
    return keys


def make_mesh(sizes: tuple, axis_names: tuple,
              device: str | torch.device = "cuda") -> Mesh:
    """A mesh of `sizes` over `axis_names` spanning the initialized process
    group, whose size must be their product. Every rank makes every group,
    in the same order (`torch.distributed.new_group` asks that of all
    ranks)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh spans a process group: call "
                           "init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes, axis_names = tuple(sizes), tuple(axis_names)
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(axis_names, sizes))} needs "
                         f"{math.prod(sizes)} ranks; the process group has "
                         f"{world}")
    coords = tuple(_unravel(rank, sizes))
    groups = {}
    for key in _group_keys(axis_names):
        on = [axis_names.index(a) for a in key]
        off = [i for i in range(len(sizes)) if i not in on]
        for fixed in itertools.product(*(range(sizes[i]) for i in off)):
            ranks = []
            for moving in itertools.product(*(range(sizes[i]) for i in on)):
                c = [0] * len(sizes)
                for i, v in zip(off, fixed):
                    c[i] = v
                for i, v in zip(on, moving):
                    c[i] = v
                ranks.append(_ravel(c, sizes))
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[key] = g
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(axis_names, sizes, (dev,), coords, groups)


def _unravel(r: int, sizes: tuple) -> list:
    out = []
    for s in reversed(sizes):
        out.append(r % s)
        r //= s
    return out[::-1]


def _ravel(coords, sizes) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def make_local_mesh(data: int = 1, model: int = 1,
                    device: str | torch.device = "cuda") -> Mesh:
    """A (data, model) mesh. With a process group initialized it spans the
    group (`make_mesh`), whose size must be data x model; without one it is
    a mesh of one device of `device`'s type and raises if it asks for
    more."""
    dev = resolve_device(device)
    if data < 1 or model < 1:
        raise ValueError(f"mesh {data} x {model}")
    if dist.is_initialized():
        return make_mesh((data, model), ("data", "model"), dev)
    n = data * model
    if n > 1:
        raise ValueError(f"mesh {data} x {model} needs {n} ranks; torch sees "
                         "one process and no process group (init_distributed, "
                         "or run under torchrun)")
    return Mesh(("data", "model"), (data, model), (dev,))


@contextlib.contextmanager
def census_mesh(sizes: tuple, axis_names: tuple):
    """A mesh of `sizes` over `axis_names` as rank 0 of its world sees it,
    in this process alone: torch's fake process group of that many ranks
    (``torch.testing._internal.distributed.fake_pg``: every collective
    returns at once and moves nothing) with `make_mesh`'s groups over it.
    The group is torn down on exit: left initialized, it would stand in
    for every later `torch.distributed` user of the process. Refuses to
    run beside a real process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("census_mesh needs a process without a process "
                           "group")
    dist.init_process_group("fake", rank=0, world_size=math.prod(sizes),
                            store=FakeStore())
    try:
        yield make_mesh(tuple(sizes), tuple(axis_names), "cpu")
    finally:
        dist.destroy_process_group()
