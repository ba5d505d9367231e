"""Device meshes.

Port of `repro.launch.mesh`. A mesh is axis names and sizes
(`Mesh.shape`, name -> size, as `jax.sharding.Mesh.shape`), and for a
local mesh the torch devices it spans. Defined as functions, so importing
this module touches no device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device

__all__ = ["Mesh", "make_local_mesh", "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    sizes: tuple
    devices: tuple = ()      # empty for an abstract mesh

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips), as the
    reference's; abstract (no devices): it describes the layout the specs
    are computed for."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1,
                    device: str | torch.device = "cuda") -> Mesh:
    """A (data, model) mesh over the devices of `device`'s type that torch
    sees (the CUDA cards, or the one CPU); raises if it asks for more."""
    dev = resolve_device(device)
    n = data * model
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    if data < 1 or model < 1 or n > have:
        raise ValueError(f"mesh {data} x {model} needs {n} {dev.type} "
                         f"devices; torch sees {have}")
    if dev.type == "cuda":
        devices = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devices = (torch.device("cpu"),)
    return Mesh(("data", "model"), (data, model), devices)
