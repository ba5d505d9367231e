"""The benchmark's weights: every leaf of a model drawn on the device from
the seed, in a few large calls, in the type it is served in.

`leaf_specs` lists a model's leaves (name, shape, type, how drawn) from
its configuration's sizes, in the port's names, as the leaf list of its
family (``leaves/<family>.py``) gives them; `draw` makes them: the leaves
drawn from a normal distribution are views of one buffer per type, filled
by one call of a `torch.Generator` seeded from ``--seed``, then scaled as
the reference initialises them; the constant leaves (norms) are filled.
`bind` hands the same tensors to the port's model, which is built on the
meta device and so never allocates weights of its own. The reference is
handed the same leaves, or, where the program has changed them in place
(training), the same draw again."""
from __future__ import annotations

import importlib
import math

import torch

from .harness import subseed

__all__ = ["bind", "draw", "leaf_specs", "program_model"]

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_ALIGN = 128          # elements: every view starts 256-byte aligned


def leaf_specs(model: dict) -> list:
    """[(name, shape, dtype, (how, value))] of a model of `model` (a
    configuration file's ``model``), from the leaf list of its family
    (``leaves/<family>.py``, found by the family's name)."""
    fam = importlib.import_module(f"perfbench.leaves.{model['family']}")
    return fam.leaves(model, _DT[model["dtype"]])


def draw(model: dict, seed: int, device) -> dict:
    """{name: tensor} of every leaf, drawn from `seed` on `device`: one
    normal draw per type into one buffer, of which the leaves are views."""
    specs = leaf_specs(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, "weights"))
    leaves: dict = {}
    for dtype in sorted({s[2] for s in specs if s[3][0] == "normal"},
                        key=str):
        group = [s for s in specs if s[2] == dtype and s[3][0] == "normal"]
        sizes = [-(-math.prod(s[1]) // _ALIGN) * _ALIGN for s in group]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        flat.normal_(generator=gen)
        at = 0
        for (name, shape, _, (_, scale)), n in zip(group, sizes):
            view = flat[at:at + math.prod(shape)].view(shape)
            leaves[name] = view.mul_(scale)
            at += n
    for name, shape, dtype, (how, value) in specs:
        if how == "const":
            leaves[name] = torch.full(shape, value, dtype=dtype, device=device)
    return {name: leaves[name] for name, *_ in specs}


def bind(module: torch.nn.Module, leaves: dict) -> torch.nn.Module:
    """Make `leaves` the parameters of `module` (gradients off), after
    checking that they are its parameters, name for name, in shape and
    type."""
    have = {n: (tuple(p.shape), p.dtype) for n, p in module.named_parameters()}
    want = {n: (tuple(t.shape), t.dtype) for n, t in leaves.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:6]
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's leaves: {diff}")
    for name, t in leaves.items():
        owner, _, attr = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        sub._parameters[attr] = torch.nn.Parameter(t, requires_grad=False)
    return module


def program_model(cfg, leaves: dict) -> torch.nn.Module:
    """The port's model of `cfg` (a `ModelConfig`) built on the meta device
    and bound to `leaves`."""
    from repro_torch.models.zoo import LM

    return bind(LM(cfg, torch.device("meta")), leaves)
