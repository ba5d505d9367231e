"""Carry a trained forest across to the port.

`forest_from_numpy` takes the arrays of a reference `DenseForest` (or any
forest in the dense level-order layout) and builds the port's
`DenseForest`, checking shapes, dtypes and feature ids on the way in.
`forest_tables` makes the forest's device tensors; `build_pipeline` calls
it once per pipeline, so no call on the serving path copies the forest.
`multi_forest_tables` does the same for a multi-tenant fleet: the tenants'
forests stacked for the kernel B4, with its per-tenant spec table.

`lm_params_from_numpy` loads a reference LM's parameter pytree (nested
dicts of numpy arrays, layers stacked on a leading axis) into the port's
`repro_torch.models.zoo.LM`, and `lm_cache_from_numpy` a reference decode
cache, checking every key, shape and dtype on the way in.
`train_state_from_numpy` carries a reference train state (parameters,
then AdamW's m, v and step) into the port's, so that both packages can
start training from the same state; `train_state_shard_from_numpy` cuts
it to one rank's blocks over a process-group mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.forest import DenseForest
from .device import resolve_device

__all__ = ["forest_from_numpy", "forest_tables", "lm_cache_from_numpy",
           "lm_params_from_numpy", "multi_forest_tables",
           "train_state_from_numpy", "train_state_shard_from_numpy"]


def forest_from_numpy(feature, threshold, leaf, depth: int, n_features: int,
                      classes=None) -> DenseForest:
    """The port's `DenseForest` from dense level-order arrays:
    feature (T, 2**depth - 1) int, threshold (T, 2**depth - 1) float,
    leaf (T, 2**depth, K) float, each feature id in [0, n_features)."""
    feature = np.ascontiguousarray(feature, np.int32)
    threshold = np.ascontiguousarray(threshold, np.float32)
    leaf = np.ascontiguousarray(leaf, np.float32)
    depth, n_features = int(depth), int(n_features)
    ni = 2 ** depth - 1
    T = feature.shape[0] if feature.ndim == 2 else 0
    if (T < 1 or feature.shape != (T, ni) or threshold.shape != (T, ni)
            or leaf.ndim != 3 or leaf.shape[:2] != (T, ni + 1)):
        raise ValueError(
            f"shapes feature {feature.shape}, threshold {threshold.shape}, "
            f"leaf {leaf.shape} do not form a depth-{depth} dense forest")
    if feature.size and not (0 <= feature.min() and feature.max() < n_features):
        raise ValueError(f"feature ids outside [0, {n_features})")
    return DenseForest(
        feature=feature, threshold=threshold, leaf=leaf, depth=depth,
        n_features=n_features,
        classes=None if classes is None else np.asarray(classes))


def forest_tables(forest: DenseForest, device: str | torch.device = "cuda"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(feature int32, threshold float32, leaf float32) tensors on `device`,
    after checking that every feature id indexes a column of the input."""
    checked = forest_from_numpy(forest.feature, forest.threshold, forest.leaf,
                                forest.depth, forest.n_features)
    dev = resolve_device(device)
    return (torch.from_numpy(checked.feature).to(dev),
            torch.from_numpy(checked.threshold).to(dev),
            torch.from_numpy(checked.leaf).to(dev))


def multi_forest_tables(forests, tenant_cols, device: str | torch.device = "cuda"):
    """The stacked tables of N tenants' forests on `device`, for B4.

    Checks each forest as `forest_tables` does (against its own plan's
    width, ``len(tenant_cols[t])``), stacks them with
    `repro_torch.kernels.fused_pipeline.stack_multi_forests` and returns
    ``(feature, threshold, leaf, spec, rescale, tenants)``: the stacked
    int32/float32/float32 tables, the int32 (N, 7) spec table (tree offset,
    trees, padded trees, depth, tree block, classes, lane offset, as
    `SPEC_FIELDS` names them), the float32 (N,) rescales, all on `device`,
    and the reference's static per-tenant spec tuple."""
    from .kernels.fused_pipeline import SPEC_FIELDS, stack_multi_forests
    from .kernels.tree_infer import MAX_CLASSES, MAX_DEPTH

    forests = [forest_from_numpy(f.feature, f.threshold, f.leaf, f.depth,
                                 len(cols))
               for f, cols in zip(forests, tenant_cols)]
    for f in forests:
        if f.depth > MAX_DEPTH or f.n_out > MAX_CLASSES:
            raise ValueError(f"forest of depth {f.depth} with {f.n_out} "
                             f"classes: the kernels take depth <= {MAX_DEPTH}"
                             f" and <= {MAX_CLASSES} classes")
    feature, threshold, leaf, tenants = stack_multi_forests(forests,
                                                            tenant_cols)
    rows, lane = [], 0
    for f, (off, tp, fd, bt, _, _, k, _) in zip(forests, tenants):
        rows.append((off, f.n_trees, tp, fd, bt, k, lane))
        lane += k
    dev = resolve_device(device)
    spec = torch.tensor(rows, dtype=torch.int32).reshape(-1, len(SPEC_FIELDS))
    rescale = torch.tensor([t[7] for t in tenants], dtype=torch.float32)
    return (feature.to(dev), threshold.to(dev), leaf.to(dev), spec.to(dev),
            rescale.to(dev), tenants)


def _tensor(a, name: str, like: torch.Tensor) -> torch.Tensor:
    """A copy of numpy array `a` as a tensor of `like`'s shape, dtype and
    device; raises on any mismatch. bfloat16 arrays (ml_dtypes) go across
    by their bits."""
    a = np.asarray(a)
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"{name}: shape {a.shape}, expected "
                         f"{tuple(like.shape)}")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16)).view(
            torch.bfloat16)
    elif a.dtype.name in ("float32", "int32"):
        t = torch.from_numpy(np.array(a, copy=True))
    else:
        t = None
    if t is None or t.dtype != like.dtype:
        raise TypeError(f"{name}: dtype {a.dtype}, expected {like.dtype}")
    return t.to(like.device)


def _load_module(module: torch.nn.Module, tree: dict, name: str) -> None:
    """Copy `tree` into `module`, key for attribute. A `ModuleList` takes a
    subtree whose arrays are stacked on a leading layer axis."""
    if not isinstance(tree, dict):
        raise TypeError(f"{name}: expected a dict, got {type(tree).__name__}")
    params = dict(module.named_parameters(recurse=False))
    children = dict(module.named_children())
    if set(tree) != set(params) | set(children):
        raise ValueError(f"{name}: keys {sorted(tree)}, expected "
                         f"{sorted(set(params) | set(children))}")
    for key, value in tree.items():
        path = f"{name}.{key}" if name else key
        if key in params:
            params[key].copy_(_tensor(value, path, params[key]))
        elif isinstance(children[key], torch.nn.ModuleList):
            layers = children[key]
            for i, layer in enumerate(layers):
                _load_module(layer, _layer(value, i, len(layers), path),
                             f"{path}[{i}]")
        else:
            _load_module(children[key], value, path)


def _layer(tree, i: int, n: int, name: str):
    """Layer i of a pytree stacked on a leading axis of length n."""
    if isinstance(tree, dict):
        return {k: _layer(v, i, n, f"{name}.{k}") for k, v in tree.items()}
    a = np.asarray(tree)
    if a.ndim == 0 or a.shape[0] != n:
        raise ValueError(f"{name}: leading axis {a.shape[:1]}, expected {n} "
                         "stacked layers")
    return a[i]


def lm_params_from_numpy(tree: dict, cfg, device: str | torch.device = "cuda"):
    """The port's LM of `cfg` on `device`, loaded from the reference's
    parameter pytree (`repro.models.init_params`, converted leaf by leaf to
    numpy). Every key, shape and dtype is checked against the port's
    modules."""
    from .models.zoo import LM

    dev = resolve_device(device)
    model = LM(cfg, dev)
    with torch.no_grad():
        _load_module(model, tree, "")
    return model


def lm_cache_from_numpy(tree: dict, cfg, device: str | torch.device = "cuda"
                        ) -> dict:
    """The port's decode cache on `device` from the reference's
    (`repro.models.init_cache` or a `decode_step` result, as numpy), with
    every key, shape and dtype checked against `init_cache`'s."""
    from .models.zoo import init_cache

    # the cache's length: its KV's (the xLSTM cache has none: any length)
    kv = tree.get("k", tree.get("attn_k"))
    max_len = 1 if kv is None else int(np.shape(kv)[2])
    want = init_cache(cfg, int(np.shape(tree["pos"])[0]), max_len, device)
    if set(tree) != set(want):
        raise ValueError(f"cache keys {sorted(tree)}, expected {sorted(want)}")
    return {k: _tensor(v, k, want[k]) for k, v in tree.items()}


def train_state_from_numpy(tree: dict, cfg, device: str | torch.device = "cuda"
                           ) -> dict:
    """The port's train state (`repro_torch.train.init_state`'s layout) on
    `device` from the reference's ({"params": pytree, "opt": {"m": pytree,
    "v": pytree, "step": scalar}}, as numpy): the parameters loaded by
    `lm_params_from_numpy` with gradients on, the float32 moments keyed by
    parameter name, the step an int32 scalar."""
    import dataclasses

    from .models.zoo import LM

    dev = resolve_device(device)
    params = lm_params_from_numpy(tree["params"], cfg, dev)
    params.requires_grad_(True)
    opt = tree["opt"]
    moments = {}
    for key in ("m", "v"):
        holder = LM(dataclasses.replace(cfg, dtype="float32"), dev)
        with torch.no_grad():
            _load_module(holder, opt[key], key)
        moments[key] = {n: p.detach() for n, p in holder.named_parameters()}
    step = np.asarray(opt["step"])
    if step.shape != () or step.dtype != np.int32:
        raise TypeError(f"opt.step: {step.dtype} {step.shape}, expected an "
                        "int32 scalar")
    return {"params": params,
            "opt": {"m": moments["m"], "v": moments["v"],
                    "step": torch.tensor(int(step), dtype=torch.int32,
                                         device=dev)}}


def train_state_shard_from_numpy(tree: dict, cfg, mesh,
                                 device: str | torch.device = "cuda") -> dict:
    """This rank's blocks of a reference train state on `mesh` (a mesh over
    a process group): `train_state_from_numpy`'s full state on `device`,
    then cut as `repro_torch.train.init_state` cuts its own (parameters by
    their specs, moments by ZeRO-1's), with its placement."""
    from .train.train_step import shard_state

    return shard_state(train_state_from_numpy(tree, cfg, device), mesh, cfg)
