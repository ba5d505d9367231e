"""The census: every (arch x shape) cell on the production meshes, counted
on meta tensors, with no card.

Port of `repro.launch.dryrun`, which lowers and compiles each cell for
512 placeholder devices and reads the compiled program's cost and memory
analyses. The port has no compile step. It builds the same cells
(`launch.specs.build_cell`: train, prefill or decode) and runs each step
once as rank 0 of the 256-rank (16 x 16) or 512-rank (2 x 16 x 16) mesh
sees it (`launch.mesh.census_mesh`: torch's fake process group, whose
collectives move nothing), on meta tensors cut to rank 0's blocks by the
cell's specs: nothing is computed, and every op, kernel and collective
of the step is counted (`launch.step_stats`). It is an analysis of the
step's shapes, not an entry point that computes on data.

The reference compiles its production artifact with the layers scanned,
so it also compiles 1- and 2-layer-unit probes and extrapolates ``f(1) +
(units - 1)(f(2) - f(1))``. The port's Python loop runs every layer, so
nothing is extrapolated and there are no probes; `layer_units` stays, and
the census tests hold that identity on the port's counts.

Each record keeps the reference's keys. ``main`` holds ``flops``,
``bytes_accessed``, ``bytes_hbm``, ``n_dots``, ``collectives`` (the
reference's kind names and convention, per rank) and ``memory``:
``argument_size_in_bytes``, exact from the local shapes of rank 0's
parameters, optimizer state, batch or cache; ``output_size_in_bytes``,
the tensors the step returns; ``temp_size_in_bytes``, the peak of live
bytes the step allocates above its arguments (`step_stats`: MemTracker on
the meta tensors). ``census_s`` replaces the reference's ``lower_s`` and
``compile_s``; ``kernels`` lists the hand-written kernels' calls and
closed-form costs; ``fits_h100`` says whether arguments and temporaries
fit one H100's 80 GB. Records go to ``results/dryrun_torch/``, one JSON
file a cell, reused unless ``--force``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch qwen3-8b]
        [--shape decode_32k] [--multi-pod] [--tag base] [--force]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
H100_BYTES = 80 * 10 ** 9
COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")
_META = torch.device("meta")

__all__ = ["RESULTS", "layer_units", "local_inputs", "main", "measure",
           "probe_cfg", "run_cell"]


def layer_units(cfg) -> float:
    if cfg.family == "ssm":
        return cfg.n_layers / 2          # pairs
    if cfg.family == "hybrid":
        return cfg.n_layers / cfg.shared_attn_every
    return float(cfg.n_layers)           # audio: enc+dec shrink together


def probe_cfg(cfg, n_units: int):
    """`cfg` cut to `n_units` layer units, as the reference's probes (the
    census tests check the extrapolation identity with it)."""
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=n_units,
                                   encoder_layers=n_units)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, n_layers=2 * n_units)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=n_units * cfg.shared_attn_every)
    return dataclasses.replace(cfg, n_layers=n_units)


def _local(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    from ..parallel.sharding import local_shape

    return torch.empty(local_shape(tuple(t.shape), tuple(spec), mesh),
                       dtype=t.dtype, device=_META)


def local_inputs(cell, cfg, mesh):
    """Rank 0's blocks of the cell's inputs, as meta tensors: the
    parameters cut by their specs (a train cell's with gradients on, and
    its AdamW state cut by ZeRO-1's with its placement), the batch, cache
    and tokens by theirs."""
    from ..train.optimizer import make_placement

    params = cell.abstract[0]["params"] if cell.mode == "train" \
        else cell.abstract[0]
    p_specs = cell.specs[0]["params"] if cell.mode == "train" \
        else cell.specs[0]
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.data = _local(p, p_specs[name], mesh)
    if cell.mode == "train":
        from ..train import AdamW

        params.requires_grad_(True)
        opt = AdamW()
        pl = make_placement(shapes, mesh, cfg)
        state = {"params": params, "opt": opt.init(params, pl),
                 "placement": pl}
        batch = {k: _local(v, cell.specs[1][k], mesh)
                 for k, v in cell.abstract[1].items()}
        return (state, batch)
    if cell.mode == "prefill":
        return (params, {k: _local(v, cell.specs[1][k], mesh)
                         for k, v in cell.abstract[1].items()})
    cache = {k: _local(v, cell.specs[1][k], mesh)
             for k, v in cell.abstract[1].items()}
    return (params, cache, _local(cell.abstract[2], cell.specs[2], mesh))


def measure(cfg, shape, mesh, microbatches: int = 1) -> dict:
    """One cell on `mesh` (a census mesh): its counts and memory."""
    from .specs import build_cell
    from .step_stats import step_stats, tensor_bytes

    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh, microbatches=microbatches,
                      device="meta")
    args = local_inputs(cell, cfg, mesh)
    arg_bytes = tensor_bytes(args)
    st = step_stats(cell.fn, *args)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": st["output_bytes"],
           "temp_size_in_bytes": st["peak_bytes"]}
    return {
        "mode": cell.mode,
        "census_s": round(time.perf_counter() - t0, 2),
        "flops": st["flops"],
        "bytes_accessed": st["bytes"],
        "bytes_hbm": st["bytes_hbm"],
        "n_dots": st["n_dots"],
        "collectives": {k: float(st["collectives"].get(k, 0.0))
                        for k in (*COLL_KINDS, "count")},
        "kernels": st["kernels"],
        "memory": mem,
        "fits_h100": arg_bytes + st["peak_bytes"] <= H100_BYTES,
    }


def _mesh_of(multi_pod: bool):
    from .mesh import make_production_mesh

    prod = make_production_mesh(multi_pod=multi_pod)
    return prod.sizes, prod.axis_names


def run_cell(arch: str, shape_name: str, multi_pod: bool, tag: str = "base",
             microbatches: int = 1, zero1: bool = True, force: bool = False,
             overrides: dict | None = None, results=None):
    """The census record of one cell, written to (and, unless `force`,
    read back from) ``results/dryrun_torch/``; `results` another
    directory, or False to write nothing. The port trains over a mesh
    with ZeRO-1 always (`train.optimizer.make_placement`); `zero1` is
    kept in the record, as the reference's key, and there is no flag for
    it."""
    from .. import configs
    from ..models.config import SHAPES
    from .mesh import census_mesh
    from .specs import skip_reason

    mesh_tag = "multipod" if multi_pod else "pod"
    out_dir = RESULTS if results is None else results
    out_path = None
    if out_dir is not False:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        out_path = out_dir / f"{arch}__{shape_name}__{mesh_tag}__{tag}.json"
        if out_path.exists() and not force:
            rec = json.loads(out_path.read_text())
            if rec.get("status") in ("ok", "skipped"):
                print(f"[census] cached: {out_path.name}")
                return rec

    cfg = configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag, "tag": tag,
        "overrides": overrides or {},
        "microbatches": microbatches, "zero1": zero1, "family": cfg.family,
        "params_total": cfg.total_params, "params_active": cfg.active_params,
    }
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", skip_reason=reason)
        print(f"[census] SKIP {arch} {shape_name} ({mesh_tag}): {reason}")
    else:
        sizes, names = _mesh_of(multi_pod)
        rec["n_devices"] = math.prod(sizes)
        try:
            with census_mesh(sizes, names) as mesh:
                main = measure(cfg, shape, mesh, microbatches)
            rec.update(status="ok", main=main, mode=main["mode"])
            m = main["memory"]
            print(f"[census] OK {arch} {shape_name} ({mesh_tag},{tag}) "
                  f"mode={main['mode']} {main['census_s']:.1f}s "
                  f"flops/dev={main['flops']:.3g} "
                  f"args={m['argument_size_in_bytes'] / 1e9:.2f}GB "
                  f"temp={m['temp_size_in_bytes'] / 1e9:.2f}GB "
                  f"coll_ops={main['collectives']['count']:.0f}")
        except Exception as e:
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"[:2000]
            rec["traceback"] = traceback.format_exc()[-4000:]
            print(f"[census] FAIL {arch} {shape_name} ({mesh_tag}): "
                  f"{type(e).__name__}: {str(e)[:300]}")
    if out_path is not None:
        out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tag", default="base")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--residual", default=None, choices=("tp", "replicated"))
    ap.add_argument("--remat", default=None, choices=("none", "block", "dots"))
    ap.add_argument("--pad-heads", type=int, default=None)
    args = ap.parse_args(argv)
    overrides = {}
    if args.residual:
        overrides["residual"] = args.residual
    if args.remat:
        overrides["remat"] = args.remat
    if args.pad_heads is not None:
        overrides["n_heads_padded"] = args.pad_heads

    from .. import configs
    from ..models.config import SHAPES

    archs = [args.arch] if args.arch else list(configs.all_arch_ids())
    shapes = [args.shape] if args.shape else list(SHAPES)
    n_fail = 0
    for a in archs:
        for s in shapes:
            rec = run_cell(a, s, args.multi_pod, tag=args.tag,
                           microbatches=args.microbatches, force=args.force,
                           overrides=overrides or None)
            n_fail += rec.get("status") == "error"
    print(f"[census] done, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
