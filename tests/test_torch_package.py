"""The port stands alone: `repro_torch` imports without jax, imports nothing
of `repro`, runs on the card by default and never quietly on the CPU."""
import ast
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.forest import train_forest
from repro_torch.core.search_space import FeatureRep
from repro_torch.kernels import ops
from repro_torch.kernels.fused_pipeline import (
    fused_multi_forest_call,
    fused_multi_forest_infer,
)
from repro_torch.kernels.decode_attention import decode_attention_kernel_call
from repro_torch.kernels.feature_extract import flow_stats_kernel_call
from repro_torch.kernels.flash_attention import flash_attention_kernel_call
from repro_torch.kernels.mamba_scan import mamba_scan_kernel_call
from repro_torch.kernels.tree_infer import forest_infer_kernel_call
from repro_torch.models import init_cache, init_params
from repro_torch.serve import make_prefill, make_serve_step
from repro_torch.traffic.extraction import extract_features
from repro_torch.traffic.multi_tenant import build_multi_tenant_pipeline
from repro_torch.traffic.pipeline import build_pipeline
from repro_torch.traffic.profiler import TrafficProfiler
from repro_torch.traffic.synth import make_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
# the port's example drives
DRIVES = sorted((ROOT / "examples_torch").glob("*.py"))


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


# modules the scans below must cover (every module of the package is scanned)
SLICE_MODULES = (
    "repro_torch.traffic.pipeline",
    "repro_torch.traffic.multi_tenant",
    "repro_torch.traffic.profiler",
    "repro_torch.traffic.backends",
    "repro_torch.core.acquisition",
    "repro_torch.core.baselines",
    "repro_torch.core.evaluator",
    "repro_torch.core.mutual_info",
    "repro_torch.core.optimizer",
    "repro_torch.core.pareto",
    "repro_torch.core.priors",
    "repro_torch.core.surrogate",
    "repro_torch.core.tuner",
    "repro_torch.configs.qwen3_8b",
    "repro_torch.configs.zamba2_1_2b",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.decode_attention",
    "repro_torch.kernels.mamba_scan",
    "repro_torch.models.config",
    "repro_torch.models.layers",
    "repro_torch.models.transformer",
    "repro_torch.models.ssm",
    "repro_torch.models.zoo",
    "repro_torch.serve.serve_step",
    "repro_torch.kernels.feature_extract",
    "repro_torch.serve.deploy",
    "repro_torch.serve.session",
    "repro_torch.serve.control.plane",
    "repro_torch.serve.control.planner",
    "repro_torch.serve.control.reoptimizer",
    "repro_torch.serve.control.replay",
    "repro_torch.serve.control.telemetry",
    "repro_torch.serve.obs.audit",
    "repro_torch.serve.obs.drift",
    "repro_torch.serve.obs.export",
    "repro_torch.serve.obs.slo",
    "repro_torch.train.checkpoint",
    "repro_torch.train.data",
    "repro_torch.train.elastic",
    "repro_torch.train.optimizer",
    "repro_torch.train.train_step",
    "repro_torch.parallel.sharding",
    "repro_torch.parallel.collectives",
    "repro_torch.launch.mesh",
    "repro_torch.launch.specs",
    "repro_torch.launch.train",
)


def test_imports_with_jax_blocked():
    mods = _modules()
    assert set(SLICE_MODULES) <= set(mods)
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_import_scan_covers_the_slice():
    scanned = {str(p.relative_to(PKG.parent).with_suffix("")).replace("/", ".")
               for p in PKG.rglob("*.py")}
    assert set(SLICE_MODULES) <= scanned


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "tools").glob("*.py"))
                         + DRIVES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    roots = set(_imported_roots(path))
    # `repro_torch` is a root of its own and must not match `repro`
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset("app-class", n_flows=20, max_pkts=8, seed=3)
    rep = FeatureRep(("dur", "s_bytes_mean"), depth=4)
    X = extract_features(ds, rep.features, rep.depth, device="cpu")
    forest = train_forest(X, ds.label, n_trees=2, max_depth=3,
                          rng=np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pipeline(rep, forest, ds.max_pkts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pipeline(rep, forest, ds.max_pkts, fused=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_features(ds, rep.features, rep.depth)
    for fused in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_multi_tenant_pipeline([rep, rep], [forest, forest],
                                        fused=fused)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrafficProfiler(ds, rep.features)
    build_pipeline(rep, forest, ds.max_pkts, device="cpu")
    build_multi_tenant_pipeline([rep, rep], [forest, forest], fused=True,
                                device="cpu")
    TrafficProfiler(ds, rep.features, device="cpu")


def test_the_seven_drives_are_there():
    """Every drive of `examples/` has its port, `train_lm.py` included."""
    assert [p.stem for p in DRIVES] == sorted((
        "serve_stream", "quickstart", "optimize_app_class", "tune_serving",
        "tune_multitenant", "tune_lm_config", "serve_lm", "serve_control",
        "selftune_fleet", "train_lm"))
    assert {p.stem for p in DRIVES} >= {
        p.stem for p in (ROOT / "examples").glob("*.py")}


@pytest.mark.parametrize("path", DRIVES, ids=lambda p: p.stem)
def test_drives_default_to_the_card(path, monkeypatch):
    """Each drive's `--device` defaults to cuda: without a card its main
    raises before any work, and never moves to the CPU on its own."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"drive_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_kernel_wrappers_take_only_cuda_tensors():
    x = torch.zeros((4, 3))
    feature = torch.zeros((2, 3), dtype=torch.int32)
    threshold = torch.zeros((2, 3))
    leaf = torch.zeros((2, 4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        forest_infer_kernel_call(x, feature, threshold, leaf, 2)
    # the dispatcher sends CPU tensors to the plain version
    assert ops.forest_infer(x, feature, threshold, leaf, 2).shape == (4, 5)

    # B4: one tenant of one depth-1 tree, a 3-column merged plan
    N, P, K = 2, 4, 2
    f32, u8 = torch.zeros((N, P)), torch.zeros((N, P), dtype=torch.uint8)
    args = [f32, f32, u8, f32, f32, torch.zeros((N, P, 8), dtype=torch.uint8),
            torch.zeros(N, dtype=torch.int32), torch.zeros(N), torch.zeros(N),
            torch.zeros(N), torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1, 1)), torch.zeros((1, 2, K)),
            torch.tensor([[0, 1, 1, 1, 1, K, 0]], dtype=torch.int32),
            torch.ones(1)]
    kw = dict(op_table=torch.zeros((3, 5), dtype=torch.int32), depth=P,
              n_out=K)
    with pytest.raises(ValueError, match="CUDA"):
        fused_multi_forest_call(*args, **kw)
    assert fused_multi_forest_infer(*args, **kw).shape == (N, K)

    # B5
    v, m = torch.zeros((3, 5)), torch.ones((3, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        flow_stats_kernel_call(v, m)
    assert ops.flow_stats(v, m).shape == (3, 5)


def test_deploy_entry_points_default_to_the_card(monkeypatch):
    """Every deploy-layer function that builds a pipeline runs on the card
    unless asked for the CPU."""
    import importlib

    from repro_torch.serve.control import PipelineSwap

    deploy = importlib.import_module("repro_torch.serve.deploy")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset("app-class", n_flows=20, max_pkts=8, seed=3)
    rep = FeatureRep(("dur", "s_bytes_mean"), depth=4)
    X = extract_features(ds, rep.features, rep.depth, device="cpu")
    forest = train_forest(X, ds.label, n_trees=2, max_depth=3,
                          rng=np.random.default_rng(0))
    doc = deploy._forest_to_doc(forest)
    point = deploy.BundlePoint(rep=rep, cost=1.0, perf=0.5, fidelity="modeled",
                               aux={}, compile_meta={"fused": True},
                               forest_doc=doc)
    for make in (lambda **kw: point.build(warm=False, **kw),
                 lambda **kw: deploy.compile_multi_tenant([point, point],
                                                          warm=False, **kw),
                 lambda **kw: PipelineSwap.build(rep, forest,
                                                 warm_buckets=(8,), **kw),
                 lambda **kw: deploy.make_swap(
                     dataclasses.replace(point, pipeline=None), **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        make(device="cpu")


def test_lm_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import AdamW, init_state
    from repro_torch.train.data import SyntheticTokens, make_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shape = ShapeSpec("t", 8, 2, "train")
    for arch in ("qwen3-8b", "zamba2-1.2b"):
        cfg = configs.get_reduced(arch)
        for make in (lambda **kw: init_params(cfg, 0, **kw),
                     lambda **kw: init_cache(cfg, 2, 8, **kw),
                     lambda **kw: make_prefill(cfg, **kw),
                     lambda **kw: make_serve_step(cfg, **kw),
                     lambda **kw: init_state(cfg, 0, AdamW(), **kw),
                     lambda **kw: make_batch(cfg, shape, 0, **kw),
                     lambda **kw: next(iter(SyntheticTokens(cfg, shape, **kw))),
                     lambda **kw: make_local_mesh(1, 1, **kw)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
            make(device="cpu")


def test_lm_wrappers_refuse_what_they_cannot_take():
    """Each LM kernel wrapper checks head size, dtype, group size and
    shared memory before it checks the device: what the kernel cannot take
    raises the same on a CPU tensor as on a CUDA one, and a CPU tensor it
    could take raises for being on the CPU."""
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    with pytest.raises(ValueError, match="head dim 47"):       # odd
        flash_attention_kernel_call(t(1, 2, 8, 47), t(1, 1, 8, 47), t(1, 1, 8, 47))
    with pytest.raises(ValueError, match="CUDA"):   # 48 runs on 64-wide rows
        flash_attention_kernel_call(t(1, 2, 8, 48), t(1, 1, 8, 48), t(1, 1, 8, 48))
    with pytest.raises(TypeError, match="float16"):
        flash_attention_kernel_call(*(t(1, 2, 8, 64, dtype=torch.float16),) * 3)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention_kernel_call(t(1, 3, 8, 64), t(1, 2, 8, 64), t(1, 2, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel_call(t(1, 2, 8, 64), t(1, 1, 8, 64), t(1, 1, 8, 64))

    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 16"):
        decode_attention_kernel_call(t(1, 32, 64), t(1, 8, 1, 64), t(1, 8, 1, 64),
                                     lens)
    with pytest.raises(ValueError, match="head dim 130"):      # above 128
        decode_attention_kernel_call(t(1, 2, 130), t(1, 8, 1, 130),
                                     t(1, 8, 1, 130), lens)
    with pytest.raises(ValueError, match="CUDA"):   # 96 runs on 128-wide rows
        decode_attention_kernel_call(t(1, 2, 96), t(1, 8, 1, 96), t(1, 8, 1, 96),
                                     lens)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_kernel_call(t(1, 2, 64), t(1, 8, 1, 64), t(1, 8, 1, 64),
                                     lens)

    B, T, H = 1, 256, 2
    with pytest.raises(ValueError, match="shared memory"):   # S = 240, c = 128
        mamba_scan_kernel_call(t(B, T, H, 64), t(B, T, H), t(H), t(B, T, 240),
                               t(B, T, 240))
    for S in (64, 128):   # the chunk scan streams its strips: S = 128 fits
        with pytest.raises(ValueError, match="CUDA"):
            mamba_scan_kernel_call(t(B, T, H, 64), t(B, T, H), t(H),
                                   t(B, T, S), t(B, T, S))


@pytest.mark.parametrize("py_name,source,c_name", [
    ("MAX_MERGED_COLUMNS", "fused_multi.cu", "kMaxMergedColumns"),
    ("MAX_WINDOW", "plan_warp.cuh", "kChunk"),
    ("MAX_FEATURES", "fused_pipeline.cu", "kMaxFeatures"),
    ("MAX_CLASSES", "forest_common.cuh", "kMaxClasses")])
def test_wrapper_limits_are_the_sources(py_name, source, c_name):
    """The wrappers decide on the host what the kernels take (a merged plan
    past shared memory gets a `columns` buffer, a long window a scratch):
    their limits are the constants the CUDA sources were built with."""
    from repro_torch.kernels import fused_pipeline, tree_infer

    mod = tree_infer if py_name == "MAX_CLASSES" else fused_pipeline
    text = (PKG / "csrc" / source).read_text()
    m = re.search(rf"constexpr int {c_name} = (\d+);", text)
    assert m is not None and int(m.group(1)) == getattr(mod, py_name)


@pytest.mark.parametrize("module,py_name,source,c_name", [
    ("feature_extract", "GROUP", "flow_stats.cu", "kGroup"),
    ("feature_extract", "MAX_STEPS", "flow_stats.cu", "kRound"),
    ("feature_extract", "MAX_PARTS", "flow_stats.cu", "kWarps"),
    ("decode_attention", "VEC", "decode_attention.cu", "kVec"),
    ("decode_attention", "WARPS", "decode_attention.cu", "kWarps"),
    ("decode_attention", "SPLIT_TILE", "decode_attention.cu", "kTile"),
    ("flash_attention", "TILE_K", "flash_attention.cu", "kBK")])
def test_plain_layouts_are_the_sources(module, py_name, source, c_name):
    """The plain versions repeat their kernels' layouts (B5's split, B7's
    lanes, warps and tiles, B6's key tile): the constants they use are the
    ones the CUDA sources were built with."""
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    text = (PKG / "csrc" / source).read_text()
    m = re.search(rf"constexpr int {c_name} = (\d+);", text)
    assert m is not None and int(m.group(1)) == getattr(mod, py_name)


def test_no_per_thread_forest_code_is_left():
    """Every forest kernel runs a warp per flow (B1-B4): the per-thread
    traversal and column code are gone from the sources."""
    text = "".join(p.read_text() for p in (PKG / "csrc").glob("*.cu*"))
    for name in ("traverse_forest(", "traverse_forest_strided(", "kThreads = 32",
                 "column_value(", "median_of(", "kMaxWindow"):
        assert name not in text, name
