"""The frozen closed forms against the bounds the port's kernel table
states at its shapes, and the whole-step counts against the census
(`repro_torch.launch.step_stats` on meta tensors) at each cell's shapes."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from perfbench.costs import dense, kernels, peaks

ROOT = Path(__file__).resolve().parents[2]


def _model(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["model"]


@pytest.mark.parametrize("cost, ms, by", [
    # B6 at qwen3-8b's timed shape (2, 32 / 8, T 2048, D 128, causal)
    (kernels.b6(2, 32, 8, 2048, 2048, 128), 0.069518, "operations"),
    # B7 at (8, 32 / 8, S 4096, D 128), the 21,252 valid positions the
    # kernel table's run drew (its lengths' sum)
    (kernels.b7(8, 32, 8, 128, 21252), 0.026024, "bytes"),
    # B8 at zamba2-1.2b's prefill shape (2, 2048, 64 x 64, S 64)
    (kernels.b8(2, 2048, 64, 64, 64), 0.021285, "bytes"),
    # B6b at zamba2-1.2b's training shape (2, 32 / 32, T 4096, D 64)
    (kernels.b6b(2, 32, 32, 4096, 64), 0.34750, "operations"),
    # B8b at (2, 4096, 64 x 64, S 64): 209.7 MB
    (kernels.b8b(2, 4096, 64, 64, 64), 0.062602, "bytes"),
])
def test_bounds_of_the_kernel_table(cost, ms, by):
    s, got_by = peaks.bound_s(*cost)
    assert got_by == by
    assert round(s * 1e3, 6 if ms < 0.1 else 5) == pytest.approx(ms, abs=1e-9)


def _census(fn, *args) -> float:
    from repro_torch.launch.step_stats import step_stats

    return step_stats(fn, *args)["flops"]


def _meta_model(name: str):
    from repro_torch.models.zoo import LM
    from perfbench.run import model_config

    cfg = model_config(_model(name))
    return cfg, LM(cfg, torch.device("meta"))


def test_train_step_equals_the_census():
    """qwen3-8b-l8.train-4k: T 4096, batch 8 in 4 microbatches, remat by
    layer. The census counts what runs, recomputation included: the model
    FLOPs plus the remat term."""
    from repro_torch.train import AdamW, make_train_step

    cfg, params = _meta_model("qwen3-8b-l8")
    mix = json.loads((ROOT / "perfbench/mixes/train-4k.json").read_text())
    params.requires_grad_(True)
    opt = AdamW()
    meta = torch.device("meta")
    B, T = mix["batch"], mix["seq"]
    batch = {k: torch.empty((B, T), dtype=torch.int32, device=meta)
             for k in ("tokens", "targets")}
    got = _census(make_train_step(cfg, opt, mix["microbatches"]),
                  {"params": params, "opt": opt.init(params)}, batch)
    want = dense.train_step(_model("qwen3-8b-l8"), B, T)
    assert got == want["model"] + want["remat"]


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("T", [512, 4096])
def test_prefill_equals_the_census(B, T):
    """A batch of B prompts of T tokens costs B prompts alone."""
    from repro_torch.serve.serve_step import make_prefill

    cfg, params = _meta_model("qwen3-8b")
    tok = torch.empty((B, T), dtype=torch.int32, device=torch.device("meta"))
    got = _census(make_prefill(cfg, "meta"), params, {"tokens": tok})
    assert got == B * dense.prefill(_model("qwen3-8b"), T)


def test_the_cut_model_is_the_published_one_at_its_depth():
    """qwen3-8b-l8 differs from qwen3-8b in its depth alone, and
    ``reduced`` names that key."""
    full = json.loads((ROOT / "perfbench/configs/qwen3-8b.json").read_text())
    cut = json.loads((ROOT / "perfbench/configs/qwen3-8b-l8.json")
                     .read_text())
    changed = {k for k in full["model"].keys() | cut["model"].keys()
               if full["model"].get(k) != cut["model"].get(k)}
    assert changed - {"name", "remat"} == set(cut["reduced"]) == {"n_layers"}
    assert cut["published"]["n_layers"] == full["model"]["n_layers"]
    assert cut["model"]["remat"] == "block" == _default_remat()


def _default_remat() -> str:
    from repro_torch.models.config import ModelConfig

    return ModelConfig.__dataclass_fields__["remat"].default
