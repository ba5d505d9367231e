"""A configuration, a cell, a traffic mix or a per-layer metric is added as
files alone: dropped into a copy of the benchmark, each is found by its
name, and a run of the new cell reports the new metric."""
from __future__ import annotations

import json

import pytest

from perfbench import run as bench
from perfbench.manifest import Manifest
from perfbench.tests.small import make_root


@pytest.fixture
def root(tmp_path):
    return make_root(tmp_path)


def test_new_cell_config_mix_and_metric_are_found_by_name(root):
    home = root / "perfbench"
    model = json.loads((home / "configs" / "tiny-dense.json").read_text())
    model["model"]["n_layers"] = 1
    (home / "configs" / "one-layer.json").write_text(json.dumps(model))
    (home / "refs" / "one-layer.py").write_text(
        (home / "refs" / "tiny-dense.py").read_text())
    (home / "mixes" / "prefill-short.json").write_text(json.dumps(
        {"kind": "prefill_stream", "lo": 8, "hi": 24, "step": 8, "batch": 2,
         "zipf_a": 1.3, "checked": 2}))
    (home / "workloads" / "one-layer.prefill-short.json").write_text(
        json.dumps({"limits": {"logit_gap": 1e-3}}))
    (home / "metrics" / "requests_served.prefill.py").write_text(
        "def read(r):\n    return len(r['window']['lengths'])\n")
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    bench_json["configs"].append(
        {"name": "one-layer", "source": "reduced",
         "file": "perfbench/configs/one-layer.json", "reduced": [],
         "why": "a test"})
    bench_json["workloads"].append(
        {"name": "one-layer.prefill-short", "config": "one-layer",
         "traffic": "prefill-short", "chips": 1, "why": "a test"})
    for m in bench_json["end_to_end"]:
        if m["name"] in ("prefill_tokens_per_s", "ttft_ms_p95"):
            m["workloads"].append("one-layer.prefill-short")
    bench_json["per_layer"].append(
        {"name": "requests_served.prefill", "unit": "requests",
         "better": "higher", "source": "program_counter",
         "layer": "serving steps", "moves": "prefill_tokens_per_s",
         "workloads": ["one-layer.prefill-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))

    man = Manifest(root)
    spec = man.cell("one-layer.prefill-short")
    assert spec["mix"]["hi"] == 24 and spec["limits"]["logit_gap"] == 1e-3
    assert man.config("one-layer")["model"]["n_layers"] == 1
    assert [m["name"] for m in man.per_layer("one-layer.prefill-short")] == \
        ["requests_served.prefill"]
    out = bench.run("one-layer.prefill-short", 5, 1.0, False, root=root,
                    device="cpu")
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"prefill_tokens_per_s", "ttft_ms_p95",
                                   "setup_s"}


def test_a_missing_file_is_named(root):
    man = Manifest(root)
    with pytest.raises(KeyError, match="nowhere"):
        man.config("nowhere")
    with pytest.raises(ValueError):
        man.config("not a name")
