"""A run's result and its refusals: the last line's keys, the end-to-end
metrics of a run and the per-layer metrics of a traced one (from a
synthetic trace), no result without a card, and traffic that the seed
alone decides, every seed with the same sizes."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from perfbench import harness
from perfbench import run as bench
from perfbench.manifest import Manifest
from perfbench.tests.small import MIXES, make_root

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def test_last_line_has_the_five_keys_and_checks_last(root):
    out = bench.run("tiny-dense.prefill-tiny", 2**31 + 12345, 1.0, False,
                    root=root, device="cpu")
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"prefill_tokens_per_s", "ttft_ms_p95",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints
    nothing on standard output (this sandbox has none)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "qwen3-8b-l8.train-4k", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_only_the_benchmark_is_not_enough(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's own
    folder the command fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "qwen3-8b-l8.train-4k", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def _trace(names_us: list) -> harness.Trace:
    events, t = [], 0.0
    for name, dur in names_us:
        events.append((name, t, dur, "kernel"))
        t += dur + 10.0
    return harness.Trace(window_s=(t + 100.0) / 1e6, device=events, host=[])


def test_trace_reading_and_readers(root):
    man = Manifest(root)
    tr = _trace([("void fa_bwd_dq_wgmma_kernel<128>", 30.0),
                 ("void fa_bwd_dkdv_wgmma_kernel<128>", 40.0),
                 ("void fa_bwd_dq_wgmma_kernel<128>", 30.0),
                 ("void at::native::vectorized_elementwise_kernel<4>", 50.0),
                 ("flash_attention_wgmma_kernel", 100.0)])
    assert tr.busy_s() == pytest.approx(250e-6)
    assert tr.count(("fa_bwd_dq_wgmma_kernel",)) == 2
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "flash_attention_wgmma_kernel"
    assert len(bd["idle_gaps"]) == 4
    cell = bench.Cell("tiny-dense.train-tiny", {}, MIXES["train-tiny"],
                      man.config("tiny-dense")["model"], None, 1, 1.0, True,
                      None, None, None, man)
    r = {"cell": cell, "trace": tr, "window": {"steps": 2, "seconds": 1.0},
         "info": {"steps": 1, "rows": 2, "microbatches": 2}}
    idle = man.module("metrics", "device_idle_pct.train").read(r)
    assert idle == pytest.approx(100 * (1 - 250e-6 / tr.window_s))
    assert man.module("metrics", "aten_elementwise_ms.train").read(r) == \
        pytest.approx(0.05)
    assert 0 < man.module("metrics", "b6b_roofline").read(r)
    assert 0 < man.module("metrics", "b6_roofline").read(
        dict(r, info={"lengths": [16, 16]}))
    empty = dict(r, trace=_trace([("other_kernel", 5.0)]))
    assert man.module("metrics", "b6b_roofline").read(empty) is None
    assert man.module("metrics", "b6_roofline").read(
        dict(empty, info={"lengths": [16]})) is None


@pytest.mark.parametrize("mix", ["train-4k", "prefill-mixed"])
def test_traffic_is_the_seeds_and_every_seed_has_the_same_sizes(mix):
    man = Manifest(ROOT)
    p = json.loads((man.home / "mixes" / f"{mix}.json").read_text())
    gen = man.module("traffic", p["kind"])
    V = 32000
    if p["kind"] == "train":
        a, b = gen.batch(2**33 + 1, 3, p, V), gen.batch(2**33 + 1, 3, p, V)
        c = gen.batch(7, 3, p, V)
        assert np.array_equal(a["tokens"], b["tokens"])
        assert a["tokens"].shape == c["tokens"].shape == (p["batch"], p["seq"])
        assert np.array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])
        assert len({r.tobytes() for r in a["tokens"]}) == p["batch"]
    else:
        n = len(gen.lengths(p))
        for seed in (2**33 + 1, 7):
            sizes = sorted(gen.batch_length(seed, j, p) for j in range(n))
            assert sizes == gen.lengths(p)
            b = gen.batch(seed, 3, p, V)
            assert b.shape == (p["batch"], gen.batch_length(seed, 3, p))
            assert np.array_equal(b[1], gen.request(seed, 3 * p["batch"] + 1,
                                                    p, V))
            assert len({r.tobytes() for r in b}) == p["batch"]
        assert np.array_equal(gen.request(9, 4, p, V), gen.request(9, 4, p, V))
