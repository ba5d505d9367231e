"""A benchmark root at small sizes, for the CPU tests: a copy of
``perfbench/`` beside a ``BENCHMARK.json`` of two small cells, one of
each kind, whose configuration is the port's reduced one
(`repro_torch.configs.get_reduced`) and whose mixes are cut to a few
tokens. Their limits are loose enough for the plain path on the CPU and
tight enough that a broken step fails them."""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]

CONFIGS = {"tiny-dense": "qwen3-8b"}
MIXES = {
    "train-tiny": {"kind": "train", "seq": 32, "batch": 4, "microbatches": 2,
                   "zipf_a": 1.3, "warmup_steps": 2, "checked_steps": 3,
                   "lr": 0.003,
                   "warmup": 2, "schedule_steps": 10, "b1": 0.9, "b2": 0.95,
                   "eps": 1e-08, "weight_decay": 0.1, "clip_norm": 1.0},
    "prefill-tiny": {"kind": "prefill_stream", "lo": 16, "hi": 48,
                     "step": 16, "batch": 2, "zipf_a": 1.3, "checked": 2},
}
E2E = (("train_tokens_per_s", "tokens/s", "higher", "train"),
       ("prefill_tokens_per_s", "tokens/s", "higher", "prefill"),
       ("ttft_ms_p95", "ms", "lower", "prefill"))
KIND_OF = {name: kind for name, _, _, kind in E2E}
CELLS = {
    "tiny-dense.train-tiny": {"grad_norm_gap": 1e-3, "change_norm_gap": 1e-2},
    "tiny-dense.prefill-tiny": {"logit_gap": 1e-3},
}


def model_of(arch: str) -> dict:
    """A configuration file's ``model`` of the port's reduced `arch`."""
    from repro_torch import configs

    m = dataclasses.asdict(configs.get_reduced(arch))
    m["head_dim"] = m["head_dim"] or m["d_model"] // m["n_heads"]
    return m


def make_root(tmp: Path, seconds_why: str = "small cell for the CPU tests"
              ) -> Path:
    """A root under `tmp` holding the copy and the small cells."""
    root = Path(tmp)
    shutil.copytree(PACKAGE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    home = root / "perfbench"
    for name, arch in CONFIGS.items():
        (home / "configs" / f"{name}.json").write_text(json.dumps(
            {"source": "reduced", "reduced": [], "model": model_of(arch)}))
        shutil.copy(home / "refs" / f"{arch}.py", home / "refs" / f"{name}.py")
    for name, mix in MIXES.items():
        (home / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    cells = []
    for cell, limits in CELLS.items():
        config, traffic = cell.split(".", 1)
        cells.append({"name": cell, "config": config, "traffic": traffic,
                      "chips": 1, "why": seconds_why})
        (home / "workloads" / f"{cell}.json").write_text(
            json.dumps({"limits": limits}))
    bench = json.loads((PACKAGE.parent / "BENCHMARK.json").read_text())

    def of_kind(kind):
        return [c for c in CELLS if c.endswith(f".{kind}-tiny")]

    e2e = [{"name": name, "unit": unit, "better": better, "bound": 0.25,
            "source": "host_clock", "workloads": of_kind(kind)}
           for name, unit, better, kind in E2E]
    e2e.append({"name": "setup_s", "unit": "s", "better": "lower",
                "bound": 0.25, "source": "host_clock"})
    for m in bench["per_layer"]:
        m["workloads"] = of_kind(m["name"].rpartition(".")[2]
                                 if "." in m["name"] else
                                 KIND_OF[m["moves"]])
    bench.update(workloads=cells, end_to_end=e2e,
                 configs=[{"name": n, "source": "reduced",
                           "file": f"perfbench/configs/{n}.json",
                           "reduced": [], "why": "CPU tests"}
                          for n in CONFIGS])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


