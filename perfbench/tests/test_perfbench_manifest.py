"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the run length's budget, and every name leading to its files."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from perfbench.manifest import NAME_RE, UNIT_RE, Manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w and "\t" not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_names_and_unique(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME_RE.fullmatch(n), n


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_fields(section):
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if section == "end_to_end" else {"layer", "moves"})
    for m in BENCH[section]:
        assert set(m) - {"workloads"} == keys, m["name"]
        assert UNIT_RE.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_cells_and_configs():
    cfg_names = {c["name"] for c in BENCH["configs"]}
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in cfg_names
        assert 1 <= len(w["why"]) <= 200
        assert NAME_RE.fullmatch(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == cfg_names
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert conf["source"] == c["source"]


def test_every_cell_reports_enough():
    man = Manifest(ROOT)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        names = {m["name"] for m in man.end_to_end(w["name"])}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert man.per_layer(w["name"]), w["name"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in man.end_to_end(cell)}


def test_layers_spelled_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(layer == layer.strip() for layer in layers)
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


def test_run_length_fits_the_check_with_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_name_leads_to_its_files():
    man = Manifest(ROOT)
    for w in BENCH["workloads"]:
        spec = man.cell(w["name"])
        kind = spec["mix"]["kind"]
        for folder, name in (("drivers", kind), ("traffic", kind),
                             ("refs", w["config"])):
            assert (man.home / folder / f"{name}.py").exists(), (folder, name)
        assert spec["limits"]
    for m in BENCH["per_layer"]:
        assert hasattr(man.module("metrics", m["name"]), "read"), m["name"]


def test_no_file_outside_the_names_characters():
    for p in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel
