"""Loading the benchmark's data by name: ``BENCHMARK.json``, the workload
and configuration files, and the modules of drivers, references, costs
and metric readers, which are loaded from their files so that a name may
hold ``-`` and ``.``. The checks of names and units that the benchmark's
contract sets are here too, for the tests."""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

__all__ = ["NAME_RE", "UNIT_RE", "Manifest", "load_module"]

ROOT = Path(__file__).resolve().parents[1]
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PACKAGE = Path(__file__).resolve().parent.name


def load_module(path: Path, name: str):
    """The module in the file at `path`, loaded under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``BENCHMARK.json`` under `root` (the checkout's root) and the files
    its names lead to, under ``<root>/perfbench``."""

    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        self.home = self.root / PACKAGE
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, folder: str, name: str) -> dict:
        if not NAME_RE.fullmatch(name):
            raise ValueError(f"not a name: {name!r}")
        path = self.home / folder / f"{name}.json"
        if not path.exists():
            raise KeyError(f"no {folder[:-1]} {name!r}: {path} is missing")
        return json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        """The manifest's entry of cell `name`, with its traffic mix
        (``mixes/<traffic>.json``) under ``mix`` and its own file
        (``workloads/<cell>.json``: the limits of its check) merged in."""
        entries = [w for w in self.bench["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        entry = entries[0]
        return {**self._json("workloads", name), **entry,
                "mix": self._json("mixes", entry["traffic"])}

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics cell `cell` reports."""
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics cell `cell` reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        moves = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench.get("per_layer", [])
                if cell in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in moves)]

    def module(self, folder: str, name: str):
        """``<folder>/<name>.py``, loaded from its file."""
        if not NAME_RE.fullmatch(name):
            raise ValueError(f"not a name: {name!r}")
        path = self.home / folder / f"{name}.py"
        if not path.exists():
            raise KeyError(f"no {folder} module {name!r}: {path} is missing")
        return load_module(path, f"{PACKAGE}_{folder}_{name}".replace(
            "-", "_").replace(".", "_"))
