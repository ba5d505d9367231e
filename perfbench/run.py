"""Run one cell of the benchmark once and print its result.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's driver (``drivers/<kind>.py``)
sets the port up from the seed (weights, caches, the warm-up of every
shape the traffic uses: `setup_s`), measures for ``--seconds`` (the
end-to-end metrics), with ``--trace 1`` then profiles a short window and
reads the per-layer metrics from it (``metrics/<metric>.py``), reads the
peak memory, frees the program's state and checks the timed path's
outputs against the plain reference (``refs/<config>.py``). The numbers
compared, each beside its limit (the cell file's ``limits``), are the last
lines on standard error and the last key of the result, the JSON object
on the last line of standard output.

Exits with 3 and prints no result where torch sees no CUDA device or
fewer than the cell asks for, and with 4 where a module of JAX or of the
JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the system under test, from the checkout's source tree
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.manifest import Manifest  # noqa: E402

__all__ = ["Cell", "main", "make_cell", "run"]


@dataclasses.dataclass
class Cell:
    """What a driver is given: the cell's entry and file (`spec`), its
    traffic mix, its configuration file's ``model`` and the port's
    `ModelConfig` of it (`cfg`), the seed, the window's seconds, whether a
    trace is taken, the device and the modules of the reference and of
    the traffic's generator."""
    name: str
    spec: dict
    traffic: dict
    model: dict
    cfg: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    ref: object
    gen: object
    manifest: Manifest


def model_config(model: dict):
    """The port's `ModelConfig` of a configuration file's ``model`` (its
    keys that are the port's fields)."""
    from repro_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in model.items() if k in names})


def make_cell(man: Manifest, workload: str, seed: int, seconds: float,
              trace: bool, dev: torch.device) -> Cell:
    """The Cell of `workload` from the files its names lead to."""
    spec = man.cell(workload)
    conf = man.config(spec["config"])
    return Cell(workload, spec, spec["mix"], conf["model"],
                model_config(conf["model"]), seed, float(seconds), trace,
                dev, man.module("refs", spec["config"]),
                man.module("traffic", spec["mix"]["kind"]), man)


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool,
        root: Path | str = ROOT, device: str | None = None) -> dict:
    """Run cell `workload` once and return its result (the dict printed).
    `device` None takes the card and refuses to run without enough of
    them (SystemExit 3); a test passes ``"cpu"`` to drive the rest of a
    run there, at a cell's small sizes."""
    man = Manifest(root)
    spec = man.cell(workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < spec["chips"]:
            _say(f"{workload} needs {spec['chips']} CUDA device(s); torch "
                 f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            raise SystemExit(3)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    cell = make_cell(man, workload, seed, seconds, trace, dev)
    driver = man.module("drivers", spec["mix"]["kind"])

    t0 = time.perf_counter()
    build_s = _build_kernels(dev)
    state = driver.setup(cell)
    harness.sync(dev)
    setup_s = time.perf_counter() - t0
    _say(f"set-up {setup_s:.3f} s, of which the port's kernels' build or "
         f"load {build_s:.3f} s (a build only in a checkout's first run)")
    win = driver.window(cell, state)
    per_layer, breakdown = {}, None
    if trace:
        tr, info = driver.traced(cell, state)
        readings = dict(cell=cell, window=win, trace=tr, info=info)
        for m in man.per_layer(workload):
            value = man.module("metrics", m["name"]).read(readings)
            if value is None:
                _say(f"{m['name']}: nothing to read in this run")
                continue
            per_layer[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = tr.breakdown()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    t1 = time.perf_counter()
    checks = driver.check(cell, state, win)
    del state
    gc.collect()
    _say(f"window {win['seconds']:.3f} s, check "
         f"{time.perf_counter() - t1:.3f} s, peak {peak} bytes")
    correct = all(c["value"] <= c["limit"] for c in checks)

    if trace:
        metrics = per_layer
    else:
        measured = dict(win["metrics"], setup_s=setup_s)
        metrics = {}
        for m in man.end_to_end(workload):
            if m["name"] not in measured:
                raise KeyError(f"{workload}: its driver measures no "
                               f"{m['name']!r}")
            metrics[m["name"]] = {"value": float(measured[m["name"]]),
                                  "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics,
              "device": _device(dev, spec["chips"], peak)}
    if trace:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def _build_kernels(dev: torch.device) -> float:
    """Seconds to build the port's CUDA kernels, or to load them where
    this checkout has them built (``build/kernels/<key>/``): part of the
    set-up, printed apart."""
    if dev.type != "cuda":
        return 0.0
    from repro_torch.kernels._build import load_library

    t0 = time.perf_counter()
    load_library()
    return time.perf_counter() - t0


def _device(dev: torch.device, chips: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(peak)}


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if torch.cuda.is_available():
        from perfbench.costs import peaks

        _say(f"card: {_power_limit()}; peaks: {peaks.describe()}")
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    # after the window, in the process that prints the result (a test
    # process that calls `run` has loaded JAX for other tests)
    found = harness.forbidden_modules()
    if found:
        _say(f"loaded, and forbidden in a run: {', '.join(found)}")
        raise SystemExit(4)
    for name, c in result["checks"].items():
        _say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
