"""The readings a cell's limits are set from, on the card, in one process:
for each seed, a run of the cell as the benchmark makes it (set-up, a
window of ``--seconds``, the check's numbers), and for the control seeds
also the control's (the reference computed in fp8, the precision below
the configuration's bf16) and, for training, the reference with half of
each batch left out. The benchmark's own runs never run this.

    python3 -m perfbench.calibrate --workload <cell> --seeds 11 12 ... \\
        --control-seeds 11 12 13 --seconds <s> --out <file.jsonl>

Each seed's readings are one JSON line of the output file and of
standard output."""
from __future__ import annotations

import argparse
import json
import time

from perfbench import run as bench

__all__ = ["main"]


def readings(workload: str, seed: int, seconds: float, controls: bool,
             root=bench.ROOT, device: str | None = None) -> dict:
    """One seed's readings of cell `workload`."""
    import torch

    man = bench.Manifest(root)
    cell = bench.make_cell(man, workload, seed, seconds, False,
                           torch.device(device or "cuda"))
    driver = man.module("drivers", cell.traffic["kind"])
    dev = cell.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    st = driver.setup(cell)
    win = driver.window(cell, st)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    t1 = time.perf_counter()
    out = driver.readings(cell, st, controls)
    del st
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"workload": workload, "seed": seed, **out,
            "metrics": win["metrics"], "run_s": t1 - t0,
            "check_s": time.perf_counter() - t1, "program_peak_bytes": peak,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else 0)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with open(args.out, "a") as f:
        for seed in args.seeds:
            rec = readings(args.workload, seed, args.seconds,
                           seed in args.control_seeds)
            line = json.dumps(rec)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()


if __name__ == "__main__":
    main()
