"""Pieces every run shares: seeds derived from ``--seed``, percentiles,
spans around program calls, the device trace and its reading, and the
guard against JAX in the process."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import torch

__all__ = ["FORBIDDEN", "Spans", "Trace", "forbidden_modules", "p95",
           "profile_window", "subseed", "sync"]

# top-level module names that may not be loaded in a run: JAX, its
# libraries and the JAX package of this repository (compared whole, so
# that the port, `repro_torch`, is not taken for `repro`)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed derived from `seed` and `tags`, the same on every
    machine (``hash`` of a str is salted per process)."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def p95(values) -> float:
    """The 95th percentile, between order statistics (the inclusive
    method of `statistics.quantiles`)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among `modules` (the loaded ones by
    default)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Spans around program calls: CUDA events on the card (read after a
    synchronise, so recording them waits for nothing), the host clock
    elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def durations_ms(self) -> list[float]:
        """Milliseconds between consecutive marks."""
        m = self.marks
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


@dataclasses.dataclass
class Trace:
    """A profiled window: its host-clock length and the device's events
    (name, start us, duration us, category), and the host's operations
    where they were recorded."""
    window_s: float
    device: list
    host: list

    def kernels(self) -> list:
        return [e for e in self.device if e[3] == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        the events' intervals."""
        total, end = 0.0, None
        for _, ts, dur, _ in sorted(self.device, key=lambda e: e[1]):
            lo, hi = ts, ts + dur
            if end is None or lo > end:
                total += hi - lo
                end = hi
            elif hi > end:
                total += hi - end
                end = hi
        return total / 1e6

    def time_s(self, names) -> float:
        """Device seconds of the kernels whose name holds one of `names`."""
        return sum(e[2] for e in self.kernels()
                   if any(n in e[0] for n in names)) / 1e6

    def count(self, names) -> int:
        return sum(1 for e in self.kernels() if any(n in e[0] for n in names))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the host operation under way at its start
        (innermost), or without host events by the kernel that ended it."""
        by_name: dict = {}
        for name, _, dur, _ in self.device:
            by_name[name] = by_name.get(name, 0.0) + dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        events = sorted(self.device, key=lambda e: e[1])
        gaps, end = [], None
        for name, ts, dur, _ in events:
            if end is not None and ts > end:
                gaps.append((end, ts, name))
            end = ts + dur if end is None else max(end, ts + dur)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for lo, hi, nxt in gaps[:top]:
            under = [h for h in self.host if h[1] <= lo <= h[1] + h[2]]
            label = (min(under, key=lambda h: h[2])[0] if under
                     else f"before {nxt}")
            out.append([_short(label), (hi - lo) / 1e6])
        return {"device_ops": [[_short(k), v] for k, v in ops],
                "idle_gaps": out}


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def profile_window(fn, host_ops: bool) -> Trace:
    """Run ``fn()`` under `torch.profiler` and read its trace: the device's
    kernels, copies and sets, and with `host_ops` the host's operations.
    The trace file goes to a directory under ``TMPDIR`` and is removed."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="perfbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        item = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
                e.get("cat", ""))
        if item[3] in DEVICE_CATS:
            device.append(item)
        elif item[3] in ("cpu_op", "python_function", "cuda_runtime",
                         "user_annotation"):
            host.append(item)
    return Trace(window, device, host)
