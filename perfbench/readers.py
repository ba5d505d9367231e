"""Helpers of the per-layer metric readers (``metrics/<metric>.py``). A
reader takes the run's readings, {"cell", "window", "trace", "info"}, and
returns its metric's value, or None where the run has nothing for it to
read (its kernels are not in the trace)."""
from __future__ import annotations

import importlib
import sys

from perfbench.costs import kernels, peaks

__all__ = ["b6_bound", "bound", "costs", "idle_pct", "missing", "share_pct"]


def costs(r: dict):
    """The whole-step costs of the cell's model family (``costs/<family>.py``)."""
    return importlib.import_module(
        f"perfbench.costs.{r['cell'].model['family']}")


def missing(what: str, names) -> None:
    print(f"{what}: no kernel named {' or '.join(names)} in the trace",
          file=sys.stderr)


def idle_pct(r: dict) -> float:
    """The share of the traced window in which no operation ran on the
    device."""
    tr = r["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def share_pct(bound_s: float, device_s: float) -> float:
    return 100.0 * bound_s / device_s


def bound(flops_bytes) -> float:
    return peaks.bound_s(*flops_bytes)[0]


def b6_bound(m: dict, B: int, T: int) -> float:
    return bound(kernels.b6(B, m["n_heads"], m["n_kv_heads"], T, T,
                            m["head_dim"]))
