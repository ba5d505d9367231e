"""Named spans and counters inside the port's LM path, kept only while a
torch profiler runs.

    with span("serve.prefill", dev, tokens=n):  # a phase on dev, counted
        ...
    totals()    # {name: {"calls", "host_ms", "device_ms", <counters>}}

With no profiler on, `span` returns a shared context that does nothing,
after one test of ``torch.autograd.profiler._is_profiler_enabled`` (the
flag that `torch.profiler.profile` and the autograd profiler set while
they run), and `backward_span` returns: nothing is recorded and no hook
is registered. The profiler being on is the only switch. A span's counts
are its keyword arguments, added to its entry as it opens.

With a profiler on, a span
- enters ``torch.profiler.record_function(name)``, so that the profiler's
  own trace holds it (a ``user_annotation`` event) on the kernels' clock;
- takes the host clock at entry and exit (``host_ms``);
- where its work runs on a CUDA device (`where`: a tensor of the work, or
  its device), records a CUDA event on the current stream at entry and at
  exit: ``device_ms`` is the stream's time between them, the device's work
  and idle alike. Elsewhere ``device_ms`` is the host clock's, as the
  benchmark's own spans do on the CPU.

The store keeps aggregates by name, not a log (the timeline is the
profiler's trace). Event pairs wait until `totals()` resolves them after
one synchronise, so recording one waits for nothing; past `PENDING` pairs
one synchronise resolves them all. A profiled window is read after it
closes: `totals()` with no profiler on marks the store read, and the
first span of the next window starts it afresh (a window that nobody
reads carries on into the next: torch tells no profiler session from
another). Spans may run on autograd's device thread (the backward, and
with it checkpoint's recomputation); the store takes a lock.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["backward_span", "span", "totals"]

PENDING = 4096      # event pairs held before one synchronise resolves them
_OFF = contextlib.nullcontext()


class _Store:
    def __init__(self):
        self.lock = threading.Lock()
        self.agg: dict = {}
        self.pending: list = []     # (name, entry event, exit event)
        self.read = False

    def entry(self, name: str) -> dict:
        """The aggregate of `name` (the lock held); the store starts
        afresh at the first span after a read window."""
        if self.read:
            self.agg, self.read = {}, False
        e = self.agg.get(name)
        if e is None:
            e = self.agg[name] = {"calls": 0, "host_ms": 0.0,
                                  "device_ms": 0.0}
        return e

    def add(self, name: str, amounts: dict) -> None:
        with self.lock:
            e = self.entry(name)
            for k, v in amounts.items():
                e[k] = e.get(k, 0) + v

    def close(self, name: str, host_s: float, events) -> None:
        """Count a call of `name`: its host seconds, and its (entry, exit)
        CUDA events, or None where the host clock stands in."""
        with self.lock:
            e = self.entry(name)
            e["calls"] += 1
            e["host_ms"] += 1e3 * host_s
            if events is None:
                e["device_ms"] += 1e3 * host_s
                return
            self.pending.append((name, *events))
            if len(self.pending) > PENDING:
                self.fold()

    def fold(self) -> None:
        """Add every pending pair's time to its aggregate after one
        synchronise (the lock held)."""
        if not self.pending:
            return
        torch.cuda.synchronize()
        for name, e0, e1 in self.pending:
            self.agg[name]["device_ms"] += e0.elapsed_time(e1)
        self.pending = []


_store = _Store()


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "cuda", "rf", "t0", "e0")

    def __init__(self, name: str, cuda: bool):
        self.name, self.cuda = name, cuda

    def __enter__(self):
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        self.e0 = _event() if self.cuda else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        events = (self.e0, _event()) if self.cuda else None
        _store.close(self.name, t1 - self.t0, events)
        self.rf.__exit__(*exc)
        return False


def _on_card(where) -> bool:
    """Whether `where` (a tensor, or a device) is a CUDA device."""
    if isinstance(where, torch.Tensor):
        return where.is_cuda
    return torch.device(where).type == "cuda"


def span(name: str, where, in_backward: str | None = None, **amounts):
    """A context that times what it holds as span `name` while a profiler
    runs, on the clock of `where` (a tensor of the work, or its device),
    adding `amounts` to its counters; `in_backward` names it instead where
    it is entered inside a backward pass (checkpoint's recomputation of a
    forward)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if in_backward is not None and torch._C._current_graph_task_id() != -1:
        name = in_backward
    if amounts:
        _store.add(name, amounts)
    return _Span(name, _on_card(where))


def backward_span(name: str, first: torch.Tensor, last: torch.Tensor
                  ) -> None:
    """While a profiler runs, time as span `name` the stretch of a later
    backward pass from the gradient of `first` (the hook autograd calls
    as it reaches it) to that of `last` being done, on `first`'s device.
    Both hooks leave the gradients as they are."""
    if not _profiler._is_profiler_enabled:
        return
    if not (first.requires_grad and last.requires_grad):
        return
    sp = _Span(name, first.is_cuda)

    def enter(grad):
        sp.__enter__()

    def leave(grad):
        sp.__exit__(None, None, None)

    first.register_hook(enter)
    last.register_hook(leave)


def totals() -> dict:
    """{name: {"calls", "host_ms", "device_ms", <counters>}} of the
    current profiled window, or of the last one once it has closed (which
    this call then marks read), its events resolved after one
    synchronise."""
    with _store.lock:
        _store.fold()
        if not _profiler._is_profiler_enabled:
            _store.read = True
        return {k: dict(v) for k, v in _store.agg.items()}
