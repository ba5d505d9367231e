"""The counts of one step run on meta tensors: FLOPs, bytes, matmuls,
collective payloads and live memory.

Counterpart of `repro.launch.hlo_stats`, which parses the compiled HLO
text of a cell; the port has no HLO, so it runs the step once on meta
tensors (no storage, no arithmetic) and counts what the step asks for,
under the same keys:

  * ``flops``: the matmuls' (`torch.utils.flop_counter.FlopCounterMode`:
    2 x the output x the contracted extent, forward and backward) plus the
    hand-written kernels' closed forms (`kernels.ops.meta_costs`: B6,
    B6b, B7, B8, B8b), which the reference's HLO shows as dots;
  * ``bytes``: every ATen op's tensor inputs and outputs, views excluded,
    plus the kernels' closed-form bytes; ``bytes_hbm`` the same without
    the ops that only move data (copies, casts, concatenations,
    expansions), as the reference's leaves out XLA's copies, transposes,
    broadcasts and concatenations;
  * ``n_dots``: the matmul calls (mm, bmm, addmm, baddbmm) and the
    kernels' launches;
  * ``collectives``: {reference kind: bytes, "count": calls} in the
    reference's convention, a call's payload its output's size and an
    all-reduce's counted twice. `parallel.collectives.counts` counts each
    call's input; `parallel.collectives.payloads` converts each call with
    its group's size as the call is made;
  * ``peak_bytes``: the peak of live bytes allocated during the step
    (`torch.distributed._tools.mem_tracker.MemTracker` on the meta
    tensors), above the inputs, which it does not see; the outputs are
    among them while they are live.
"""
from __future__ import annotations

import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..kernels import ops
from ..parallel.collectives import payloads, reset_counts

__all__ = ["step_stats", "tensor_bytes"]

_aten = torch.ops.aten
_DOTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
         _aten.baddbmm.default}
_MOVES = {_aten.copy_.default, _aten.clone.default, _aten._to_copy.default,
          _aten.cat.default, _aten.stack.default, _aten.expand.default,
          _aten.new_empty.default, _aten.empty_like.default,
          _aten.zeros_like.default, _aten.constant_pad_nd.default,
          _aten.index.Tensor, _aten.index_put_.default,
          _aten.index_put.default}


def tensor_bytes(tree) -> int:
    """The bytes of the distinct tensors in `tree` (an `nn.Module` counts
    its parameters)."""
    leaves, _ = tree_flatten(tree)
    seen, n = set(), 0
    for t in leaves:
        ts = t.parameters() if isinstance(t, torch.nn.Module) else (t,)
        for x in ts:
            if isinstance(x, torch.Tensor) and id(x) not in seen:
                seen.add(id(x))
                n += x.numel() * x.element_size()
    return n


class _OpBytes(TorchDispatchMode):
    """The bytes each ATen op reads and writes, and the matmul calls."""

    def __init__(self):
        super().__init__()
        self.bytes = self.bytes_hbm = self.n_dots = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace != "aten":     # the collectives count apart
            return out
        if not func.is_view:
            n = tensor_bytes((args, kwargs)) + tensor_bytes(out)
            self.bytes += n
            if func not in _MOVES:
                self.bytes_hbm += n
        self.n_dots += func in _DOTS
        return out


def step_stats(fn, *args) -> dict:
    """Run ``fn(*args)`` once (every tensor of args on the meta device,
    under a census mesh's parallel context where the step has one) and
    return its counts (module docstring), the kernels' share under
    ``kernels``, the bytes of the tensors it returns under
    ``output_bytes`` and the step's own seconds under ``seconds``."""
    from torch.distributed._tools.mem_tracker import MemTracker

    reset_counts()
    ops.reset_meta_costs()
    flops = FlopCounterMode(display=False)
    op_bytes = _OpBytes()
    mem = MemTracker()
    t0 = time.perf_counter()
    with mem:
        with flops, op_bytes:
            out = fn(*args)
        out_bytes = tensor_bytes(out)
        del out
    seconds = time.perf_counter() - t0
    kern = ops.meta_costs()
    peak = mem.get_tracker_snapshot("peak")
    return {
        "flops": float(flops.get_total_flops()
                       + sum(k["flops"] for k in kern.values())),
        "bytes": float(op_bytes.bytes + sum(k["bytes"] for k in kern.values())),
        "bytes_hbm": float(op_bytes.bytes_hbm
                           + sum(k["bytes"] for k in kern.values())),
        "n_dots": int(op_bytes.n_dots + sum(k["calls"] for k in kern.values())),
        "collectives": payloads(),
        "kernels": kern,
        "peak_bytes": int(sum(v.get("Total", 0) for v in peak.values())),
        "output_bytes": int(out_bytes),
        "seconds": seconds,
    }
