"""Device milliseconds a training step of the layers' recomputation in the
backward, remat's cost (the program's span ``model.layer.recompute``,
`repro_torch.spans`)."""
from perfbench.program_spans import totals_or_none

SPAN = "model.layer.recompute"


def read(r):
    t = totals_or_none("recompute_ms.train", (SPAN,))
    return None if t is None else t[SPAN]["device_ms"] / r["info"]["steps"]
