"""Device milliseconds a training step of the microbatches' gradient sums:
the float32 accumulators, each microbatch's sum and the division by their
count (the program's span ``train.accumulate``, `repro_torch.spans`)."""
from perfbench.program_spans import totals_or_none

SPAN = "train.accumulate"


def read(r):
    t = totals_or_none("grad_accum_ms.train", (SPAN,))
    return None if t is None else t[SPAN]["device_ms"] / r["info"]["steps"]
