"""Device milliseconds a training step of the optimizer: the global norm,
the clip and AdamW over every leaf (the program's span
``train.optimizer``, `repro_torch.spans`)."""
from perfbench.program_spans import totals_or_none

SPAN = "train.optimizer"


def read(r):
    t = totals_or_none("optimizer_ms.train", (SPAN,))
    return None if t is None else t[SPAN]["device_ms"] / r["info"]["steps"]
