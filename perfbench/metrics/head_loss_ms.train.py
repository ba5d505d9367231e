"""Device milliseconds a training step of the head and the loss, forward
and backward: the final norm and the head's projection, the float32
cross-entropy, and the backward from the loss to the last layer's output
(the program's spans ``model.head``, ``model.loss`` and
``model.head.backward``, `repro_torch.spans`)."""
from perfbench.program_spans import totals_or_none

SPANS = ("model.head", "model.loss", "model.head.backward")


def read(r):
    t = totals_or_none("head_loss_ms.train", SPANS)
    if t is None:
        return None
    return sum(t[s]["device_ms"] for s in SPANS) / r["info"]["steps"]
