"""The window's model FLOPs (forward and backward, recomputation not
counted: ``costs/<family>.py:train_step``) over its seconds and the
card's bf16 peak, in %."""
from perfbench.costs import peaks
from perfbench.readers import costs


def read(r):
    t, w = r["cell"].traffic, r["window"]
    flops = costs(r).train_step(r["cell"].model, t["batch"], t["seq"])["model"]
    return 100.0 * flops * w["steps"] / w["seconds"] / peaks.BF16_FLOPS
