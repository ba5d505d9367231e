"""The window's prefill FLOPs (``costs/<family>.py:prefill`` of each
request's prompt) over its seconds and the card's bf16 peak, in %."""
from perfbench.costs import peaks
from perfbench.readers import costs


def read(r):
    w, m = r["window"], r["cell"].model
    flops = sum(costs(r).prefill(m, n) for n in w["lengths"])
    return 100.0 * flops / w["seconds"] / peaks.BF16_FLOPS
