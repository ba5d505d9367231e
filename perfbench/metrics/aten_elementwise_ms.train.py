"""Device milliseconds a training step of ATen's elementwise kernel
families (vectorized, unrolled and generic ``elementwise_kernel``)."""
from perfbench.readers import missing

NAMES = ("elementwise_kernel",)


def read(r):
    tr = r["trace"]
    if not tr.count(NAMES):
        missing("aten_elementwise_ms.train", NAMES)
        return None
    return 1e3 * tr.time_s(NAMES) / r["info"]["steps"]
