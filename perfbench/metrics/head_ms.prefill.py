"""Device milliseconds of the head (the final norm and the projection to
the vocabulary at every position) per 1,000 prompt tokens served in the
traced batches (the program's spans ``model.head`` and ``serve.prefill``,
its ``tokens`` counter, `repro_torch.spans`)."""
from perfbench.program_spans import totals_or_none


def read(r):
    t = totals_or_none("head_ms.prefill", ("model.head", "serve.prefill"))
    if t is None:
        return None
    return 1e3 * t["model.head"]["device_ms"] / t["serve.prefill"]["tokens"]
