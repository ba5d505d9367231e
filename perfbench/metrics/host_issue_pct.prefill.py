"""The host's time to issue the traced prefill calls over their time on the
device, in %: near 100 the card waits for the host (the program's span
``serve.prefill``, `repro_torch.spans`)."""
from perfbench.program_spans import totals_or_none

SPAN = "serve.prefill"


def read(r):
    t = totals_or_none("host_issue_pct.prefill", (SPAN,))
    if t is None:
        return None
    return 100.0 * t[SPAN]["host_ms"] / t[SPAN]["device_ms"]
