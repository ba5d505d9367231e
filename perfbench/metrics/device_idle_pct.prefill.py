"""The share of the traced prefill requests in which no kernel, copy or set
ran on the card."""
from perfbench.readers import idle_pct


def read(r):
    return idle_pct(r)
