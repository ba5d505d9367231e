"""The share of a traced training step in which no kernel, copy or set
ran on the card."""
from perfbench.readers import idle_pct


def read(r):
    return idle_pct(r)
