"""The program's own spans (`repro_torch.spans`) for the ``program_span``
readers in ``metrics/``: the traced window's totals where the program has
every span a reader asks for, else None, the missing spans named (a
program without spans at all, as before they were added, has none)."""
from __future__ import annotations

import sys

__all__ = ["totals_or_none"]


def totals_or_none(metric: str, names) -> dict | None:
    """``repro_torch.spans.totals()`` where it holds each of `names`;
    otherwise None, with a line naming the spans `metric` lacks."""
    try:
        from repro_torch.spans import totals
    except ImportError:     # a program without spans
        t = {}
    else:
        t = totals()
    gone = [s for s in names if s not in t]
    if gone:
        print(f"{metric}: no span {' or '.join(gone)} in the program",
              file=sys.stderr)
        return None
    return t
