"""`ServeSession`: the one attachment bundle for a serving run.

Port of `repro.serve.session`. In the reference a session carries the
observability bundle, the control-loop configuration, the reoptimizer
policy and the audit log, and every serving entry point takes
``session=``; the legacy per-call keywords fold into one through
`ServeSession.coerce`.

Those attachments need `serve/control/*` and the `serve/obs` bundle
(`Observability`, drift monitor, SLO tracker, exporter, audit log), whose
port waits for ROADMAP A10. Until then a session, or a legacy keyword,
that carries any of them raises `NotImplementedError`: no serving path
skips an attachment without saying so. An empty session is the only kind,
and `replay` / `find_zero_loss_rate` go through `coerce` as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ServeSession"]

_PENDING = ("the control plane, the observability bundle, the reoptimizer "
            "and the audit log of a serving session are not ported yet "
            "(ROADMAP A10)")


@dataclasses.dataclass
class ServeSession:
    """Everything a serving run carries besides the traffic itself."""

    obs: Optional[object] = None        # serve.obs.Observability (A10)
    control: Optional[object] = None    # serve.control.ControlConfig (A10)
    reopt: Optional[object] = None      # serve.control.ReoptimizerPolicy (A10)
    audit: Optional[object] = None      # overrides obs.audit when set (A10)

    def __post_init__(self):
        given = [f.name for f in dataclasses.fields(self)
                 if getattr(self, f.name) is not None]
        if given:
            raise NotImplementedError(f"{', '.join(given)}: {_PENDING}")

    @classmethod
    def coerce(
        cls,
        session: Optional["ServeSession"] = None,
        *,
        control=None,
        obs=None,
        audit=None,
        tracer=None,
        reopt=None,
    ) -> "ServeSession":
        """Fold legacy per-call keywords into one session.

        Passing both ``session=`` and a legacy keyword is a conflict, so it
        raises `TypeError`, as in the reference; any legacy keyword alone
        raises `NotImplementedError` (ROADMAP A10)."""
        legacy = sorted(k for k, v in (("control", control), ("obs", obs),
                                       ("audit", audit), ("tracer", tracer),
                                       ("reopt", reopt)) if v is not None)
        if session is not None:
            if legacy:
                raise TypeError(
                    f"pass attachments through session= OR the legacy "
                    f"keywords, not both (got session and {legacy})")
            return session
        if legacy:
            raise NotImplementedError(f"{', '.join(legacy)}: {_PENDING}")
        return cls()
