"""`ServeSession`: the one attachment bundle for a serving run.

Port of `repro.serve.session`, unchanged but for its imports.

Historically each serving entry point grew its own attachment keywords —
``obs=`` on `replay`, ``control=`` + ``obs=`` on `controlled_replay` and
`find_zero_loss_rate`, ``audit=`` + ``tracer=`` on `ControlPlane`,
``audit=`` on `deploy`/`make_swap` — five divergent ways to thread the
same four objects. `ServeSession` is the single carrier: the
observability bundle, the control-loop configuration, the reoptimizer
policy, and (when it must differ from the bundle's) the audit log. Every
entry point accepts ``session=``; the legacy keywords keep working for
one release through `ServeSession.coerce`, which folds them into a
session and emits a `DeprecationWarning`.

Resolution rules (all trivially derivable, no hidden state):

- ``audit``: the explicit `audit` field when set, else the observability
  bundle's log, else a fresh `AuditLog` on demand — one run, one audit
  stream.
- ``tracer`` / ``drift`` / ``slo`` / ``exporter``: always through the
  observability bundle.
- ``control`` / ``reopt``: carried as-is; a session with a `reopt`
  policy but no control config is an error at the point of use (the
  reoptimizer runs on control-step cadence).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

__all__ = ["ServeSession"]


def _deprecated(name: str, instead: str) -> None:
    warnings.warn(
        f"the {name} keyword is deprecated; pass "
        f"session=ServeSession({instead}) instead",
        DeprecationWarning,
        stacklevel=4,
    )


@dataclasses.dataclass
class ServeSession:
    """Everything a serving run carries besides the traffic itself."""

    obs: Optional[object] = None        # serve.obs.Observability
    control: Optional[object] = None    # serve.control.ControlConfig
    reopt: Optional[object] = None      # ...control.ReoptimizerPolicy
    audit: Optional[object] = None      # overrides obs.audit when set

    # -- resolution ----------------------------------------------------------

    @property
    def tracer(self):
        return self.obs.tracer if self.obs is not None else None

    @property
    def drift(self):
        return self.obs.drift if self.obs is not None else None

    @property
    def slo(self):
        """The shared `SLOTracker` (DESIGN.md §14.2), via the bundle."""
        return self.obs.slo if self.obs is not None else None

    @property
    def exporter(self):
        """The bound `MetricsExporter` (DESIGN.md §14.3), via the bundle."""
        return self.obs.exporter if self.obs is not None else None

    def resolve_audit(self):
        """The run's one audit log: explicit field > obs bundle > None."""
        if self.audit is not None:
            return self.audit
        if self.obs is not None:
            return self.obs.audit
        return None

    # -- legacy-keyword shim -------------------------------------------------

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
        warn: bool = True,
    ) -> "ServeSession":
        """Fold legacy per-call keywords into one session.

        Passing both ``session=`` and a legacy keyword is a conflict (the
        caller's intent is ambiguous), so it raises. Legacy keywords alone
        build an equivalent session and warn once per call site; `warn=False`
        is for internal forwarding paths that already warned."""
        legacy = {k: v for k, v in (("control", control), ("obs", obs),
                                    ("audit", audit), ("tracer", tracer),
                                    ("reopt", reopt)) if v is not None}
        if session is not None:
            if legacy:
                raise TypeError(
                    f"pass attachments through session= OR the legacy "
                    f"keywords, not both (got session and {sorted(legacy)})")
            return session
        if legacy and warn:
            _deprecated(" / ".join(f"{k}=" for k in sorted(legacy)),
                        ", ".join(f"{k}=..." for k in sorted(legacy)))
        obs_bundle = obs
        if tracer is not None:
            # a bare tracer has no bundle to live in: wrap it
            if obs_bundle is None:
                from .obs import Observability

                obs_bundle = Observability(tracer=tracer)
            elif obs_bundle.tracer is None:
                obs_bundle.tracer = tracer
        return cls(obs=obs_bundle, control=control, reopt=reopt, audit=audit)
