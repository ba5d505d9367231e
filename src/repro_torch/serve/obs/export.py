"""Pull-based metrics export (DESIGN.md §14.3).

Port of `repro.serve.obs.export`, unchanged but for its imports (numpy
only).

Two render targets over the same `MetricsRegistry` view:

- **Prometheus text exposition** (`render_prometheus`): counters and
  gauges become ``counter``/``gauge`` families; histograms and sketches
  become ``summary`` families (``{quantile="…"}`` samples plus
  ``_sum``/``_count``), since their native percentile reads are exactly
  the summary contract; sets and sample lists export their cardinality.
  A ``shardN.`` name prefix becomes a ``{shard="N"}`` label on the base
  family, so per-shard columns from `fleet_registry` land as one labeled
  family instead of N mangled names. `check_prometheus` validates the
  output (parseable lines, no duplicate or late HELP/TYPE) and is wired
  into the trace_smoke gate.
- **JSONL time series** (`MetricsExporter.step`): one append-only line
  per control step — the full registry snapshot (exact ints, sparse
  sketch docs) plus the SLO signal, stamped with ``now_pkts``. Replay
  determinism makes consecutive runs produce identical series, so the
  artifact is diffable.

`MetricsExporter` is the attachment object: `ControlPlane` binds it to
the fleet registry + telemetry + SLO tracker at construction and calls
`step` at control-step cadence; standalone runtimes can bind it to any
zero-arg registry factory.
"""
from __future__ import annotations

import json
import re

__all__ = ["MetricsExporter", "check_prometheus", "render_prometheus"]

_QUANTILES = (50.0, 90.0, 99.0)
# scope prefixes rendered as labels, outermost first: a fleet registry can
# carry `shard3.tenant1.dispatch.flows_predicted` (multi-tenant pipeline on
# shard 3) and both prefixes must land as labels of ONE base family
_LABEL_RES = (
    ("shard", re.compile(r"^shard(\d+)\.(.+)$")),
    ("tenant", re.compile(r"^tenant(\d+)\.(.+)$")),
)
_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
# value: int/float/scientific/±Inf/NaN
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"            # metric name
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""   # optional {label="v",...}
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
    r" (-?(\d+(\.\d+)?([eE][+-]?\d+)?|Inf|NaN))$")
_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) .*$")
_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (counter|gauge|summary|histogram|untyped)$")


def _sanitize(name: str) -> str:
    """Dotted registry path -> legal Prometheus metric name."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not re.match(r"[a-zA-Z_:]", out[0]):
        out = "_" + out
    return out


def _split_labels(name: str) -> tuple[str, str]:
    """Strip leading scope prefixes into Prometheus labels:
    ``shard3.ingest.drops`` -> ``('ingest.drops', '{shard="3"}')``,
    ``shard3.tenant1.x`` -> ``('x', '{shard="3",tenant="1"}')``.
    Each label key is consumed at most once, so a metric that legitimately
    *names* a tenant deeper in its path is left alone."""
    labels: list[tuple[str, str]] = []
    changed = True
    while changed:
        changed = False
        for key, rx in _LABEL_RES:
            m = rx.match(name)
            if m and all(k != key for k, _ in labels):
                labels.append((key, m.group(1)))
                name = m.group(2)
                changed = True
    if not labels:
        return name, ""
    return name, "{" + ",".join('%s="%s"' % kv for kv in labels) + "}"


def _fmt(v: float) -> str:
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def render_prometheus(reg, *, namespace: str = "cato") -> str:
    """Render a live `MetricsRegistry` as Prometheus text exposition.

    Families are emitted in sorted name order, HELP/TYPE exactly once
    per family, per-shard columns as ``{shard="N"}`` labeled samples of
    the base family. Output always passes `check_prometheus`."""
    # family name -> (type, help, [(labels, value_str), ...])
    fams: dict[str, tuple[str, str, list]] = {}

    def add(raw: str, kind: str, value, help_suffix: str = "",
            suffix: str = ""):
        base, labels = _split_labels(raw)
        fam = f"{namespace}_{_sanitize(base)}{suffix}"
        if fam not in fams:
            fams[fam] = (kind, f"registry {kind} {base}{help_suffix}", [])
        fams[fam][2].append((labels, _fmt(value)))

    for k, v in reg._counters.items():
        add(k, "counter", v)
    for k, (v, r, _w) in reg._gauges.items():
        add(k, "gauge", v, help_suffix=f" (merge: {r})")
    for dists, sum_attr in ((reg._hists, "_sum"), (reg._sketches, None)):
        for k, h in dists.items():
            base, shard = _split_labels(k)
            fam = f"{namespace}_{_sanitize(base)}"
            if fam not in fams:
                fams[fam] = ("summary", f"registry summary {base}", [])
            rows = fams[fam][2]
            for q in _QUANTILES:
                lbl = '{quantile="%s"}' % (q / 100.0)
                if shard:
                    lbl = shard[:-1] + "," + lbl[1:]
                rows.append((lbl, _fmt(float(h.percentile(q)))))
            total = h._sum if sum_attr else h.sum_s
            rows.append(("\x00_sum" + shard, _fmt(float(total))))
            rows.append(("\x00_count" + shard, _fmt(int(h.n))))
    for k, s in reg._sets.items():
        add(k, "gauge", len(s), suffix="_cardinality")
    for k, v in reg._samples.items():
        add(k, "gauge", len(v), suffix="_samples")

    lines = []
    for fam in sorted(fams):
        kind, help_text, rows = fams[fam]
        lines.append(f"# HELP {fam} {help_text}")
        lines.append(f"# TYPE {fam} {kind}")
        for labels, value in rows:
            if labels.startswith("\x00"):
                # summary _sum/_count sub-series: suffix goes on the name
                suffix, shard = labels[1:].split("{", 1) if "{" in labels \
                    else (labels[1:], "")
                shard = "{" + shard if shard else ""
                lines.append(f"{fam}{suffix}{shard} {value}")
            else:
                lines.append(f"{fam}{labels} {value}")
    return "\n".join(lines) + "\n"


def check_prometheus(text: str) -> list[str]:
    """Validate text-exposition output; returns a list of problems
    (empty == valid). Checks: every line parses, HELP/TYPE appear at
    most once per family and never after that family's samples, and no
    sample repeats a label name (a ``shard``/``tenant`` prefix folded
    twice would silently shadow one of the two in Prometheus)."""
    problems: list[str] = []
    helped: set[str] = set()
    typed: dict[str, str] = {}
    sampled: set[str] = set()
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            mh, mt = _HELP_RE.match(line), _TYPE_RE.match(line)
            if mh:
                name = mh.group(1)
                if name in helped:
                    problems.append(f"line {i}: duplicate HELP for {name}")
                if name in sampled:
                    problems.append(f"line {i}: HELP after samples of {name}")
                helped.add(name)
            elif mt:
                name = mt.group(1)
                if name in typed:
                    problems.append(f"line {i}: duplicate TYPE for {name}")
                if name in sampled:
                    problems.append(f"line {i}: TYPE after samples of {name}")
                typed[name] = mt.group(2)
            else:
                problems.append(f"line {i}: unparseable comment: {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            problems.append(f"line {i}: unparseable sample: {line!r}")
            continue
        name = m.group(1)
        labels = m.group(2)
        if labels:
            keys = re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="', labels)
            if len(keys) != len(set(keys)):
                problems.append(
                    f"line {i}: duplicate label name on {name}: {labels}")
        # summary sub-series attach to their base family
        base = name
        for suffix in ("_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed \
                    and typed[name[: -len(suffix)]] in ("summary", "histogram"):
                base = name[: -len(suffix)]
        if base not in typed:
            problems.append(f"line {i}: sample {name} has no TYPE")
        sampled.add(base)
    return problems


class MetricsExporter:
    """Bindable pull exporter: Prometheus text on demand, JSONL series
    at control-step cadence.

    `bind` takes a zero-arg callable producing the registry view to
    export (the control plane passes the fleet registry + telemetry +
    SLO projection); `step` is called by `ControlPlane.maybe_step` after
    each executed control step."""

    def __init__(self, jsonl_path=None, *, namespace: str = "cato"):
        self.jsonl_path = jsonl_path
        self.namespace = namespace
        self._source = None
        self._slo = None
        self.steps = 0
        self.last: dict | None = None

    def bind(self, source, *, slo=None) -> None:
        self._source = source
        self._slo = slo

    def registry(self):
        if self._source is None:
            raise RuntimeError("MetricsExporter.bind was never called")
        return self._source()

    def collect(self, now_pkts: float = 0.0) -> dict:
        """One frozen export record: registry snapshot + SLO signal,
        stamped with the packet clock."""
        doc = {"now_pkts": round(float(now_pkts), 9),
               "step": self.steps,
               "registry": self.registry().snapshot()}
        if self._slo is not None:
            doc["slo"] = self._slo.signal()
        return doc

    def step(self, now_pkts: float) -> dict:
        """Collect and (when a path is configured) append one JSONL
        line. Append-only: a run's series is its full control history."""
        doc = self.collect(now_pkts)
        if self.jsonl_path is not None:
            with open(self.jsonl_path, "a") as fh:
                fh.write(json.dumps(doc, separators=(",", ":")) + "\n")
        self.steps += 1
        self.last = doc
        return doc

    def prometheus(self) -> str:
        return render_prometheus(self.registry(), namespace=self.namespace)
