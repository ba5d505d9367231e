"""The 67-candidate-feature registry and its shared-operation DAG.

The port's own copy of `repro.traffic.features`: the registry and the
modeled-cost functions over it (the replay's `ServiceModel.modeled` reads
them).

Exactly the paper's Appendix A Table 3 feature set. Every feature declares
the chain of per-packet *operations* it needs (parse Ethernet header, parse
IPv4, parse TCP, maintain an accumulator, buffer values for a median, ...).
Shared operations are the crux of the paper's conditional-compilation
argument: computing both `s_winsize_mean` and `ack_cnt` parses each packet
down to the TCP header *once*. The registry makes that DAG explicit so

  - the extraction engine emits each op once per representation
    (XLA additionally CSEs shared arithmetic — the jit analogue of the
    paper's cfg-predicated Rust binary),
  - the modeled cost accounts shared ops once (and the Fig.-8
    "naive cost" ablation deliberately does NOT),
  - zero-loss throughput can be derived from per-packet drain cost.

Unit costs are nanoseconds per packet (per-packet ops) or per flow
(extract-time ops), calibrated to the magnitude of the paper's Table 2
execution times (sub-µs..tens of µs per flow).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Op",
    "Feature",
    "OPS",
    "FEATURES",
    "FEATURE_NAMES",
    "MINI_FEATURE_NAMES",
    "per_packet_ops",
    "per_flow_ops_ns",
    "modeled_extraction_cost_ns",
]


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    cost_ns: float          # per packet unless per_flow
    per_flow: bool = False
    deps: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Feature:
    name: str
    ops: tuple[str, ...]            # transitive deps resolved at registry build
    extract_cost_ns: float = 2.0    # per-flow cost at extract() time
    sorting: bool = False           # median features: n log n extract cost


def _mk_ops() -> dict[str, Op]:
    ops = [
        Op("capture", 2.0),
        Op("timestamp", 1.0, deps=("capture",)),
        Op("parse_eth", 1.5, deps=("capture",)),
        Op("parse_ipv4", 2.0, deps=("parse_eth",)),
        Op("parse_tcp", 2.5, deps=("parse_ipv4",)),
        Op("parse_tuple", 30.0, per_flow=True, deps=("parse_ipv4",)),
        # accumulators (per packet)
        Op("acc_pkt_cnt", 0.5, deps=("capture",)),
        Op("acc_dur", 0.5, deps=("timestamp",)),
        Op("acc_handshake", 1.5, deps=("timestamp", "parse_tcp")),
    ]
    for d in ("s", "d"):
        ops += [
            Op(f"dirsplit_{d}", 0.5, deps=("parse_ipv4",)),
            Op(f"acc_{d}_bytes_sum", 1.0, deps=(f"dirsplit_{d}",)),
            Op(f"acc_{d}_bytes_minmax", 1.5, deps=(f"dirsplit_{d}",)),
            Op(f"acc_{d}_bytes_sq", 1.5, deps=(f"dirsplit_{d}",)),
            Op(f"buf_{d}_bytes", 2.0, deps=(f"dirsplit_{d}",)),
            Op(f"acc_{d}_iat_sum", 1.0, deps=(f"dirsplit_{d}", "timestamp")),
            Op(f"acc_{d}_iat_minmax", 1.5, deps=(f"dirsplit_{d}", "timestamp")),
            Op(f"acc_{d}_iat_sq", 1.5, deps=(f"dirsplit_{d}", "timestamp")),
            Op(f"buf_{d}_iat", 2.0, deps=(f"dirsplit_{d}", "timestamp")),
            Op(f"acc_{d}_winsize_sum", 1.0, deps=(f"dirsplit_{d}", "parse_tcp")),
            Op(f"acc_{d}_winsize_minmax", 1.5, deps=(f"dirsplit_{d}", "parse_tcp")),
            Op(f"acc_{d}_winsize_sq", 1.5, deps=(f"dirsplit_{d}", "parse_tcp")),
            Op(f"buf_{d}_winsize", 2.0, deps=(f"dirsplit_{d}", "parse_tcp")),
            Op(f"acc_{d}_ttl_sum", 1.0, deps=(f"dirsplit_{d}", "parse_ipv4")),
            Op(f"acc_{d}_ttl_minmax", 1.5, deps=(f"dirsplit_{d}", "parse_ipv4")),
            Op(f"acc_{d}_ttl_sq", 1.5, deps=(f"dirsplit_{d}", "parse_ipv4")),
            Op(f"buf_{d}_ttl", 2.0, deps=(f"dirsplit_{d}", "parse_ipv4")),
        ]
    for fl in ("cwr", "ece", "urg", "ack", "psh", "rst", "syn", "fin"):
        ops.append(Op(f"acc_flag_{fl}", 1.0, deps=("parse_tcp",)))
    return {o.name: o for o in ops}


OPS: dict[str, Op] = _mk_ops()


def _closure(names: Sequence[str]) -> tuple[str, ...]:
    out: list[str] = []
    stack = list(names)
    seen = set()
    while stack:
        n = stack.pop()
        if n in seen:
            continue
        seen.add(n)
        out.append(n)
        stack.extend(OPS[n].deps)
    return tuple(sorted(out))


def _mk_features() -> dict[str, Feature]:
    feats: list[Feature] = []

    def F(name, direct_ops, extract_ns=2.0, sorting=False):
        feats.append(Feature(name, _closure(direct_ops), extract_ns, sorting))

    F("dur", ["acc_dur"])
    F("proto", ["parse_tuple"], extract_ns=1.0)
    F("s_port", ["parse_tuple"], extract_ns=1.0)
    F("d_port", ["parse_tuple"], extract_ns=1.0)
    F("s_load", ["acc_s_bytes_sum", "acc_dur"], extract_ns=5.0)
    F("d_load", ["acc_d_bytes_sum", "acc_dur"], extract_ns=5.0)
    F("s_pkt_cnt", ["dirsplit_s", "acc_pkt_cnt"])
    F("d_pkt_cnt", ["dirsplit_d", "acc_pkt_cnt"])
    F("tcp_rtt", ["acc_handshake"], extract_ns=3.0)
    F("syn_ack", ["acc_handshake"], extract_ns=3.0)
    F("ack_dat", ["acc_handshake"], extract_ns=3.0)

    for d in ("s", "d"):
        for fam, unit in (("bytes", ""), ("iat", ""), ("winsize", ""), ("ttl", "")):
            F(f"{d}_{fam}_sum", [f"acc_{d}_{fam}_sum"])
            F(f"{d}_{fam}_mean", [f"acc_{d}_{fam}_sum", "acc_pkt_cnt", f"dirsplit_{d}"], extract_ns=4.0)
            F(f"{d}_{fam}_min", [f"acc_{d}_{fam}_minmax"])
            F(f"{d}_{fam}_max", [f"acc_{d}_{fam}_minmax"])
            F(f"{d}_{fam}_med", [f"buf_{d}_{fam}"], extract_ns=10.0, sorting=True)
            F(
                f"{d}_{fam}_std",
                [f"acc_{d}_{fam}_sq", f"acc_{d}_{fam}_sum", "acc_pkt_cnt", f"dirsplit_{d}"],
                extract_ns=8.0,
            )

    for fl in ("cwr", "ece", "urg", "ack", "psh", "rst", "syn", "fin"):
        F(f"{fl}_cnt", [f"acc_flag_{fl}"])

    reg = {f.name: f for f in feats}
    assert len(reg) == 67, f"expected 67 features, got {len(reg)}"
    return reg


FEATURES: dict[str, Feature] = _mk_features()
FEATURE_NAMES: tuple[str, ...] = tuple(FEATURES.keys())

# The paper's 6-feature mini candidate set (Table 3, "In mini cand. set").
MINI_FEATURE_NAMES: tuple[str, ...] = (
    "dur", "s_load", "s_pkt_cnt", "s_bytes_sum", "s_bytes_mean", "s_iat_mean",
)


def per_packet_ops(feature_names: Sequence[str], dedup: bool = True) -> float:
    """Summed per-packet op cost (ns) for a representation.

    dedup=True counts each shared op once (the real pipeline); dedup=False
    sums each feature's chain independently (the Fig.-8 NAIVE COST ablation).
    """
    if dedup:
        ops: set[str] = set()
        for f in feature_names:
            ops.update(FEATURES[f].ops)
        return sum(OPS[o].cost_ns for o in ops if not OPS[o].per_flow)
    total = 0.0
    for f in feature_names:
        total += sum(OPS[o].cost_ns for o in FEATURES[f].ops if not OPS[o].per_flow)
    return total


def per_flow_ops_ns(feature_names: Sequence[str], dedup: bool = True) -> float:
    """Per-flow (extract-time + per-flow op) cost, excluding sort terms."""
    if dedup:
        ops: set[str] = set()
        for f in feature_names:
            ops.update(FEATURES[f].ops)
        base = sum(OPS[o].cost_ns for o in ops if OPS[o].per_flow)
    else:
        base = sum(
            sum(OPS[o].cost_ns for o in FEATURES[f].ops if OPS[o].per_flow)
            for f in feature_names
        )
    return base + sum(FEATURES[f].extract_cost_ns for f in feature_names)


def modeled_extraction_cost_ns(
    feature_names: Sequence[str],
    depth: float,
    dedup: bool = True,
) -> float:
    """Modeled per-flow extraction cost at connection depth `depth` (ns)."""
    c = per_packet_ops(feature_names, dedup) * depth
    c += per_flow_ops_ns(feature_names, dedup)
    n_sort = sum(1 for f in feature_names if FEATURES[f].sorting)
    if n_sort and depth > 1:
        c += n_sort * 0.8 * depth * np.log2(max(depth, 2.0))
    return float(c)
