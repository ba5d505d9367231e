"""Synthetic network-trace generator for the paper's two use cases.

The port's own copy of `repro.traffic.synth` (numpy only, seeded exactly
as the original, so both packages draw identical arrays from one seed).

There is no NIC or campus tap in this environment, so we synthesize traces
whose *statistical problem shape* matches the paper's setting:

- per-class generative structure over packet sizes, inter-arrival times,
  TTLs, TCP window sizes, flags, ports and flow lengths;
- a protocol-generic TCP handshake prefix (SYN / SYN-ACK / ACK with
  near-constant sizes) so early packets carry little size information while
  static fields (TTL, initial window, ports) are informative from packet 1;
- behavioral statistics (inter-arrival moments, loads, flag mixes) whose
  class signal grows with packet depth — reproducing the Fig.-2 phenomenon
  that the best feature set *changes* with depth;
- class overlap + noise so F1 saturates below 1.0 and depth matters.

Use cases (paper §5.1):
  iot-class  28 device classes (UNSW IoT analogue), random-forest model.
  app-class  7 classes: 6 web applications + "other", decision-tree model.

Packets are materialized as dense per-flow tensors (flows, max_pkts) so the
extraction engine can run masked segmented reductions (see DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "TrafficDataset",
    "make_dataset",
    "make_scenario_dataset",
    "scenario_flow_starts",
    "FLAG_NAMES",
    "SCENARIOS",
]

# Adversarial serving workloads (DESIGN.md §9.5). Real traffic is not the
# well-mixed Poisson soup `make_dataset` + a plain exponential arrival
# process produce; these named scenarios break exactly the assumptions a
# static deployment bakes in:
#   uniform — the historical well-behaved baseline;
#   zipf    — elephant-flow skew: flow packet mass ~ bounded Zipf, flow
#             durations equalized so an elephant's *rate* scales with its
#             mass. A handful of flows dominate offered load, so a
#             handful of RETA buckets dominate shard load — the workload
#             dynamic rebalancing exists for;
#   burst   — MMPP on/off flow arrivals: mean rate preserved, but flows
#             arrive in compressed bursts separated by lulls, stressing
#             ring buffering and flush-timeout behavior;
#   drift   — the class mix drifts across the trace (early flows drawn
#             from one end of the class list, late flows from the other),
#             so per-class load — and the bucket histogram under any
#             class-correlated steering — moves under the control plane.
SCENARIOS = ("uniform", "zipf", "burst", "drift")

FLAG_NAMES = ("cwr", "ece", "urg", "ack", "psh", "rst", "syn", "fin")
_F = {n: i for i, n in enumerate(FLAG_NAMES)}


@dataclasses.dataclass
class TrafficDataset:
    """Dense per-flow packet tensors + flow metadata + labels."""

    # per-packet tensors, shape (n_flows, max_pkts)
    ts: np.ndarray        # float32 seconds since flow start (cumulative)
    size: np.ndarray      # float32 bytes on the wire
    direction: np.ndarray # uint8: 0 = src->dst, 1 = dst->src
    ttl: np.ndarray       # float32
    winsize: np.ndarray   # float32
    flags: np.ndarray     # uint8 (n_flows, max_pkts, 8), FLAG_NAMES order
    # per-flow metadata
    flow_len: np.ndarray  # int32 true packet count (<= max_pkts stored)
    proto: np.ndarray     # float32 (6 = TCP)
    s_port: np.ndarray    # float32
    d_port: np.ndarray    # float32
    label: np.ndarray     # int32 class id
    class_names: tuple[str, ...] = ()
    name: str = ""

    @property
    def n_flows(self) -> int:
        return self.ts.shape[0]

    @property
    def max_pkts(self) -> int:
        return self.ts.shape[1]

    def valid_mask(self, depth: int | None = None) -> np.ndarray:
        """(n_flows, max_pkts) bool — packet exists and is within depth."""
        idx = np.arange(self.max_pkts)[None, :]
        m = idx < self.flow_len[:, None]
        if depth is not None:
            m &= idx < depth
        return m

    def split(self, test_frac: float = 0.2, seed: int = 0):
        rng = np.random.default_rng(seed)
        n = self.n_flows
        perm = rng.permutation(n)
        n_test = int(n * test_frac)
        te, tr = perm[:n_test], perm[n_test:]
        return self.take(tr), self.take(te)

    def truncate(self, depth: int) -> "TrafficDataset":
        """View of the first `depth` packet columns (flow_len uncapped:
        the extraction mask min()s it against depth anyway). This is the
        batch-side twin of the streaming flow table's `pkt_depth` storage."""
        return TrafficDataset(
            ts=self.ts[:, :depth], size=self.size[:, :depth],
            direction=self.direction[:, :depth], ttl=self.ttl[:, :depth],
            winsize=self.winsize[:, :depth], flags=self.flags[:, :depth],
            flow_len=self.flow_len, proto=self.proto,
            s_port=self.s_port, d_port=self.d_port,
            label=self.label, class_names=self.class_names, name=self.name,
        )

    def take(self, idx: np.ndarray) -> "TrafficDataset":
        return TrafficDataset(
            ts=self.ts[idx], size=self.size[idx], direction=self.direction[idx],
            ttl=self.ttl[idx], winsize=self.winsize[idx], flags=self.flags[idx],
            flow_len=self.flow_len[idx], proto=self.proto[idx],
            s_port=self.s_port[idx], d_port=self.d_port[idx],
            label=self.label[idx], class_names=self.class_names, name=self.name,
        )


def _class_params(K: int, rng: np.random.Generator, kind: str) -> dict:
    """Draw per-class generative parameters."""
    p = {}
    if kind == "app":
        # web apps: static fields barely discriminate — every app is TLS/443
        # from similar CDNs; clients share OS defaults. Class signal must
        # come from behavioral statistics at depth (like the paper's
        # app-class, where early-packet feature sets still need ~10 pkts).
        p["ttl_s"] = rng.choice([64, 128], K) + rng.integers(-2, 3, K)
        p["ttl_d"] = rng.choice([54, 57, 60], K) + rng.integers(-2, 3, K)
        p["win_base"] = rng.choice([29200, 65535], K) * (
            1 + 0.05 * rng.standard_normal(K)
        )
        p["d_port"] = np.full(K, 443)
    else:
        # IoT devices: distinctive stacks (RTOS TTLs, MQTT/CoAP ports, fixed
        # buffer sizes) — static fields informative from packet 1.
        p["ttl_s"] = rng.choice([32, 64, 64, 128, 255], K) + rng.integers(-3, 4, K)
        p["ttl_d"] = rng.choice([32, 64, 128, 128, 255], K) + rng.integers(-3, 4, K)
        p["win_base"] = rng.choice([8192, 16384, 29200, 65535, 65535 // 2], K) * (
            1 + 0.1 * rng.standard_normal(K)
        )
        p["d_port"] = rng.choice([443, 443, 443, 80, 8883, 1883, 5683], K)
    # behavioral: informative at depth
    p["size_mu_s"] = rng.uniform(4.0, 7.2, K)      # log bytes src->dst
    p["size_mu_d"] = rng.uniform(4.3, 7.3, K)      # log bytes dst->src
    p["size_sigma"] = rng.uniform(0.1, 0.4, K)
    p["iat_mu"] = rng.uniform(-7.0, 1.0, K)        # log seconds
    p["iat_sigma"] = rng.uniform(0.15, 0.6, K)
    p["psh_prob"] = rng.uniform(0.05, 0.6, K)
    p["rst_prob"] = rng.uniform(0.0, 0.05, K)
    p["src_frac"] = rng.uniform(0.2, 0.8, K)       # direction mix
    p["hello_size"] = rng.uniform(120, 1100, K)    # TLS-hello-ish pkt 4 size
    if kind == "iot":
        # IoT devices: mostly short periodic flows, some chatty
        p["len_mean"] = rng.uniform(6, 80, K)
    else:
        # web apps: longer flows (video/conference vs social)
        p["len_mean"] = rng.uniform(15, 160, K)
    return p


def make_dataset(
    use_case: str = "iot-class",
    n_flows: int = 6000,
    max_pkts: int = 128,
    seed: int = 0,
    label_noise: float = 0.02,
    flow_len: np.ndarray | None = None,
) -> TrafficDataset:
    """Generate a dataset for `iot-class` (28 classes) or `app-class` (7).

    `flow_len` overrides the per-class geometric length draw with explicit
    per-flow packet counts (clipped to [3, max_pkts]) — scenario generators
    use it to impose e.g. a Zipf mass distribution while every other
    generative mechanism (handshake, sizes, IATs, FIN placement) stays
    consistent with the lengths.
    """
    if use_case == "iot-class":
        K = 28
        class_names = tuple(f"iot_device_{i:02d}" for i in range(K))
        kind = "iot"
    elif use_case == "app-class":
        K = 7
        class_names = (
            "netflix", "twitch", "zoom", "teams", "facebook", "twitter", "other",
        )
        kind = "app"
    else:
        raise ValueError(f"unknown use case {use_case!r}")

    rng = np.random.default_rng(seed)
    prm = _class_params(K, np.random.default_rng(seed + 1000), kind)

    y = rng.integers(0, K, n_flows)
    P = max_pkts

    # flow lengths: geometric-ish with per-class mean, min 3 (handshake),
    # unless the caller imposes its own distribution (scenario generators)
    if flow_len is None:
        lam = prm["len_mean"][y]
        flow_len = np.clip(
            3 + rng.exponential(lam).astype(np.int64), 3, P
        ).astype(np.int32)
    else:
        flow_len = np.clip(np.asarray(flow_len, np.int64), 3, P).astype(np.int32)
        if len(flow_len) != n_flows:
            raise ValueError("flow_len override must have one entry per flow")

    idx = np.arange(P)[None, :]
    in_flow = idx < flow_len[:, None]

    # ---- direction: pkt0 src (SYN), pkt1 dst (SYN/ACK), pkt2 src (ACK),
    #      then per-class Bernoulli mix
    direction = (rng.random((n_flows, P)) > prm["src_frac"][y][:, None]).astype(np.uint8)
    direction[:, 0] = 0
    direction[:, 1] = 1
    direction[:, 2] = 0

    # ---- sizes: handshake 60/60/52, then an application-layer *message
    #      sequence* — the first ~6 data packets follow a class-specific
    #      size pattern (the GGFAST observation the paper builds on: early
    #      message lengths identify the application), before settling into
    #      the noisier stationary distribution
    mu = np.where(direction == 0, prm["size_mu_s"][y][:, None], prm["size_mu_d"][y][:, None])
    size = np.exp(mu + prm["size_sigma"][y][:, None] * rng.standard_normal((n_flows, P)))
    size = np.clip(size, 40, 1500)
    size[:, 0] = 60 + rng.integers(0, 4, n_flows)
    size[:, 1] = 60 + rng.integers(0, 4, n_flows)
    size[:, 2] = 52 + rng.integers(0, 3, n_flows)
    n_msg = min(6, P - 3)
    if n_msg > 0:
        msg_rng = np.random.default_rng(seed + 2000)
        msg_seq = msg_rng.uniform(80, 1400, (len(class_names), n_msg))
        jit_ = 1 + 0.06 * rng.standard_normal((n_flows, n_msg))
        size[:, 3 : 3 + n_msg] = np.clip(msg_seq[y] * jit_, 40, 1500)

    # ---- inter-arrival times: handshake fast (~RTT), then per-class
    #      "application rounds" in the first few exchanges (class-specific
    #      think-times), then the stationary lognormal
    rtt = np.exp(rng.uniform(-5.5, -2.5, n_flows))  # 4ms..80ms per flow
    iat = np.exp(
        prm["iat_mu"][y][:, None]
        + prm["iat_sigma"][y][:, None] * rng.standard_normal((n_flows, P))
    )
    if P > 3:
        n_r = min(6, P - 3)
        round_rng = np.random.default_rng(seed + 3000)
        round_pat = np.exp(round_rng.uniform(-6.5, -0.5, (len(class_names), n_r)))
        iat[:, 3 : 3 + n_r] = round_pat[y] * (
            1 + 0.15 * np.abs(rng.standard_normal((n_flows, n_r)))
        )
    iat[:, 0] = 0.0
    iat[:, 1] = rtt
    iat[:, 2] = rtt * (1 + 0.1 * rng.random(n_flows))
    ts = np.cumsum(iat * in_flow, axis=1).astype(np.float32)

    # ---- ttl: per-flow constant per direction with small jitter
    ttl_s = prm["ttl_s"][y] + rng.integers(-1, 2, n_flows)
    ttl_d = prm["ttl_d"][y] + rng.integers(-1, 2, n_flows)
    ttl = np.where(direction == 0, ttl_s[:, None], ttl_d[:, None]).astype(np.float32)

    # ---- winsize: slow-start-style ramp to per-class base
    ramp = np.minimum(1.0, (idx + 1) / 8.0)
    winsize = (
        prm["win_base"][y][:, None]
        * ramp
        * (1 + 0.05 * rng.standard_normal((n_flows, P)))
    ).astype(np.float32)

    # ---- flags
    flags = np.zeros((n_flows, P, 8), dtype=np.uint8)
    flags[:, 0, _F["syn"]] = 1
    flags[:, 1, _F["syn"]] = 1
    flags[:, 1, _F["ack"]] = 1
    flags[:, 2:, _F["ack"]] = 1
    data_pkts = (idx >= 3) & in_flow
    flags[:, :, _F["psh"]] = (
        data_pkts & (rng.random((n_flows, P)) < prm["psh_prob"][y][:, None])
    )
    flags[:, :, _F["rst"]] = (
        data_pkts & (rng.random((n_flows, P)) < prm["rst_prob"][y][:, None] * 0.1)
    )
    # FIN on the true last packet for ~80% of flows
    has_fin = rng.random(n_flows) < 0.8
    last = np.minimum(flow_len - 1, P - 1)
    flags[np.arange(n_flows), last, _F["fin"]] = has_fin
    flags &= in_flow[:, :, None].astype(np.uint8)

    # ---- flow metadata
    proto = np.full(n_flows, 6.0, dtype=np.float32)
    s_port = rng.integers(32768, 61000, n_flows).astype(np.float32)
    d_port = prm["d_port"][y].astype(np.float32)

    # zero out beyond flow_len
    for arr in (size, ttl, winsize):
        arr *= in_flow
    ts = ts * in_flow

    # label noise: a fraction of flows get a wrong label (class overlap)
    flip = rng.random(n_flows) < label_noise
    y = np.where(flip, rng.integers(0, K, n_flows), y).astype(np.int32)

    return TrafficDataset(
        ts=ts.astype(np.float32),
        size=size.astype(np.float32),
        direction=direction,
        ttl=ttl,
        winsize=winsize,
        flags=flags,
        flow_len=flow_len,
        proto=proto,
        s_port=s_port,
        d_port=d_port,
        label=y,
        class_names=class_names,
        name=use_case,
    )


# ---------------------------------------------------------------------------
# adversarial serving scenarios (DESIGN.md §9.5)
# ---------------------------------------------------------------------------


def scenario_flow_starts(
    rng: np.random.Generator,
    n_flows: int,
    spacing: float,
    scenario: str = "uniform",
    *,
    burst_factor: float = 10.0,
    burst_mean_on: int = 48,
    burst_on_frac: float = 0.35,
) -> np.ndarray:
    """Flow start times for `n_flows` flows at mean inter-start `spacing`.

    "uniform" (also "zipf"/"drift", whose adversarial structure lives in
    the dataset, not the arrival process) is the historical Poisson
    process. "burst" is a two-state MMPP: ON phases arrive
    `burst_factor`x faster than the mean, OFF phases are stretched so the
    *overall* mean spacing — and therefore the offered rate at any clock
    compression — is preserved; `burst_on_frac` of flows arrive inside ON
    phases of geometric mean length `burst_mean_on` flows. The same `rng`
    drives every branch so "uniform" reproduces the pre-scenario streams
    bit-for-bit.
    """
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; pick from {SCENARIOS}")
    if scenario != "burst":
        return np.cumsum(rng.exponential(spacing, n_flows))
    fast = spacing / burst_factor
    # OFF spacing solves the mean-preservation constraint:
    #   on_frac * fast + (1 - on_frac) * slow == spacing
    slow = (spacing - burst_on_frac * fast) / (1.0 - burst_on_frac)
    gaps = np.empty(n_flows)
    pos = 0
    on = True
    while pos < n_flows:
        if on:
            n_phase = 1 + int(rng.geometric(1.0 / burst_mean_on))
            mean_gap = fast
        else:
            mean_off = burst_mean_on * (1.0 - burst_on_frac) / burst_on_frac
            n_phase = 1 + int(rng.geometric(1.0 / mean_off))
            mean_gap = slow
        n_phase = min(n_phase, n_flows - pos)
        gaps[pos : pos + n_phase] = rng.exponential(mean_gap, n_phase)
        pos += n_phase
        on = not on
    return np.cumsum(gaps)


def make_scenario_dataset(
    use_case: str,
    scenario: str = "uniform",
    n_flows: int = 1500,
    max_pkts: int = 48,
    seed: int = 0,
    *,
    zipf_a: float = 1.3,
    elephant_boost: float = 0.0,
    drift_jitter: float = 0.15,
    **kw,
) -> TrafficDataset:
    """`make_dataset` plus the dataset-level half of a named scenario.

    - "uniform"/"burst": the plain dataset (burst shapes arrivals, which
      happens at `PacketStream.from_dataset(scenario=...)` time).
    - "zipf": flow packet counts follow a bounded Zipf draw (elephants
      clip at `max_pkts`), and every flow's timestamps are rescaled so a
      flow's duration *shrinks* with its mass: per-flow packet rate goes
      as `flow_len ** (1 + elephant_boost)`. A handful of flows then
      carry most of the offered load, so a handful of RETA buckets carry
      most of the shard load — the workload round-robin steering cannot
      survive and dynamic rebalancing exists for.
    - "drift": flows are reordered so the class mix seen by an in-order
      arrival process drifts across the trace (class rank + jitter sort).
    """
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; pick from {SCENARIOS}")
    rng = np.random.default_rng(seed + 77_000)
    if scenario == "zipf":
        lens = 2 + rng.zipf(zipf_a, n_flows)
        ds = make_dataset(use_case, n_flows=n_flows, max_pkts=max_pkts,
                          seed=seed, flow_len=lens, **kw)
        # rescale flow durations around the median so per-flow pps scales
        # as len^(1 + boost): equalized duration alone gives rate ~ len;
        # the boost shortens elephants further (a 24-pkt elephant at
        # boost 1 offers ~64x a 3-pkt mouse's rate)
        last = np.minimum(ds.flow_len, ds.max_pkts) - 1
        dur = ds.ts[np.arange(ds.n_flows), last].astype(np.float64)
        target = float(np.median(dur[dur > 0])) if (dur > 0).any() else 1.0
        med_len = float(np.median(ds.flow_len))
        target_i = target * (med_len / ds.flow_len) ** elephant_boost
        scale = np.where(dur > 0, target_i / np.maximum(dur, 1e-9), 1.0)
        ds.ts = (ds.ts.astype(np.float64) * scale[:, None]).astype(np.float32)
        return ds
    ds = make_dataset(use_case, n_flows=n_flows, max_pkts=max_pkts,
                      seed=seed, **kw)
    if scenario == "drift":
        K = len(ds.class_names)
        score = ds.label / max(K - 1, 1) + drift_jitter * rng.standard_normal(
            ds.n_flows)
        ds = ds.take(np.argsort(score, kind="stable"))
    return ds
