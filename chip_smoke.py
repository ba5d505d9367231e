#!/usr/bin/env python3
"""Drive the PyTorch port of CATO's serving pipeline on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printing one JSON line:

1. device: the card, its name and power limit from nvidia-smi; TF32 off.
2. build: the port's CUDA kernels compiled from src/repro_torch/csrc with
   nvcc for sm_90a (into build/kernels/, which git ignores).
3. data: the full-width deployment, iot-class with 28 classes, 4000 flows
   of up to 128 packets, all 67 registry features at connection depth 50,
   and two forests trained on the CPU with the port's numpy trainer: the
   one `train_traffic_model(model="rf")` selects, and 25 trees of depth 10.
   Then (`stream_data`) the stream phase's deployment below, and the
   aggregate rows of a flow table that ingested its whole trace; then
   (`multitenant_data`) the two multi-tenant deployments B4 is checked on:
   "wide", three tenants over the iot-class set (the 67 features at depths
   50 and 16 and the 59 incremental features at 50, an `rf` forest each:
   131 merged columns, 84 probability lanes), and "fleet", the
   multitenant phase's four tenants.
4. kernels vs plain: each kernel against its plain PyTorch version on the
   card, on the same inputs: the forest traversal (B1) at the main-path
   shape and a ragged one, the fused extract+infer kernel (B2) for plans
   covering every op family at connection depths 1, 8 and 50, with the
   kernel's own feature columns; then each kernel's time (B1 and B2 at
   4096 and 128 flows, B2 also at 8).
   The aggregate kernel (B3) against its plain version on aggregate rows
   of a flow table that ingested the stream phase's trace, for the
   59-feature incremental plan and one plan per op family, at 8, 777 and
   4096 flows, columns bitwise; then its time at 8 and 4096 flows, also
   queued behind a spin of the card (`device_ms`).
   The multi-forest kernel (B4) on both multi-tenant deployments at 4096
   and 32 flows: its merged columns bitwise equal to the plain ones, no
   flow straddled, probabilities bitwise the plain version's, and every
   tenant's lane bitwise equal to solo B2 on that tenant's own plan and
   forest; then its time at 4096 and 32 flows, also queued behind a spin
   of the card.
   The same on `wide_merge`, four tenants over the registry at depths 5,
   10, 15 and 20 on the iot-class window: 259 merged columns, more than
   one thread per flow once held. Then `long_window`: B2 on the stream
   phase's trace with the registry's plan (all eight medians) at depths
   129, 256 and 4000, above the kernels' 128-packet shared-memory chunk,
   columns and probabilities bitwise the plain version's; B4 on
   the registry at depths 100 and 4000 the same way, its lanes bitwise
   solo B2; B2's time at depth 4000 beside its byte bound; and one
   replayed profiler evaluation at depth 256 on the card, counted.
   The LM kernels (`lm_kernel_check`, `lm_kernel_times`): flash attention
   (B6) at qwen3-8b's prefill shape (B 2, 32 q heads, 8 kv heads, T 2048,
   D 128) and zamba2-1.2b's (32 and 32 heads, D 64) in bf16, causal (the
   tensor-core kernel), and at a ragged Tq != Tk in float32 (the scalar
   kernel) and in bf16, causal and not; decode attention (B7)
   at (B 8, 32 q heads, 8 kv heads, S 4096, D 128) in bf16 with random
   lengths in [1, S], at zamba2-1.2b's served batch (B 8, 32 and 32 heads,
   S 168, D 64, every length 159) in bf16, and at S = 300 in float32; the
   Mamba scan (B8) at zamba2-1.2b's prefill shape (B 2, T 2048, 64 heads
   of P 64, S 64) in bf16 and at a ragged T with S 16 in float32; then B6
   and B7 at the small head dims, on rows zero-padded to the kernels' 32
   wide tiles: at the reduced qwen3-8b's heads and head dim 16 in float32
   (B6 4 / 2 heads at T 2048, B7 (8, 4 / 2, S 4096)), and at head dims 8,
   12, 16 and 20 in float32 and bf16 with 7 query heads a kv head at
   ragged lengths; then whisper-small's shapes (12 and 12 heads of 64,
   bf16): B6 non-causal at its encoder's 2 x 1024 and at 448 decoder
   positions against 1500 frames of memory (Tq != Tk), B7 at its served
   cross-attention decode (every length mem_len = 168) and at mem_len
   1500; then B7 on a rank's block of phi3-medium-14b's cache cut by
   sequence over four cards (8, 40 / 10 heads, S 16, D 128, lengths 0 to
   16). Each is bitwise its plain version (torch.equal; B7's
   with its split count, and with its rows' softmax statistics (M, L)
   asked for, both outputs bitwise the plain version's and `out` the
   same bits as without them; B8's y and final state with its block
   count and scratch bytes);
   then each one's time at the main-path shapes (B6 and B7 at qwen3-8b's
   shape, at zamba2-1.2b's (B7's served cache), at the reduced
   qwen3-8b's heads and at whisper-small's encoder and cross attention
   (B6) and served cross-attention decode (B7), B7 also at the
   sequence-cut block and every B7 shape also with (M, L) written) beside
   its plain version, one PyTorch call computing
   the same function (scaled_dot_product_attention for B6 and B7; the
   port never calls it) and its bound, and B6's achieved TFLOP/s; B6's,
   B7's and B8's times also with the launch queued behind a spin of the
   card (`device_ms`, the card's time alone), as are B1's, B2's, B3's and
   B4's. The build's ptxas report for B1's, B2's, B3's, B4's, B7's and
   B8's kernels (registers, stack, spills) is the `build_ptxas` line.
   The flow statistics kernel (B5) through `ops.flow_stats`, bitwise
   against its plain version, on the main path's two windows (packet
   sizes of the iot-class set, 4000 x 128, masked by each flow's valid
   packets, with bool, uint8 and int32 masks; the stream phase's trace
   padded to 600 x 4000), on ragged shapes (73 x 17, 5 x 8, 256 x 12,
   1000 x 128), at the edges of its split (64 x 511, 512 and 513, 32 x
   2047, 16 x 4097) and on an all-empty mask; then its time at the two
   windows beside its plain version and the five masked torch reductions
   that compute the same function (`torch_ops_ms`; no single PyTorch call
   does, so `library_ms` is null), its device time queued behind a spin
   and that of an empty launch (the floor under any kernel). B5's path
   comes first: the entry point on the two windows,
   counted, held against the plain version run on the CPU.
5. main path: `build_pipeline(..., fused=True)` and `fused=False` on the
   card for both forests, warmed on buckets 1..128, serving 16
   micro-batches of 128 flows, one batch of 4096 and the held-out split,
   with the launch counters set to 0 just before and read just after.
6. stream: the streaming runtime on the card, in the JAX package's reuse
   A/B configuration at full size (benchmarks/bench_runtime.py): the zipf
   app-class trace of 600 flows of up to 4000 packets, four host shards
   feeding one card, micro-batches of 8, a 25-tree forest over the 59
   incremental features at connection depth 50, fused. For reuse off and
   on (drift threshold 0.1, refresh every 256 packets): the service
   constants measured on the card, then the zero-loss rate by bisection,
   with the launch counters set to 0 just before and read just after.
   Then threshold-0 parity: an executing replay with forced refreshes
   predicts bitwise as the reuse-off replay, and its refreshed predictions
   agree with the same replay on the two-launch pipeline (torch emission
   + B1) for all but 1% of refreshed flows.
7. multitenant: the JAX package's multi-tenant A/B at full size
   (benchmarks/bench_runtime.py `run_multitenant_gate(tenants=4)`): the
   zipf app-class trace of 500 flows of up to 160 packets, four tenants
   with `tree-fast` forests. The shared arm is one 4-shard fleet over the
   fused `MultiTenantPipeline` (B4); the independent arm four 1-shard
   fleets over the tenants' fused solo pipelines (B2), its rate the
   slowest tenant's. Each arm: service constants measured on the card,
   the zero-loss rate by 8 bisection steps, the launch counters set to 0
   just before and read just after. Then parity under fixed clock
   constants: each tenant's lane of the shared fleet bitwise equal to its
   solo fleet, the unfused shared fleet (torch merged extraction + B1)
   differing from the fused one on at most 1% of flows.
8. cotune: `examples/tune_multitenant.py` steps 1 and 2 on the port (the
   zipf app-class set of 240 flows, three feature pools): each tenant
   tuned alone, then the joint space under shared and independent billing
   (`CatoOptimizer(batch_size=4).run(24)` each); the shared run's knee
   served on the card through B4 with the classes of the CPU plain
   pipeline; one replayed-throughput measurement of tenant 0's knee on
   the card, which launches B2.
8b. fig5: the paper's Fig. 5c through the port
   (benchmarks/fig5_serving_perf.py `run_replayed` at
   benchmarks/bench_runtime.py's full size: the uniform app-class trace of
   1500 flows of up to 48 packets, seed 1, `tree-fast`, one worker). CATO
   searches 25 iterations against the modeled throughput metric; then each
   of its Pareto points and the ALL, MI10 and RFE10 baselines at depths 10
   and 48 is measured on the card: service constants timed through B2,
   then the zero-loss rate by 10 bisection steps. One `fig5` line per
   point, then `fig5_summary` (CATO's best rate over each baseline's, the
   F1-matched ratios, B2's launches). Checked: 0 drops at every reported
   rate, B2 launched, and the profiler's feature matrices on the card
   bitwise the CPU plain version's at every depth the phase used.
9. control: the JAX package's control-plane skew gate at full size
   (benchmarks/bench_runtime.py `--scenario zipf --shards 4`: the zipf
   app-class trace of 1000 flows of up to 256 packets) with
   examples_torch/serve_control.py's acts (its step functions), on a 4-shard fleet of fused pipelines
   (B2) under service constants measured on the card: the zero-loss rate
   by 8 bisection steps of the static fleet and of one under the control
   plane (`ControlConfig(interval_pkts=512, imbalance_trigger=1.04)`),
   0 drops in both and the dynamic imbalance at most the static one; the
   dynamic search's final replay carries an `Observability` bundle
   (tracer, drift, latency sketches, SLO, exporter) whose Prometheus text
   must check clean; a mid-replay hot-swap onto a second configuration
   built through `BundlePoint.build` on the card and armed by `make_swap`
   (0 drops, every flow predicted exactly once, post-swap flows equal to
   the new pipeline's own replay); elastic scale-out at twice and scale-in
   at 1/40 of the static fleet's rate under `HeadroomPolicy`; a
   multi-tenant bundle of both configurations compiled on the card by
   `compile_multi_tenant` (B4) and hot-swapped by `make_swap` onto the
   bundle with the lanes in the other order (0 drops, every flow answered
   once for both tenants). B2's and B4's launch counters are set to 0
   before the first search and read after the last replay. Then the drive
   itself, `serve_control.py --device cuda` at its reference's size (120
   flows, fixed constants), passing its own checks (a `drive` line; B2
   counted).
10. selftune: examples_torch/selftune_fleet.py with `--device cuda`, at
   the size of the JAX package's self-tune gate (the drift app-class trace of 600 flows of up to 32
   packets, 2 shards, the example's clock constants): a fleet frozen on a
   stale knee against one whose `ReoptimizerPolicy` re-tunes with
   `cato_retuner` (modeled fidelity, budget 4) on a shadow profiler on the
   card, compiles the new front there and hot-swaps its knee: exactly one
   episode, 0 drops, every flow predicted once, and the post-drift
   macro-F1 above the frozen fleet's (the drive's own checks).
11. lm_serve: LM serving through `make_prefill` and `make_serve_step` for
   a model of every family at full width in bf16 (qwen3-8b, zamba2-1.2b,
   qwen2-moe-a2.7b, internvl2-26b: 1024 patches then 1024 tokens,
   whisper-small: 1024 frames and 1024 tokens, xlstm-350m), weights drawn
   on the card from seed 0: a prefill of B 2 x T 2048, held against the same
   prefill with B6-B8's plain versions swapped in (argmax equal on >= 99%
   of positions, logit gaps bounded); a served batch of 8 (127 prompt
   tokens teacher-forced, 32 greedy; the ms a step to a synchronised
   result and the ms spent issuing the steps, the process's threads and
   the objects Python's collector tracks), with the launch counters set
   to 0 just before the prefills and read just after the served batch; then 4
   decode steps held against the plain path step by step from the same
   cache (bitwise: every logit and argmax equal), a torch.profiler breakdown of a prefill and
   4 decode steps (xlstm-350m's prefill traced at 256 tokens, and one
   sLSTM layer timed and traced alone at 2048; qwen2-moe-a2.7b's MoE
   steps in ranges, and each timed alone); then the float32 truth: the
   same batch prefilled on the plain path in float32, the layers upcast
   one at a time as the loop reaches them, against which
   the kernel path's argmax share must be at least the plain path's less
   0.01 and its mean logit gap at most 1.1 times the plain path's; and a
   float32 copy at 4 layers whose decode reproduces
   its prefill (atol = rtol = 2e-3; MoE at a capacity that drops nothing,
   the VLM without patches, whisper with zero frames) and whose decode on
   the plain path reproduces the kernel path's (atol = rtol = 1e-4,
   argmax equal).
12. lm_reduced: every reduced config (qwen3-8b, starcoder2-7b,
   phi3-medium-14b, yi-34b: head dims 16, 12, 20, 8; zamba2-1.2b: 32;
   qwen2-moe-a2.7b, kimi-k2-1t-a32b, internvl2-26b, whisper-small: 16;
   xlstm-350m), in float32 and in bf16, weights from seed 0 on
   the card: a prefill of 2 x 40 tokens (internvl2's 16 patches first,
   whisper's 48 frames) through B6, then the prompt
   teacher-forced and 8 greedy tokens through B7 (and B8 for zamba2), the
   launch counters set to 0 just before and read just after; the prefill
   logits, every decode step's logits and the tokens bitwise the same run
   under the plain versions (checked), and each config's B6 and B7
   launches above 0 (xlstm-350m runs none).
13. train_kernels (`train_kernel_check`, `train_kernel_times`): B6b
   (flash attention's dQ, dK, dV) at zamba2-1.2b's training shape
   (causal, B 2, 32 and 32 heads, T 4096, D 64, bf16), at whisper-small's
   (non-causal 2 x 1024 x 1024; 448 positions against 1500 frames) and at
   head dims 8, 12, 16 and 20 in float32 and bf16, causal and not, with 7
   query heads a kv head at ragged lengths; B8b (the scan's dx, ddt, dA,
   dBm, dCm) at zamba2-1.2b's training shape (B 2, T 4096, 64 heads of P
   64, S 64, bf16, no dh_last) and at ragged T with and without dh_last.
   Each bitwise its plain version and bitwise again on a second launch;
   then their times at the training shapes beside the plain versions,
   the bound and, for B6b, autograd's backward of
   scaled_dot_product_attention (timed only). It runs after the serving
   phases, so that they meet the process as they did before it existed.
14. train: first zamba2-1.2b's first 2 layers (one shared-attention
   application, two Mamba layers) at full width, seed-0 weights, step 0's first
   microbatch (2 x 4096 tokens): loss and every gradient on the kernel
   path (B6, B6b, B8, B8b) bitwise the plain path's (`train_step0_vs_
   plain`). Then `repro_torch.launch.train.main` through its argv:
   zamba2-1.2b at full width and depth in bf16, seed-0 weights, T 4096,
   global batch 4 in 2 microbatches, 4 steps, checkpoints every 2 steps in
   a temporary directory under build/, the launch counters set to 0 just
   before and read just after; one more step traced (the card's busy
   share); then the same command again after removing the step-4
   checkpoint, as if the job had died after step 2: it resumes from the
   step-2 checkpoint. Checked: losses finite and falling from step 0 to
   step 3, the resumed losses at steps 2 and 3 bitwise the uninterrupted
   run's, every kernel launched. The `train` line has step ms (median of
   steps 1-3), tokens/s, peak GB and the launches per step.
14b. multicard (slice 15): W = torch.cuda.device_count() processes, one a
   card, each a rank of an NCCL group (no fallback: a group that does not
   start, or a rank that fails, fails the script); each rank takes the
   one-card batch, so the global batch grows with W. `multicard_train`:
   the train phase's command through `launch.train` with ``--data W`` for
   2 steps (its schedule, so steps 0 and 1 see the same learning rates),
   every rank holding its blocks, the gradients reduce-scattered into
   ZeRO-1's moment blocks and the parameters all-gathered; one more step
   traced. At W = 1 its losses and every parameter after step 2 are
   checked bitwise equal to the train phase's (its step-2 checkpoint). `multicard_moe`:
   qwen2-moe-a2.7b at full width cut to 2 layers (bf16, 2 x 2048 tokens,
   seed 0), one forward and backward of `loss_fn` through `moe_sharded`;
   at W = 1 its loss and every gradient checked bitwise equal to
   `moe_ref`'s at capacity C2; both paths timed, one all_to_all of the
   first-stage token buffer timed alone, one pass traced. Each line has
   W, its seconds, each step's collective calls and bytes (checked above
   0), peak GB and the launches, which the `kernels` line adds up.
   Since slice 16 every layer runs its tensor-parallel collectives over
   the (data, model) mesh's model axis, here of size 1 (each a copy), and
   the W = 1 checks above stay bitwise. On W > 1 cards
   (``--multicard-only``; `tp_meshes` picks the meshes, each printed)
   `multicard_tp` follows `multicard_train`: the same command on
   (W / 2, 2) (on two cards (2, 1)) for 3 steps with a checkpoint at step
   2, then again from it (its step bitwise the uninterrupted one), and on
   (1, W) for 2 steps, held to a one-card run of the same global batch
   first (`multicard_tp_one_card`; losses within MC_TP_LOSS_ATOL, grad
   norms within MC_TP_GNORM_RTOL); then, from four cards, qwen3-8b at
   full width cut to 8 layers on (1, W) held to one card the same way
   over 3 steps, and whole on (1, W): bf16, T 4096, global batch 4 in 2
   microbatches, 3 steps (step ms the median of steps 1-2, tokens/s, peak
   GB a rank, losses finite, whether they rose), each step's collectives
   equal to `launch.specs.train_collectives`' closed form, one more step
   traced (NCCL's device ms).
   Last, `multicard_serve` (slice 17; `serve_cases` picks the models and
   meshes, MC_SERVE_* the sizes and tolerances): each model drawn whole
   on every card from seed 0, served once on rank 0's card alone, then
   cut to each rank's blocks (`tp_pspecs`) and served over the (data,
   model) mesh through `launch.specs.build_cell`'s prefill and decode
   cells (the forced decode steps through `models.decode_step` under the
   mesh, the cache cut by `tp_cache_pspecs`), the launch counters set to
   0 just before and read just after. At W = 1 zamba2-1.2b on (1, 1),
   bitwise the one-card run (prefill logits, each forced step's logits,
   the greedy tokens, every cache tensor); on four cards qwen3-8b and
   phi3-medium-14b (its cache cut by sequence: B7's statistics and the
   merge across ranks) on (1, 4) and zamba2-1.2b on (2, 2), each within
   MC_SERVE_* of the one-card run, the dense models' collectives equal to
   `launch.specs.serve_collectives`; each line has prefill and decode ms,
   peak GB a rank, one greedy step traced (NCCL's device ms), and the
   one-card times. ``--multicard-only --serve-only`` runs it alone and
   prints `nvidia-smi topo -m` with every card's name and power limit.
14c. census_train: the census (`repro_torch.launch.dryrun.measure`, on
   meta tensors, a fake process group of one) of the train phase's cell,
   its arguments and temporaries beside the phase's measured peak; it
   runs on the host while the multicard ranks work on the card.
15. train_reduced: every reduced config in float32 and bf16, one
   `make_train_step` step (2 x 40 tokens, 2 microbatches, AdamW) on the
   kernel path and on the plain path: loss, grad norm, every gradient and
   every updated parameter bitwise (checked), each config's kernels
   launched; then examples_torch/train_lm.py with --device cuda (its loss
   falls, B6b launched).

Probabilities of pipelines whose feature columns agree only to float32
rounding are compared by the straddle rule
(`repro_torch.kernels.ref.straddled_flows`): flows whose path meets a
threshold lying between the two sides' values of its feature are counted
and may be at most 1%; every other flow agrees to 1e-6 with the same
argmax. Then come a `kernels` line, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Without a CUDA device, or
when any check fails, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# about 1 ms of the card's clock: longer than a wrapper's host work
QUEUE_CYCLES = 2_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: 80 GB of HBM3 at 3.35 TB/s
FP32_OPS_PER_S = 67e12     # H100 SXM: float32 outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM: bf16 on the tensor cores, dense
PROB_ATOL = 1e-6
MAX_STRADDLED = 0.01
KERNEL_REPS, PLAIN_REPS = 30, 5
# the stream phase's trace and search (benchmarks/bench_runtime.py, reuse A/B)
STREAM_FLOWS, STREAM_PKTS, BISECT_ITERS = 600, 4000, 6
# the multitenant phase: the JAX package's multi-tenant A/B at full size
# (benchmarks/bench_runtime.py `run_multitenant_gate(tenants=4)`)
MT_FLOWS, MT_PKTS, MT_BISECT = 500, 160, 8
MT_TENANTS = (
    (("s_bytes_mean", "s_iat_mean", "s_load", "proto"), 8),
    (("s_bytes_mean", "s_iat_mean", "s_load", "dur", "s_bytes_max"), 12),
    (("s_bytes_mean", "s_iat_mean", "dur", "d_pkt_cnt"), 8),
    (("s_bytes_mean", "s_load", "ack_cnt", "psh_cnt"), 8),
)
# its parity replays' fixed clock constants
MT_SERVICE = dict(pkt_accum_ns=800.0, pkt_track_ns=200.0,
                  bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5},
                  gather_ns_per_flow=200.0, source="synthetic")
# the cotune phase (examples/tune_multitenant.py): a shared core of
# features and a specialty pair per tenant
_CORE = ("s_bytes_mean", "s_iat_mean", "s_load", "dur")
CO_POOLS = (_CORE + ("proto", "ack_cnt"), _CORE + ("s_bytes_max", "psh_cnt"),
            _CORE + ("d_pkt_cnt", "d_iat_std"))
CO_ITERS, CO_SOLO = 24, 16
# the fig5 phase: benchmarks/bench_runtime.py:run's full-size settings for
# fig5_serving_perf.run_replayed (Fig. 5c), one worker; depth 48 is the
# trace's whole connection (ds.max_pkts), where the paper says 50
FIG5 = dict(use_case="app", iters=25, n_flows=1500, max_pkts=48,
            depths=(10, 48), bisect_iters=10, cost_mode="measured",
            model="tree-fast", seed=1)
# fig5_serving_perf.REPLAYED_HEADER
FIG5_HEADER = ("method", "depth", "n_features", "f1", "zero_loss_gbps",
               "zero_loss_pps", "p50_s", "p99_s", "drops", "compiles",
               "shard", "scenario", "control", "imbalance",
               "share_ingest", "share_infer", "share_flush")
# the drift gate's configurations per op family of the incremental plan
AGG_PLANS = (
    ("dur", "proto", "s_port", "d_port"),
    ("s_load", "d_load", "s_pkt_cnt", "d_pkt_cnt"),
    ("tcp_rtt", "syn_ack", "ack_dat", "syn_cnt", "ack_cnt", "fin_cnt"),
    ("s_bytes_sum", "s_bytes_mean", "s_bytes_min", "s_bytes_max",
     "s_bytes_std", "d_bytes_std"),
    ("s_iat_sum", "d_iat_mean", "d_iat_std", "s_iat_min", "s_iat_max"),
    ("s_winsize_mean", "d_winsize_std", "s_ttl_min", "d_ttl_max",
     "d_winsize_sum", "s_ttl_std"),
)


# B5's ragged and edge cases beside the main path's two windows, the last
# ones at its split's edges (a part of 512 packets; 2 parts from 513, 8
# from 4097; 2047 not a multiple of 4)
B5_RAGGED = ((73, 17), (5, 8), (256, 12), (1000, 128), (64, 511), (64, 512),
             (64, 513), (32, 2047), (16, 4097))
B5_OPS_PER_ELEMENT = 8    # count add, v*m and add, v*v, *m and add, min, max
# the control phase: the JAX package's control-plane skew gate at full size
# (benchmarks/bench_runtime.py:88-92 with benchmarks/fig5_serving_perf.py:143)
# and examples/serve_control.py's two configurations
# (the configurations are serve_control.py's: examples_torch/serve_control.py)
CTRL_FLOWS, CTRL_PKTS, CTRL_BISECT = 1000, 256, 8
# windows above B2's and B4's shared-memory chunk (128 packets), on the
# stream phase's trace; B4's two tenants (the registry at both depths)
LW_DEPTHS, LW_TENANT_DEPTHS = (129, 256, 4000), (100, 4000)
# one replayed profiler evaluation above the buffer: a median-bearing
# configuration over a zipf app-class trace of flows of up to 512 packets
LW_PROFILE_FLOWS, LW_PROFILE_PKTS, LW_PROFILE_DEPTH = 200, 512, 256
LW_PROFILE_POOL = ("dur", "s_load", "ack_cnt", "s_bytes_mean", "s_bytes_med",
                   "d_iat_med")
# more merged columns than one thread per flow once held (256): four
# tenants over the registry at four depths, 3 meta + 4 x 64 = 259 columns
WM_DEPTHS = (5, 10, 15, 20)


# the lm_serve phase: a model of every LM family at full width (kimi-k2's
# 1.04e12 parameters fit neither one card nor four: it serves reduced only)
LM_ARCHS = ("qwen3-8b", "zamba2-1.2b", "qwen2-moe-a2.7b", "internvl2-26b",
            "whisper-small", "xlstm-350m")
# the stub embeddings (patches, frames) are normal draws at the token
# embeddings' scale; whisper's batch is half frames, half tokens, as the
# reference's input_specs builds it (Te = Td = T / 2); internvl2's the
# config's 1024 patches, then T - 1024 tokens
LM_EMBED_SCALE = 0.02
# xLSTM's sLSTM runs a Python loop over T (a few launches a token): its
# traced prefill is of LM_SSM_PROFILE_T tokens, and one sLSTM layer is
# timed and traced alone at the full T
LM_SSM_PROFILE_T = 256
LM_PREFILL_B, LM_PREFILL_T, LM_PREFILL_REPS = 2, 2048, 3
LM_SERVE_B, LM_PROMPT, LM_GEN = 8, 128, 32
LM_DECODE_CHECK = 4            # decode steps held against the plain path
LM_PROFILE_STEPS = 4           # traced decode steps after those
LM_CACHE_LEN = LM_PROMPT + LM_GEN + LM_DECODE_CHECK + LM_PROFILE_STEPS
LM_F32_LAYERS, LM_F32_T = 4, 32
# kernel-path prefill logits against the plain path's, both bf16: the two
# differ only where a float32 sum in B6 or B8 rounds to the other bf16
# neighbour, which then travels through the layers; logits of a random
# model are ~N(0, 1) (|max| ~ 5, a bf16 ulp 0.016-0.031 there). B6's bf16
# plain version repeats the tensor-core kernel's arithmetic (its GEMMs are
# cuBLAS's bf16 GEMMs into float32), so on the card the two agree bitwise;
# a one-ulp difference alone, carried through 36 random layers, moved 5.3%
# of the argmaxes (a one-pass plain B6, run E) and through zamba2-1.2b's
# 38 layers and SSM state a mean logit gap of 0.052 (a first version of
# this kernel, run M). Both bf16 paths are also held to a float32 run of
# the same weights: the kernel path's argmax share with it at least the
# plain path's minus LM_TRUTH_ARGMAX_SLACK, its mean gap to it at most
# LM_TRUTH_GAP_RATIO times the plain path's.
LM_ARGMAX_MIN, LM_LOGIT_MAX_ERR, LM_LOGIT_MEAN_ERR = 0.99, 1.0, 0.02
LM_TRUTH_ARGMAX_SLACK, LM_TRUTH_GAP_RATIO = 0.01, 1.1
# the float32 4-layer copies: decode against the prefill (the reference's
# own invariant, tests/test_models.py) and decode on the kernel path
# against the plain path, where orders of summation differ by ~1e-6
LM_F32_DECODE_TOL, LM_F32_PLAIN_TOL = 2e-3, 1e-4
# B6, B7 and B8 repeat their plain versions' order of arithmetic and are
# held to them bitwise
# their cases: B6 (B, Hq, Hkv, Tq, Tk, D) with the causal flags checked,
# B7 (B, Hq, Hkv, S, D) with every length or None for lengths drawn in
# [1, S], B8 (B, T, H, P, S). The qwen3-8b and zamba2-1.2b cases are the
# main path's shapes (B7's zamba2 case the served batch's cache, at the
# length of its last served step); the first two B6 and B7 cases and the
# first B8 case are also timed. Then the small head dims (drawn after
# those, so that their inputs stay as they were): the qwen3-8b-reduced
# cases are the reduced config's heads and head dim (16, rows padded to
# 32) at the full config's timed lengths, and are timed too; then the
# reduced configs' head dims (8 yi-34b, 12 starcoder2-7b, 16 qwen3-8b, 20
# phi3-medium-14b), each in both types at ragged lengths with 7 query
# heads a kv head (yi-34b's)
LM_B6_CASES = (
    ("qwen3-8b", (2, 32, 8, 2048, 2048, 128), torch.bfloat16, (True,)),
    ("zamba2-1.2b", (2, 32, 32, 2048, 2048, 64), torch.bfloat16, (True,)),
    ("ragged", (2, 8, 2, 200, 328, 128), torch.float32, (True, False)),
    ("ragged_bf16", (2, 8, 2, 200, 328, 128), torch.bfloat16, (True, False)))
LM_B7_CASES = (
    ("qwen3-8b", (8, 32, 8, 4096, 128), torch.bfloat16, None),
    ("zamba2-1.2b", (LM_SERVE_B, 32, 32, LM_CACHE_LEN, 64), torch.bfloat16,
     LM_PROMPT + LM_GEN - 1),
    ("ragged", (4, 32, 8, 300, 128), torch.float32, None))
# whisper-small's shapes (12 and 12 heads of 64), drawn after all the
# others so that their inputs stay as they were: B6 non-causal at the
# encoder's (and the served cross attention's) Te = Td = 1024, at a
# decoder's 448 positions against 30 s of memory (1500 frames: Tq != Tk);
# B7 at the served batch's cross-attention decode (every length mem_len,
# the cache's 168 positions) and at the reference's cap of 1500
LM_WHISPER_B6_CASES = (
    ("whisper-small-encoder", (2, 12, 12, 1024, 1024, 64), torch.bfloat16,
     (False,)),
    ("whisper-small-cross", (2, 12, 12, 448, 1500, 64), torch.bfloat16,
     (False,)))
LM_WHISPER_B7_CASES = (
    ("whisper-small-cross", (LM_SERVE_B, 12, 12, LM_CACHE_LEN, 64),
     torch.bfloat16, LM_CACHE_LEN),
    ("whisper-small-memory", (LM_SERVE_B, 12, 12, 1500, 64), torch.bfloat16,
     1500))
# B7 on a rank's block of phi3-medium-14b's cache cut by sequence over a
# model axis of 4 (multicard_serve: 40 query heads gathered, 10 kv heads,
# 16 of 64 positions), at local lengths 0 (a rank past every position),
# 1, a split's edge and 16; drawn after every other case
LM_SEQ_B7_CASES = (
    ("phi3-medium-14b-seq", (8, 40, 10, 16, 128), torch.bfloat16,
     (0, 1, 15, 16, 0, 7, 16, 2)),)
LM_SMALL_DIMS = (8, 12, 16, 20)
LM_SMALL_B6_CASES = (
    ("qwen3-8b-reduced", (2, 4, 2, 2048, 2048, 16), torch.float32, (True,)),
    *((f"d{D}_{str(dt)[6:]}", (2, 7, 1, 200, 328, D), dt, (True, False))
      for D in LM_SMALL_DIMS for dt in (torch.float32, torch.bfloat16)))
LM_SMALL_B7_CASES = (
    ("qwen3-8b-reduced", (8, 4, 2, 4096, 16), torch.float32, None),
    *((f"d{D}_{str(dt)[6:]}", (4, 7, 1, 300, D), dt, None)
      for D in LM_SMALL_DIMS for dt in (torch.float32, torch.bfloat16)))
LM_TIMED = ("qwen3-8b", "zamba2-1.2b", "qwen3-8b-reduced")
LM_TIMED_B6 = LM_TIMED + ("whisper-small-encoder", "whisper-small-cross")
LM_TIMED_B7 = LM_TIMED + ("whisper-small-cross", "phi3-medium-14b-seq")
# the lm_reduced phase: every reduced config, in its own float32 and in
# bf16: a prefill of B x T through B6 (whisper's frames T + 8 long, so its
# cross attention has Tq != Tk; internvl2's patches its config's 16), then
# the prompt teacher-forced and LM_REDUCED_GEN greedy tokens decoded
# through B7 (xlstm-350m runs no kernel: the plain path twice)
LM_REDUCED_ARCHS = ("qwen3-8b", "starcoder2-7b", "phi3-medium-14b", "yi-34b",
                    "zamba2-1.2b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                    "internvl2-26b", "whisper-small", "xlstm-350m")
LM_REDUCED_B, LM_REDUCED_T, LM_REDUCED_GEN = 2, 40, 8
LM_REDUCED_FRAMES_EXTRA = 8
LM_B8_CASES = (("zamba2-1.2b", (2, 2048, 64, 64, 64), torch.bfloat16),
               ("ragged", (2, 1000, 8, 64, 16), torch.float32))
# training (slice 13): zamba2-1.2b at full width and depth in bf16, the
# reference's train_4k sequence length (src/repro/models/config.py), a
# global batch of 4 in 2 microbatches, 4 steps, a checkpoint every 2; the
# kernel path against the plain path at step 0 on the first
# TRAIN_CHECK_LAYERS layers (one shared-attention application and the
# Mamba layers around it) and one microbatch
TRAIN_ARCH, TRAIN_T, TRAIN_BATCH, TRAIN_MB, TRAIN_STEPS = (
    "zamba2-1.2b", 4096, 4, 2, 4)
TRAIN_CHECK_LAYERS = 6
# B6b: (B, Hq, Hkv, Tq, Tk, D), dtype, causal: zamba2-1.2b's training
# shape, whisper-small's (non-causal encoder; a decoder's 448 positions
# against 1500 frames), the small head dims in both types with 7 query
# heads a kv head at ragged lengths
TRAIN_B6B_CASES = (
    ("zamba2-1.2b-train", (2, 32, 32, 4096, 4096, 64), torch.bfloat16, True),
    ("whisper-small-encoder", (2, 12, 12, 1024, 1024, 64), torch.bfloat16,
     False),
    ("whisper-small-cross", (2, 12, 12, 448, 1500, 64), torch.bfloat16, False),
    *((f"d{D}_{str(dt)[6:]}_{'causal' if c else 'full'}",
       (2, 7, 1, 200, 328, D), dt, c)
      for D in LM_SMALL_DIMS for dt in (torch.float32, torch.bfloat16)
      for c in (True, False)))
# B8b: (B, T, H, P, S), dtype, with dh_last, chunk: zamba2-1.2b's training
# shape (training discards the final state), ragged T with and without
# dh_last, chunks of 64, and T below one chunk
TRAIN_B8B_CASES = (
    ("zamba2-1.2b-train", (2, 4096, 64, 64, 64), torch.bfloat16, False, 128),
    ("ragged", (2, 1000, 8, 64, 16), torch.float32, False, 128),
    ("ragged_dh", (2, 1000, 8, 64, 16), torch.float32, True, 128),
    ("ragged_bf16_dh", (1, 333, 4, 64, 64), torch.bfloat16, True, 128),
    ("chunk64_dh", (2, 1000, 8, 64, 16), torch.bfloat16, True, 64),
    ("below_chunk_dh", (2, 100, 8, 64, 64), torch.float32, True, 128))
# train_reduced: one step of each reduced config in both types, 2 x 40
# tokens in 2 microbatches
TRAIN_REDUCED_B, TRAIN_REDUCED_T = 2, 40
# multicard (slice 15): W = torch.cuda.device_count() NCCL ranks, a process
# a card; the MoE phase's model at full width with its depth cut to 2
# layers (15.15B parameters at full depth would need 60 GB of bf16 weights
# and gradients before any activation)
MC_MOE_ARCH, MC_MOE_LAYERS, MC_MOE_T, MC_MOE_B = "qwen2-moe-a2.7b", 2, 2048, 2
# timed runs of each multicard_moe measurement (after one warm-up)
MC_MOE_REPS = 3
MC_TIMEOUT = 600
# multicard over the model axis (slice 16), on W > 1 cards (after
# multicard_train on (W, 1)): the train phase's zamba2-1.2b on (W / 2, 2)
# from four cards up, else (W, 1), with a restart from its step-2
# checkpoint, and on (1, W) beside a one-card run of the same global
# batch (losses within MC_TP_LOSS_ATOL, grad norms within
# MC_TP_GNORM_RTOL: bf16 partial sums over the model axis against one
# product); then MC_TP_ARCH at full width on (1, W), which one card cannot
# hold (bf16 T 4096, global batch 4 in 2 microbatches, MC_TP_STEPS steps)
MC_TP_ARCH, MC_TP_STEPS, MC_TP_BATCH, MC_TP_MB = "qwen3-8b", 3, 4, 2
# MC_TP_ARCH cut to this depth at full width (about the deepest whose
# train state one card holds: 2.79B parameters, 39 GB of weights,
# gradient sums and moments) trains MC_TP_STEPS steps of the launcher's
# schedule and batches on one card and on (1, W): held to each other as
# zamba2-1.2b's (1, W) run is, and the witness of how the whole model's
# losses move under the first steps
MC_TP_CHECK_LAYERS = 8
MC_TP_LOSS_ATOL, MC_TP_GNORM_RTOL = 0.02, 0.05
MC_TP_TIMEOUT = 1500
# serving over the (data, model) mesh (slice 17): each case's full-width
# bf16 model (seed-0 weights, drawn whole on every card and cut to its
# blocks) prefills MC_SERVE_B x MC_SERVE_T tokens through `build_cell`'s
# prefill cell, then decodes a batch of MC_SERVE_DECODE_B from an empty
# cache of MC_SERVE_MAX_LEN positions: the forced steps through
# `decode_step` (their logits kept), then greedy ones through the decode
# cell. At W = 1 zamba2-1.2b on (1, 1) is held bitwise to the one-card
# serve path in the same process (prefill logits, each forced step's
# logits, the greedy tokens, every cache tensor); on four cards qwen3-8b
# (kv heads cut over 4), phi3-medium-14b (10 kv heads: the cache cut by
# sequence, 16 positions a rank, the last rank's never reached) and
# zamba2-1.2b on (2, 2), each to a one-card run on rank 0 within the
# MC_SERVE_* tolerances (the argmax share over the prefill's positions
# and over all forced steps' rows together, the gaps step by step): bf16
# partial sums over 4 ranks, added in another
# order than one product's, move logits by bf16 ulps that 32-64 random
# layers carry on (zamba2-1.2b's 38 layers moved the mean logit gap of a
# one-ulp B6 difference to 0.052, `LM_ARGMAX_MIN`'s note)
MC_SERVE_T, MC_SERVE_B, MC_SERVE_DECODE_B, MC_SERVE_MAX_LEN = 2048, 2, 8, 64
MC_SERVE_STEPS = {1: (8, 8), 4: (31, 16)}     # (forced, greedy) by W
MC_SERVE_ARGMAX_MIN, MC_SERVE_MEAN_GAP, MC_SERVE_MAX_GAP = 0.9, 0.1, 2.0
# a hybrid (zamba2-1.2b: 38 layers and an SSM state) carries bf16 rounding
# further: one card's bf16 path agrees with a float32 run of its own
# weights on 0.80 of the argmaxes, mean gap 0.0725 (`lm_serve`'s
# vs_truth). Its mesh run is held to that float32 run instead, over the
# prefill and over all forced steps: its argmax share at least one
# card's less MC_SERVE_TRUTH_SIGMAS standard deviations of the difference
# of two binomial shares of the n rows (3 sqrt(2 p (1 - p) / n): 0.027
# over the prefill's 4,096 positions at p 0.8, 0.11 over 248 forced
# rows), and its mean gap at most MC_SERVE_TRUTH_RATIO times one card's
MC_SERVE_TRUTH_SIGMAS, MC_SERVE_TRUTH_RATIO = 3.0, 1.1
MC_SERVE_TIMEOUT = 900


def ptxas_entries(log: str, names: tuple[str, ...]) -> list[dict]:
    """Registers, stack and spills of each kernel entry in nvcc's build log
    whose (mangled) name holds one of `names`. Only the lines under the
    entry's own "Function properties" header count: a `__noinline__`
    device function compiled into the same source prints its own header
    and its own stack and spill line after the entry's."""
    out, cur, own = [], None, False
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = dict(entry=m.group(1)) if any(
                n in m.group(1) for n in names) else None
            if cur is not None:
                out.append(cur)
            own = False
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            own = cur is not None and m.group(1) == cur["entry"]
            continue
        if not own:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, flush: torch.Tensor, warmup: int = 3,
            queued: bool = False) -> float:
    """Median ms of `fn()` over `reps` runs, each bracketed by CUDA events,
    with `flush` (larger than the 50 MB L2) overwritten before each run so
    that the inputs come from device memory, as a fresh micro-batch's
    packets do. The events also take in whatever host time `fn` spends
    before its launch while the card waits (a wrapper's checks and
    allocations). With `queued`, the card first spins for QUEUE_CYCLES, so
    that this host time passes while it is busy: the events then bracket
    the device's work alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def forest_touch(x: np.ndarray, forest) -> tuple[int, int, int]:
    """What one traversal of `x` must read: distinct (flow, column) values,
    internal nodes and leaves on the visited paths."""
    N = x.shape[0]
    rows = np.arange(N)
    ni = 2 ** forest.depth - 1
    x_read = np.zeros(x.shape, bool)
    nodes = leaves = 0
    for t in range(forest.feature.shape[0]):
        seen = np.zeros(2 * ni + 1, bool)
        node = np.zeros(N, np.int64)
        for _ in range(forest.depth):
            seen[node] = True
            f = forest.feature[t, node]
            x_read[rows, f] = True
            node = 2 * node + 1 + (x[rows, f] > forest.threshold[t, node])
        seen[node] = True
        nodes += int(seen[:ni].sum())
        leaves += int(seen[ni:].sum())
    return int(x_read.sum()), nodes, leaves


def host_state() -> dict:
    """The process's OS threads and the objects Python's collector tracks:
    what a host-bound loop shares the host with."""
    status = Path("/proc/self/status")
    n = [int(line.split()[1]) for line in
         (status.read_text().splitlines() if status.exists() else [])
         if line.startswith("Threads:")]
    return dict(threads=n[0] if n else None, gc_objects=len(gc.get_objects()))


def device_profile(fn, n: int, host_ops: bool = True,
                   top: int | None = 5) -> dict:
    """Device time of `n` calls of `fn`, from torch.profiler: the summed
    time of every kernel and copy on the card over the host wall time of
    the window, and the `top` largest contributors (None: all). Profiling
    adds host time, so the busy share is a lower bound. With `host_ops`
    False only the card's activity is recorded: a training step's hundred
    thousand host ops would cost the profiler about a minute to collect."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if host_ops else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key[:60], e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    return dict(calls=n, window_ms=window_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / window_ms if busy_ms > 0 else None,
                kernels=sum(r[1] for r in rows),
                top=[dict(name=k, count=c, ms=ms) for k, c, ms in rows[:top]])


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def straddle_compare(p_a, p_b, x_a, x_b, forest, what: str) -> dict:
    """Hold (N, K) probabilities p_b to p_a by the straddle rule, given the
    feature columns each side computed."""
    from repro_torch.kernels.ref import straddled_flows

    p_a, p_b = np.asarray(p_a), np.asarray(p_b)
    s = straddled_flows(x_a, x_b, forest.feature, forest.threshold, forest.depth)
    keep = ~s
    err = float(np.abs(p_a - p_b)[keep].max()) if keep.any() else 0.0
    mism = int((p_a[keep].argmax(1) != p_b[keep].argmax(1)).sum())
    out = dict(straddled=int(s.sum()), n=len(s), max_abs_err=err,
               argmax_mismatches=mism)
    check(s.sum() <= MAX_STRADDLED * len(s), f"{what}: {out}")
    check(err <= PROB_ATOL and mism == 0, f"{what}: {out}")
    return out


def quantile_forest(x: np.ndarray, rng, T=25, D=10, K=28):
    """A random depth-D forest over the columns `x` whose thresholds are
    quantile edges of those columns, as the trainer's are: ties happen."""
    from repro_torch.convert import forest_from_numpy

    F = x.shape[1]
    feature = rng.integers(0, F, (T, 2 ** D - 1))
    q = rng.random((T, 2 ** D - 1))
    threshold = np.quantile(x, q.ravel(), axis=0, method="lower")[
        np.arange(q.size), feature.ravel()].reshape(T, -1)
    return forest_from_numpy(feature, threshold, rng.random((T, 2 ** D, K)),
                             D, F)


def table_rows(stream, depth: int) -> tuple[np.ndarray, np.ndarray]:
    """Ingest the whole stream into a reuse flow table, as one worker
    would, and return the live flows' float64 aggregate rows and float32
    (proto, s_port, d_port) meta."""
    from repro_torch.serve.runtime import FlowTable

    tbl = FlowTable(2048, depth, reuse=True, refresh_every=256,
                    agg_buffer=4096)
    fid = stream.fid
    for lo in range(0, stream.n_events, 4096):
        sl = slice(lo, lo + 4096)
        f = fid[sl]
        tbl.observe_batch(stream.key[f], stream.base_t[sl],
                          stream.rel_ts32[sl], stream.size[sl],
                          stream.direction[sl], stream.ttl[sl],
                          stream.winsize[sl], stream.flags_byte[sl],
                          stream.proto[f], stream.s_port[f],
                          stream.d_port[f], f, stream.fin[sl])
    tbl.flush_agg()
    live = np.flatnonzero(tbl.ctrl["state"] != 0)
    meta = np.stack([tbl.proto[live], tbl.s_port[live], tbl.d_port[live]], 1)
    return tbl.agg[live], meta


def merged_of(reps):
    """The merged plan of N tenants and each tenant's column map."""
    from repro_torch.traffic.extraction import merge_stats_plans, stats_plan

    plans = [stats_plan(r.features) for r in reps]
    merged, cols = merge_stats_plans(plans, [r.depth for r in reps])
    return plans, merged, cols


def b4_check(config: str, ds, reps, forests, dev, flush,
             sizes=(4096, 32), timed: bool = True) -> dict:
    """B4 against its plain version and against solo B2 on one
    configuration, at each batch size of `sizes`; then, if `timed`, its
    times and bound at 4096 and 32 flows."""
    from repro_torch.convert import forest_tables, multi_forest_tables
    from repro_torch.kernels.fused_pipeline import (
        encode_merged_plan,
        encode_plan,
        fused_multi_forest_call,
        fused_multi_forest_infer_plain,
        fused_pipeline_call,
    )
    from repro_torch.traffic.extraction import dataset_tensors

    plans, merged, cols = merged_of(reps)
    tables = multi_forest_tables(forests, cols, dev)[:5]
    op = torch.from_numpy(encode_merged_plan(merged)).to(dev)
    kw = dict(op_table=op, depth=max(r.depth for r in reps),
              n_out=sum(f.n_out for f in forests))
    solo = [(forest_tables(f, dev), torch.from_numpy(encode_plan(p)).to(dev))
            for f, p in zip(forests, plans)]
    cases, out = [], dict(max_abs_err=0.0, straddled=0, argmax_mismatches=0)
    packets = {}
    for n in sizes:
        batch = ds.take(np.arange(n) % ds.n_flows)
        t = dataset_tensors(batch, dev)
        pk = packets[n] = [t[k] for k in (
            "ts", "size", "direction", "ttl", "winsize", "flags", "flow_len",
            "proto", "s_port", "d_port")]
        res = {}
        for side, fn in (("kernel", fused_multi_forest_call),
                         ("plain", fused_multi_forest_infer_plain)):
            c = torch.empty((n, len(merged)), device=dev)
            res[side] = (fn(*pk, *tables, columns=c, **kw), c)
        lanes = [fused_pipeline_call(*pk, *tabs, op_table=o, depth=r.depth,
                                     forest_depth=f.depth)
                 for (tabs, o), r, f in zip(solo, reps, forests)]
        torch.cuda.synchronize()
        (pk_, xk), (pp, xp) = ((p.cpu().numpy(), c.cpu().numpy())
                               for p, c in res.values())
        check(np.array_equal(xk, xp), f"B4 {config} N={n}: merged columns "
              "differ from the plain columns")
        lo, lanes_bitwise = 0, True
        for t_i, (f, c, lane) in enumerate(zip(forests, cols, lanes)):
            hi = lo + f.n_out
            r = straddle_compare(pp[:, lo:hi], pk_[:, lo:hi], xp[:, list(c)],
                                 xk[:, list(c)], f,
                                 f"B4 {config} N={n} tenant {t_i}")
            check(r["straddled"] == 0, f"B4 {config} N={n} tenant {t_i}: "
                  f"{r['straddled']} straddled flows")
            same = bool(np.array_equal(pk_[:, lo:hi], lane.cpu().numpy()))
            check(same, f"B4 {config} N={n} tenant {t_i}: lane differs from "
                  "solo B2")
            lanes_bitwise &= same
            out["max_abs_err"] = max(out["max_abs_err"], r["max_abs_err"])
            out["argmax_mismatches"] += r["argmax_mismatches"]
            lo = hi
        cases.append(dict(config=config, N=n, merged_columns=len(merged),
                          tenants=len(reps), k_sum=kw["n_out"],
                          union_window=min(kw["depth"], batch.max_pkts),
                          columns_bitwise=True, straddled=0,
                          probs_bitwise=bool(np.array_equal(pk_, pp)),
                          lanes_bitwise_vs_solo_b2=lanes_bitwise))
        check(cases[-1]["probs_bitwise"], f"B4 {config} N={n}: probabilities "
              "differ from the plain version's")
        if n == 4096:
            x_plain, batch_4096 = xp, batch
    if not timed:
        return dict(cases=cases, **out)
    # the bound, from this run's data: the packets each flow holds up to
    # the union depth, its metadata, the op table and spec, the forest
    # entries each tenant visits, and the (N, sum K) output
    N, P = batch_4096.n_flows, batch_4096.max_pkts
    u = max(r.depth for r in reps)
    L = np.minimum(np.minimum(batch_4096.flow_len, u), P)
    n_bytes = (int(L.sum()) * (4 * 4 + 1 + 8) + N * 16 + op.numel() * 4
               + tables[3].numel() * 4 + tables[4].numel() * 4
               + 4 * N * kw["n_out"])
    n_ops = N * sum(f.n_trees * (2 * f.depth + f.n_out) for f in forests)
    for d in sorted({d for _, d in merged}):
        dd = min(d, P) if d else 1
        n_col = sum(1 for _, dm in merged if dm == d)
        n_ops += int(np.minimum(batch_4096.flow_len, dd).sum()) * n_col
    for f, c in zip(forests, cols):
        _, nodes, leaves = forest_touch(x_plain[:, list(c)], f)
        n_bytes += 8 * nodes + 4 * f.n_out * leaves
    bound_ms, bound_by = bound(n_bytes, n_ops)
    # the kernel at 4096 and 32 flows: with the wrapper's host time, and
    # the card's alone
    calls = {sfx: (lambda n=n: fused_multi_forest_call(
        *packets[n], *tables, **kw)) for sfx, n in (("", 4096), ("_32", 32))}
    timing = dict(
        ms=time_ms(calls[""], KERNEL_REPS, flush),
        plain_ms=time_ms(lambda: fused_multi_forest_infer_plain(
            *packets[4096], *tables, **kw), PLAIN_REPS, flush),
        ms_32=time_ms(calls["_32"], KERNEL_REPS, flush),
        plain_ms_32=time_ms(lambda: fused_multi_forest_infer_plain(
            *packets[32], *tables, **kw), PLAIN_REPS, flush),
        **{f"device_ms{k}": time_ms(fn, KERNEL_REPS, flush, queued=True)
           for k, fn in calls.items()},
        # the same flows through solo B2 once per tenant, for comparison
        solo_b2_sum_ms=sum(time_ms(
            lambda tabs=tabs, o=o, r=r, f=f: fused_pipeline_call(
                *packets[4096], *tabs, op_table=o, depth=r.depth,
                forest_depth=f.depth), KERNEL_REPS, flush)
            for (tabs, o), r, f in zip(solo, reps, forests)),
        bytes=n_bytes, ops=n_ops, bound_ms=bound_ms, bound_by=bound_by,
        shape=dict(N=N, P=P, F=len(merged), tenants=len(reps),
                   k_sum=kw["n_out"], union_depth=u,
                   forests=[dict(trees=f.n_trees, depth=f.depth,
                                 classes=f.n_out) for f in forests]))
    return dict(cases=cases, timing=timing, **out)


def long_window_phase(ds_s, dev, flush, counters) -> dict:
    """B2 and B4 at windows above their shared-memory chunk, which the
    card once refused: on the stream phase's trace with the registry's
    plan (every median among it), columns and probabilities bitwise the
    plain versions'; B4's lanes bitwise solo B2; B2's time at depth 4000;
    then one replayed profiler evaluation above the buffer."""
    from repro_torch.convert import forest_tables
    from repro_torch.core.search_space import FeatureRep
    from repro_torch.kernels.fused_pipeline import (
        encode_plan,
        fused_forest_infer_plain,
        fused_pipeline_call,
    )
    from repro_torch.traffic import TrafficProfiler
    from repro_torch.traffic.extraction import (
        dataset_tensors,
        extract_features,
        stats_plan,
    )
    from repro_torch.traffic.features import FEATURE_NAMES
    from repro_torch.traffic.synth import make_scenario_dataset

    t0 = time.perf_counter()
    plan = stats_plan(FEATURE_NAMES)
    check(sum(e[-1] == "med" for e in plan) == 8, "the registry's medians")
    op = torch.from_numpy(encode_plan(plan)).to(dev)
    t = dataset_tensors(ds_s, dev)
    packets = [t[k] for k in ("ts", "size", "direction", "ttl", "winsize",
                              "flags", "flow_len", "proto", "s_port", "d_port")]
    rng = np.random.default_rng(16)
    cases, forests = [], {}
    for depth in LW_DEPTHS:
        x = extract_features(ds_s, FEATURE_NAMES, depth, device="cuda")
        forests[depth] = forest = quantile_forest(x, rng)
        tables = forest_tables(forest, dev)
        outs = {}
        for side, fn in (("kernel", fused_pipeline_call),
                         ("plain", fused_forest_infer_plain)):
            cols = torch.empty((ds_s.n_flows, len(plan)), device=dev)
            p = fn(*packets, *tables, op_table=op, depth=depth,
                   forest_depth=forest.depth, columns=cols)
            outs[side] = (p.cpu().numpy(), cols.cpu().numpy())
        (pk, xk), (pp, xp) = outs.values()
        c = dict(kernel="fused_forest_infer", depth=depth,
                 window=min(depth, ds_s.max_pkts), plan=len(plan),
                 columns_bitwise=bool(np.array_equal(xk, xp)),
                 probs_bitwise=bool(np.array_equal(pk, pp)),
                 max_abs_err=float(np.abs(pk - pp).max()))
        cases.append(c)
        check(c["columns_bitwise"] and c["probs_bitwise"], f"B2 long window {c}")
    emit("kernel_check", kernel="fused_forest_infer", config="long_window",
         cases=cases)

    # B4: the registry at two depths, the longer above the buffer
    reps = [FeatureRep(tuple(FEATURE_NAMES), depth=d) for d in LW_TENANT_DEPTHS]
    b4 = b4_check("long_window", ds_s, reps,
                  [quantile_forest(extract_features(
                      ds_s, r.features, r.depth, device="cuda"), rng)
                   for r in reps], dev, flush, sizes=(ds_s.n_flows,),
                  timed=False)
    emit("kernel_check", kernel="fused_multi_forest_infer",
         config="long_window", cases=b4["cases"])
    check(all(c["probs_bitwise"] for c in b4["cases"]),
          f"B4 long window: probabilities differ from the plain version's "
          f"{b4['cases']}")

    # B2's time at depth 4000 beside its byte bound; its plain version's
    # per-packet loops take seconds here, so it is timed once
    depth = LW_DEPTHS[-1]
    forest = forests[depth]
    tables = forest_tables(forest, dev)
    x_plain = extract_features(ds_s, FEATURE_NAMES, depth, device="cuda")
    _, nodes, leaves = forest_touch(x_plain, forest)
    N, K = ds_s.n_flows, forest.n_out
    L = np.minimum(np.minimum(ds_s.flow_len, depth), ds_s.max_pkts)
    n_bytes = (int(L.sum()) * (4 * 4 + 1 + 8) + N * 16 + op.numel() * 4
               + 8 * nodes + 4 * K * leaves + 4 * N * K)
    n_ops = int(L.sum()) * len(plan) + N * forest.n_trees * (
        2 * forest.depth + K)
    timing = dict(
        ms=time_ms(lambda: fused_pipeline_call(
            *packets, *tables, op_table=op, depth=depth,
            forest_depth=forest.depth), KERNEL_REPS, flush),
        device_ms=time_ms(lambda: fused_pipeline_call(
            *packets, *tables, op_table=op, depth=depth,
            forest_depth=forest.depth), KERNEL_REPS, flush, queued=True),
        plain_ms=time_ms(lambda: fused_forest_infer_plain(
            *packets, *tables, op_table=op, depth=depth,
            forest_depth=forest.depth), 1, flush, warmup=0),
        library_ms=None, bytes=n_bytes, ops=n_ops,
        shape=dict(N=N, P=ds_s.max_pkts, F=len(plan), depth=depth,
                   packets=int(L.sum()), T=forest.n_trees, D=forest.depth,
                   K=K))
    timing["bound_ms"], timing["bound_by"] = bound(n_bytes, n_ops)
    emit("kernel_times_long_window", timing=timing)

    # the profiler's replayed fidelity above the buffer, on the card
    tp = time.perf_counter()
    ds_p = make_scenario_dataset("app-class", "zipf", n_flows=LW_PROFILE_FLOWS,
                                 max_pkts=LW_PROFILE_PKTS, seed=3)
    prof = TrafficProfiler(ds_p, LW_PROFILE_POOL, model="tree-fast",
                           cost_metric="throughput_replayed",
                           cost_mode="measured", bisect_iters=4, seed=0,
                           device="cuda")
    rep = FeatureRep(LW_PROFILE_POOL, depth=LW_PROFILE_DEPTH)
    reset_launches(*counters.values())
    r = prof(rep)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    check(math.isfinite(r.cost) and r.cost < 0, f"replayed cost {r.cost}")
    check(launches["fused_forest_infer"] > 0,
          f"the replayed evaluation did not launch B2: {launches}")
    profiled = dict(flows=ds_p.n_flows, max_pkts=ds_p.max_pkts,
                    features=list(rep.features), depth=rep.depth,
                    flows_longer_than_buffer=int((ds_p.flow_len > 128).sum()),
                    cost=r.cost, gbps=-r.cost, f1=r.perf, launches=launches,
                    seconds=time.perf_counter() - tp)
    emit("long_window_profiler", **profiled)
    return dict(cases=cases, b4=b4, timing=timing, profiler=profiled,
                seconds=time.perf_counter() - t0)


def reset_launches(*fns) -> None:
    torch.cuda.synchronize()
    for fn in fns:
        fn.launches = 0


def multitenant_phase(ds_m, reps, forests, counters) -> dict:
    """The JAX package's multi-tenant A/B at full size on the card: one
    4-shard fleet over the fused multi-tenant pipeline (B4) against four
    1-shard fleets over the tenants' fused solo pipelines (B2)."""
    from repro_torch.serve.runtime import (
        PacketStream,
        ServiceModel,
        ShardedRuntime,
        find_zero_loss_rate,
        replay,
    )
    from repro_torch.traffic.multi_tenant import build_multi_tenant_pipeline
    from repro_torch.traffic.pipeline import build_pipeline

    stream = PacketStream.from_dataset(ds_m, seed=0)
    ring = max(64, min(6144, stream.n_events // 6))
    n_t = len(reps)
    mt = build_multi_tenant_pipeline(reps, forests, fused=True)
    solos = [build_pipeline(r, f, max_pkts=r.depth, fused=True)
             for r, f in zip(reps, forests)]

    def fleet(pipe, shards):
        def make(execute):
            return ShardedRuntime(pipe, n_shards=shards, capacity=2048,
                                  max_batch=32, flush_timeout_s=2e-4,
                                  execute=execute)
        return make

    def arm_row(pps, st, svc, launches, seconds) -> dict:
        return dict(zero_loss_pps=pps, zero_loss_gbps=st.offered_gbps,
                    drops=st.drops, latency_p50_s=st.latency_p50_s,
                    latency_p99_s=st.latency_p99_s,
                    stage_seconds=st.stage_seconds,
                    load_imbalance=st.load_imbalance,
                    flows_predicted=st.metrics.flows_predicted,
                    batches=st.metrics.batches,
                    service=dict(pkt_accum_ns=svc.pkt_accum_ns,
                                 pkt_track_ns=svc.pkt_track_ns,
                                 bucket_ns=svc.bucket_ns,
                                 gather_ns_per_flow=svc.gather_ns_per_flow),
                    launches=launches, seconds=seconds)

    arms = {}
    # shared: one fleet, every tenant from one flow table and one launch
    ta = time.perf_counter()
    make = fleet(mt, n_t)
    svc = ServiceModel.measure(make(True), stream, n_pkt_sample=16000, reps=5)
    reset_launches(*counters.values())
    pps, st = find_zero_loss_rate(stream, make, svc, iters=MT_BISECT,
                                  ring_capacity=ring)
    torch.cuda.synchronize()
    n_launch = {k: fn.launches for k, fn in counters.items()}
    arms["shared"] = arm_row(pps, st, svc, n_launch, time.perf_counter() - ta)
    arms["shared"].update(shards=n_t,
                          tenant_predictions=dict(st.metrics.tenant_predictions))
    emit("multitenant", arm="shared", **arms["shared"])
    check(st.drops == 0, f"shared arm: {st.drops} drops at its rate")
    check(len(st.predictions) == ds_m.n_flows,
          f"shared arm: {len(st.predictions)} flows predicted")
    check(n_launch["fused_multi_forest_infer"] > 0
          and n_launch["fused_forest_infer"] == 0,
          f"shared arm launches {n_launch}")

    # independent: one 1-shard fleet per tenant, each offered the whole
    # stream; the arm's rate is the slowest tenant's
    ta = time.perf_counter()
    makes = [fleet(p, 1) for p in solos]
    svcs = [ServiceModel.measure(m(True), stream, n_pkt_sample=16000, reps=5)
            for m in makes]
    reset_launches(*counters.values())
    per = []
    for t_i, (m, sv) in enumerate(zip(makes, svcs)):
        pps_t, st_t = find_zero_loss_rate(stream, m, sv, iters=MT_BISECT,
                                          ring_capacity=ring)
        per.append((pps_t, st_t, sv))
    torch.cuda.synchronize()
    n_launch = {k: fn.launches for k, fn in counters.items()}
    slow = min(range(n_t), key=lambda i: per[i][0])
    arms["independent"] = arm_row(*per[slow], n_launch,
                                  time.perf_counter() - ta)
    arms["independent"].update(
        shards=1, fleets=n_t, slowest_tenant=slow,
        drops=sum(st_t.drops for _, st_t, _ in per),
        per_tenant=[dict(zero_loss_pps=p_, zero_loss_gbps=s_.offered_gbps,
                         drops=s_.drops, latency_p50_s=s_.latency_p50_s,
                         latency_p99_s=s_.latency_p99_s,
                         stage_seconds=s_.stage_seconds)
                    for p_, s_, _ in per])
    emit("multitenant", arm="independent", **arms["independent"])
    check(arms["independent"]["drops"] == 0, "independent arm: drops at the "
          "reported rates")
    check(n_launch["fused_forest_infer"] > 0
          and n_launch["fused_multi_forest_infer"] == 0,
          f"independent arm launches {n_launch}")

    # parity: executing replays at the stream's base rate, under the
    # reference's synthetic clock constants
    tp = time.perf_counter()
    syn = ServiceModel(**MT_SERVICE)

    def run(pipe, shards):
        return replay(stream, lambda: fleet(pipe, shards)(True),
                      stream.base_pps, syn, ring_capacity=ring)

    sh = run(mt, n_t)
    keys = sorted(sh.predictions)
    lanes_ok = []
    for t_i, p in enumerate(solos):
        so = run(p, 1)
        lanes_ok.append(keys == sorted(so.predictions) and np.array_equal(
            np.asarray([sh.predictions[k][t_i] for k in keys]),
            np.asarray([so.predictions[k] for k in keys])))
    check(all(lanes_ok), f"shared fused lanes vs solo fleets: {lanes_ok}")
    unf = run(build_multi_tenant_pipeline(reps, forests, fused=False), n_t)
    check(sorted(unf.predictions) == keys, "unfused fleet predicted other flows")
    differ = sum(int(not np.array_equal(unf.predictions[k], sh.predictions[k]))
                 for k in keys)
    check(differ <= MAX_STRADDLED * len(keys),
          f"{differ} of {len(keys)} flows differ between the fused and "
          "unfused shared fleets")
    parity = dict(flows=len(keys), lanes_bitwise_vs_solo=lanes_ok,
                  unfused_flows_differ=differ,
                  seconds=time.perf_counter() - tp)
    emit("multitenant_parity", **parity)
    ratio = arms["shared"]["zero_loss_pps"] / arms["independent"]["zero_loss_pps"]
    _, merged, _ = merged_of(reps)
    summary = dict(flows=ds_m.n_flows, events=stream.n_events,
                   base_pps=stream.base_pps, ring_capacity=ring,
                   bisect_iters=MT_BISECT, tenants=n_t,
                   merged_columns=len(merged),
                   solo_columns=sum(len(r.features) for r in reps),
                   shared_over_independent_pps=ratio)
    emit("multitenant_summary", **summary)
    return dict(arms=arms, parity=parity, **summary)


def cotune_phase(counters) -> dict:
    """`examples/tune_multitenant.py` steps 1 and 2 on the port: the
    tenants tuned alone, then jointly under shared and independent
    billing; the shared run's knee served on the card; one replayed
    measurement of tenant 0's knee."""
    from repro_torch.core import CatoOptimizer, knee_index, pareto_mask
    from repro_torch.core.search_space import SearchSpace
    from repro_torch.traffic import TrafficProfiler
    from repro_torch.traffic.multi_tenant import (
        MultiTenantProfiler,
        MultiTenantSpace,
        build_multi_tenant_pipeline,
    )
    from repro_torch.traffic.synth import make_scenario_dataset

    t0 = time.perf_counter()
    ds = make_scenario_dataset("app-class", "zipf", n_flows=240, max_pkts=64,
                               seed=0)
    spaces = [SearchSpace(pool, max_depth=12) for pool in CO_POOLS]
    profs = [TrafficProfiler(ds, pool, model="tree-fast", cost_mode="modeled",
                             seed=0, device="cuda") for pool in CO_POOLS]
    # 1. each tenant alone: its front and knee
    solo = []
    for t_i, (space, prof) in enumerate(zip(spaces, profs)):
        res = CatoOptimizer(space, prof, seed=t_i, batch_size=4).run(CO_SOLO)
        front = res.pareto_observations()
        k = front[knee_index(np.array([o.objectives for o in front]))]
        solo.append(dict(front=len(front), knee_features=len(k.x.features),
                         knee_depth=k.x.depth, knee_f1=k.perf,
                         knee_cost_us=k.cost))
    # 2. jointly, shared and independent billing, rescored under both
    joint = MultiTenantSpace(tuple(spaces))
    shared_prof = MultiTenantProfiler(profs, shared=True)
    indep_prof = MultiTenantProfiler(profs, shared=False)
    res_sh = CatoOptimizer(joint, shared_prof, seed=0, batch_size=4).run(CO_ITERS)
    res_in = CatoOptimizer(joint, indep_prof, seed=0, batch_size=4).run(CO_ITERS)
    xs = list({o.x.key(): o.x for o in
               res_sh.observations + res_in.observations}.values())
    rows = [shared_prof(x) for x in xs]
    perf = np.array([r.perf for r in rows])
    cost_sh = np.array([r.aux["cost_shared_us"] for r in rows])
    cost_in = np.array([r.aux["cost_independent_us"] for r in rows])
    on_sh = pareto_mask(np.stack([cost_sh, -perf], axis=1))
    on_in = pareto_mask(np.stack([cost_in, -perf], axis=1))
    disc = np.array([r.aux["overlap_discount"] for r in rows])
    moved = int((on_sh != on_in).sum())
    check(moved > 0, "the union-plan discount changed no Pareto-optimal "
          "configuration")

    # the shared run's knee, served on the card through B4
    front = res_sh.pareto_observations()
    knee = front[knee_index(np.array([o.objectives for o in front]))]
    forests = [p.perf_f1(r)[1] for p, r in zip(profs, knee.x.reps)]
    test = profs[0].test_ds
    gpu = build_multi_tenant_pipeline(knee.x.reps, forests, fused=True)
    cpu = build_multi_tenant_pipeline(knee.x.reps, forests, fused=True,
                                      device="cpu")
    gpu.warm([1, 8, 32])
    reset_launches(*counters.values())
    cls_gpu = gpu(test)
    torch.cuda.synchronize()
    serve_launches = {k: fn.launches for k, fn in counters.items()}
    cls_cpu = cpu(test)
    check(np.array_equal(cls_gpu, cls_cpu), "the knee's classes on the card "
          "differ from the CPU plain pipeline's")
    check(serve_launches["fused_multi_forest_infer"] > 0,
          "the knee was not served through B4")

    # one replayed measurement of tenant 0's knee, clock constants timed
    # on the card's machine
    tr = time.perf_counter()
    prof_r = TrafficProfiler(ds, CO_POOLS[0], model="tree-fast",
                             cost_metric="throughput_replayed",
                             cost_mode="measured", bisect_iters=6, seed=0,
                             device="cuda")
    reset_launches(*counters.values())
    r0 = prof_r(knee.x.reps[0])
    torch.cuda.synchronize()
    replay_launches = {k: fn.launches for k, fn in counters.items()}
    check(math.isfinite(r0.cost) and r0.cost < 0, f"replayed cost {r0.cost}")
    check(replay_launches["fused_forest_infer"] > 0,
          "the replayed fidelity did not launch B2")
    out = dict(
        flows=ds.n_flows, max_pkts=ds.max_pkts, pools=len(CO_POOLS),
        solo=solo, joint_space_size=joint.size, joint_dim=joint.dim,
        observations={"shared": len(res_sh.observations),
                      "independent": len(res_in.observations)},
        distinct_configs=len(xs),
        pareto={"shared_billed": int(on_sh.sum()),
                "independent_billed": int(on_in.sum())},
        front_membership_changed=moved,
        overlap_discount={"mean": float(disc.mean()), "max": float(disc.max())},
        knee=dict(tenants=[dict(features=list(r.features), depth=r.depth)
                           for r in knee.x.reps],
                  cost_us=knee.cost, perf=knee.perf,
                  merged_columns=len(gpu.merged),
                  served_flows=test.n_flows,
                  classes_equal_cpu=True, launches=serve_launches),
        replayed=dict(tenant=0, cost=r0.cost, gbps=-r0.cost, f1=r0.perf,
                      launches=replay_launches,
                      seconds=time.perf_counter() - tr),
        seconds=time.perf_counter() - t0)
    emit("cotune", **out)
    return out


def fig5_priors(space, prof, delta=0.4):
    """`benchmarks/common.py:priors_for`: the priors from the profiler's
    training columns at the space's deepest depth."""
    from repro_torch.core import build_priors

    X = prof.matrices_at_depth(space.max_depth)[0]
    idx = [prof.feature_names.index(f) for f in space.feature_names]
    return build_priors(space, X[:, idx], prof.train_ds.label, delta=delta)


def fig5_baselines(space, prof, depths) -> dict:
    """`fig5_serving_perf._baselines`: ALL, MI10 and RFE10 at each depth,
    selected on the profiler's training columns."""
    from repro_torch.core.baselines import (
        select_all,
        select_mi_topk,
        select_rfe_topk,
    )

    prof.matrices_at_depth(space.max_depth)  # warm the full-depth cache
    y = prof.train_ds.label
    out = {}
    for n in depths:
        Xd = prof.matrices_at_depth(n)[0]
        out[f"ALL@{n}"] = select_all(space, n)
        out[f"MI10@{n}"] = select_mi_topk(space, n, Xd, y, k=10)
        out[f"RFE10@{n}"] = select_rfe_topk(space, n, Xd, y, k=10)
    return out


def fig5_summarize(rows) -> dict:
    """`fig5_serving_perf.summarize`: each baseline's rate over the
    slowest CATO point whose F1 is at least the baseline's less 0.01."""
    cato = [(r[4], r[3]) for r in rows if r[0] == "CATO"]
    out = {}
    for label, cost, f1 in ((r[0], r[4], r[3]) for r in rows if r[0] != "CATO"):
        elig = [c for c, p in cato if p >= f1 - 0.01]
        if elig:
            out[label] = cost / min(elig)
    return out


def fig5_replayed(device, *, use_case="app", iters=25, n_flows=1500,
                  max_pkts=48, depths=(10,), bisect_iters=8,
                  cost_mode="measured", model="tree-fast", seed=1):
    """Fig. 5c measured through the port's streaming runtime on one worker,
    `benchmarks/fig5_serving_perf.py:run_replayed` step for step: CATO
    searches against the modeled throughput metric; then each Pareto point
    and each ALL / MI10 / RFE10 baseline at each of `depths` is trained and
    its zero-loss rate bisected by `TrafficProfiler.replayed_throughput_gbps`
    (the fused pipeline, B2 on the card, under `cost_mode`'s clock).
    Returns (rows in FIG5_HEADER order, the profiler)."""
    from repro_torch.core import CatoOptimizer, SearchSpace
    from repro_torch.traffic import FEATURE_NAMES, TrafficProfiler
    from repro_torch.traffic.synth import make_scenario_dataset

    name = "app-class" if use_case == "app" else "iot-class"
    ds = make_scenario_dataset(name, "uniform", n_flows=n_flows,
                               max_pkts=max_pkts, seed=seed)
    prof = TrafficProfiler(ds, FEATURE_NAMES, model=model,
                           cost_metric="throughput", cost_mode="modeled",
                           scenario="uniform", seed=seed, device=device)
    space = SearchSpace(FEATURE_NAMES, max_depth=min(50, max_pkts))
    res = CatoOptimizer(space, prof, fig5_priors(space, prof),
                        seed=0).run(iters)
    prof.cost_mode = cost_mode

    def measure(label, rep):
        f1, forest = prof.perf_f1(rep)
        gbps, st = prof.replayed_throughput_gbps(
            rep, forest, bisect_iters=bisect_iters, n_shards=1)
        total = sum(st.stage_seconds.values()) if st.stage_seconds else 0.0
        shares = tuple(round(st.stage_seconds.get(k, 0.0) / total, 4)
                       if total > 0 else 0.0
                       for k in ("ingest", "infer", "flush"))
        return (label, rep.depth, len(rep.features), round(f1, 4),
                round(gbps, 4), round(st.offered_pps, 1),
                round(st.latency_p50_s, 6), round(st.latency_p99_s, 6),
                st.drops, st.metrics.compile_count(), "agg", "uniform",
                "static", round(st.load_imbalance, 4), *shares)

    rows = [measure("CATO", o.x) for o in res.pareto_observations()]
    # the baselines' space reaches the trace's whole connection (space_cap)
    whole = SearchSpace(FEATURE_NAMES, max_depth=ds.max_pkts)
    for label, rep in fig5_baselines(whole, prof, depths).items():
        rows.append(measure(label, rep))
    return rows, prof


def fig5_phase(counters) -> dict:
    """The paper's Fig. 5c on the card: CATO's Pareto points against the
    ALL / MI10 / RFE10 baselines at depths 10 and 48, each measured through
    B2; 0 drops at every reported rate, the profiler's feature matrices
    bitwise the CPU's at every depth the phase used, and B2 launched."""
    from repro_torch.traffic.extraction import extract_features

    t0 = time.perf_counter()
    reset_launches(*counters.values())
    rows, prof = fig5_replayed("cuda", **FIG5)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    seconds = time.perf_counter() - t0
    recs = [dict(zip(FIG5_HEADER, r)) for r in rows]
    for r in recs:
        emit("fig5", **r)
    check(all(r["drops"] == 0 for r in recs),
          "fig5: drops at a reported zero-loss rate")
    check(launches["fused_forest_infer"] > 0, "fig5: B2 was not launched")

    # the card's feature matrices at every depth the phase used, bitwise
    # the CPU plain version's
    t1 = time.perf_counter()
    depths = sorted(prof._matrix_cache)
    differ = {}
    for d in depths:
        for side, part, got in zip(("train", "test"),
                                   (prof.train_ds, prof.test_ds),
                                   prof._matrix_cache[d]):
            want = extract_features(part, prof.feature_names, d, device="cpu")
            bad = np.nonzero((got != want).any(axis=0))[0]
            if len(bad):
                differ[f"{side}@{d}"] = [prof.feature_names[i] for i in bad]
    check(not differ, f"fig5: card matrices differ from the CPU's: {differ}")

    cato = [r for r in recs if r["method"] == "CATO"]
    best = max(cato, key=lambda r: r["zero_loss_gbps"])
    base = [r for r in recs if r["method"] != "CATO"]
    out = dict(
        config=FIG5, nvidia_smi=nvidia_smi(), cato_points=len(cato),
        cato_best_gbps=best["zero_loss_gbps"], cato_best_f1=best["f1"],
        cato_best_depth=best["depth"],
        gain_vs_baseline={r["method"]: best["zero_loss_gbps"] / r["zero_loss_gbps"]
                          for r in base if r["zero_loss_gbps"] > 0},
        f1_matched=fig5_summarize(rows),
        # the fastest CATO point within 0.01 of each baseline's F1, over it
        f1_matched_gain={r["method"]: max(
            (c["zero_loss_gbps"] for c in cato if c["f1"] >= r["f1"] - 0.01),
            default=0.0) / r["zero_loss_gbps"]
            for r in base if r["zero_loss_gbps"] > 0},
        cato_best_f1_matched={r["method"]: best["f1"] >= r["f1"] - 0.01
                              for r in base},
        zero_drops_at_reported_rate=True,
        matrices_bitwise_cpu_depths=depths,
        matrices_check_seconds=time.perf_counter() - t1,
        launches=launches, seconds=seconds)
    emit("fig5_summary", **out)
    return out


def b5_inputs(ds, ds_s) -> dict:
    """B5's cases as numpy (values, mask): the main path's two windows,
    packet sizes masked by each flow's valid packets (the iot-class window,
    4000 x 128, and the stream trace padded to 600 x 4000), then ragged
    and edge shapes of random sizes (seed 15) and an all-empty mask."""
    cases = {}
    for name, d in (("iot_window", ds), ("stream_trace", ds_s)):
        valid = np.arange(d.max_pkts)[None, :] < d.flow_len[:, None]
        cases[name] = (np.ascontiguousarray(d.size, np.float32), valid)
    rng = np.random.default_rng(15)
    for n, P in B5_RAGGED:
        m = rng.random((n, P)) < 0.4
        m[0] = False
        cases[f"ragged_{n}x{P}"] = (
            (rng.random((n, P)) * 1500).astype(np.float32), m)
    v, m = cases["ragged_1000x128"]
    cases["empty_1000x128"] = (v, np.zeros_like(m))
    return cases


def b5_check(cases: dict, dev, flush) -> dict:
    """B5's path, then B5 against its plain version, then its times.

    The path: the entry point `ops.flow_stats` on the main path's two
    windows (bool masks) on the card, with the launch counter set to 0 just
    before and read just after; each result held against the plain version
    run on the CPU over the same arrays (count, min, max exact, sums to
    rtol 1e-6). Every case (the iot window with bool, uint8 and int32 masks)
    is held bitwise against the plain version on the card. Then its time,
    the plain version's and that of the five masked torch reductions
    computing the same function, at the two windows."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.feature_extract import (
        flow_stats_kernel_call,
        flow_stats_plain,
    )
    from repro_torch.kernels.ref import flow_stats_ref

    windows = ("iot_window", "stream_trace")
    ins = {k: (torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev))
           for k, (v, m) in cases.items()}
    reset_launches(flow_stats_kernel_call)
    outs = {(k, torch.bool): ops.flow_stats(*ins[k]) for k in windows}
    torch.cuda.synchronize()
    launches = flow_stats_kernel_call.launches
    check(launches == len(windows), f"B5 launched {launches} times on its path")
    path = {}
    for k in windows:
        v, m = cases[k]
        got = outs[k, torch.bool].cpu().numpy()
        cpu = flow_stats_plain(torch.from_numpy(v), torch.from_numpy(m)).numpy()
        check(got.shape == (v.shape[0], 5) and np.isfinite(got).all(),
              f"B5 {k}: shape {got.shape}")
        check(np.array_equal(got[:, 0], m.sum(1)), f"B5 {k}: counts")
        check(np.array_equal(got[:, [0, 3, 4]], cpu[:, [0, 3, 4]])
              and np.allclose(got[:, 1:3], cpu[:, 1:3], rtol=1e-6, atol=0),
              f"B5 {k}: differs from the CPU plain version")
        path[k] = dict(N=v.shape[0], P=v.shape[1], valid=int(m.sum()),
                       bitwise_cpu=bool(np.array_equal(got, cpu)),
                       max_sumsq=float(got[:, 2].max()))
    rows = []
    for name, (v, m) in cases.items():
        vt, mb = ins[name]
        dtypes = ((torch.bool, torch.uint8, torch.int32)
                  if name == "iot_window" else (torch.bool,))
        for dt in dtypes:
            mt = mb.to(dt)
            got = outs.get((name, dt))
            if got is None:
                got = ops.flow_stats(vt, mt)
            want = flow_stats_plain(vt, mt)
            torch.cuda.synchronize()
            rows.append(dict(case=name, N=v.shape[0], P=v.shape[1],
                             mask=str(dt), valid=int(m.sum()),
                             bitwise=bool(torch.equal(got, want)),
                             max_abs_err=float((got - want).abs().max()),
                             empty_rows_zero=bool(
                                 (got[torch.from_numpy(~m.any(1)).to(dev)]
                                  == 0).all())))
            check(rows[-1]["bitwise"] and rows[-1]["empty_rows_zero"],
                  f"B5 {rows[-1]}")
    timing = {}
    for name in windows:
        v, m = cases[name]
        N, P = v.shape
        vt, mt = ins[name]

        def kernel():
            return flow_stats_kernel_call(vt, mt)

        # each value and mask byte read once, five floats written a row
        t = dict(ms=time_ms(kernel, KERNEL_REPS, flush),
                 device_ms=time_ms(kernel, KERNEL_REPS, flush, queued=True),
                 # the floor under any launch: a kernel that does nothing
                 # (the card's spin kernel asked for 0 cycles), queued
                 empty_launch_device_ms=time_ms(
                     lambda: torch.cuda._sleep(0), KERNEL_REPS, flush,
                     queued=True),
                 plain_ms=time_ms(lambda: flow_stats_plain(vt, mt),
                                  PLAIN_REPS, flush),
                 torch_ops_ms=time_ms(lambda: flow_stats_ref(vt, mt),
                                      KERNEL_REPS, flush),
                 library_ms=None, bytes=N * P * 5 + N * 20,
                 ops=B5_OPS_PER_ELEMENT * N * P, shape=[N, P],
                 valid=int(m.sum()))
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"])
        timing[name] = t
    return dict(launches=launches, path=path, cases=rows, timing=timing,
                max_abs_err=max(r["max_abs_err"] for r in rows))


def load_drive(name: str):
    """`examples_torch/<name>.py` of this checkout as a module: the phases
    run the drives' own step functions."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_drive(name: str) -> dict:
    """The drive's main with ``--device cuda``, its printout sent to
    stderr; it raises if one of its own checks fails."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = load_drive(name).main(["--device", "cuda"])
    return dict(res, seconds=time.perf_counter() - t0)


def control_phase(counters) -> dict:
    """The JAX package's control-plane skew gate at full size on the card
    (see phase 9), through `examples_torch/serve_control.py`'s acts: static
    against dynamic RETA, a hot-swap through the deploy layer, elastic
    sizing, an observability bundle; then a multi-tenant swap."""
    from repro_torch.serve import (
        BundlePoint,
        ControlConfig,
        DriftMonitor,
        LatencyConfig,
        MetricsExporter,
        Observability,
        ServeSession,
        ServiceModel,
        SLOConfig,
        SLOTracker,
        Tracer,
        check_prometheus,
        compile_multi_tenant,
        make_swap,
        replay,
    )
    from repro_torch.serve.deploy import _forest_to_doc

    ctl = load_drive("serve_control")
    t0 = time.perf_counter()
    ds, stream, reps, forests, pipe_a = ctl.deployment(
        "cuda", n_flows=CTRL_FLOWS, max_pkts=CTRL_PKTS)
    ring = max(64, stream.n_events // 16)

    def fleet(execute=False, shards=4, capacity=2048, pipe=pipe_a):
        return ctl.fleet_of(pipe, shards, capacity)(execute)

    svc_a = ServiceModel.measure(fleet(True), stream, n_pkt_sample=16000,
                                 reps=5)
    reset_launches(*counters.values())

    # 1. static against dynamic RETA; 4. the bundle rides the dynamic
    # search's final replay
    ta = time.perf_counter()
    obs = Observability(
        tracer=Tracer(capacity=1 << 16, sample=0.25, seed=0),
        drift=DriftMonitor(), latency=LatencyConfig(),
        slo=SLOTracker(SLOConfig(target_s=2e-3, objective=0.99,
                                 window_s=5e-3, slow_windows=4)),
        exporter=MetricsExporter())
    r_st, s_st, r_dy, s_dy = ctl.rebalance(stream, fleet, svc_a,
                                           iters=CTRL_BISECT, ring=ring,
                                           obs=obs)
    rebalance = dict(
        static=dict(zero_loss_pps=r_st, zero_loss_gbps=s_st.offered_gbps,
                    drops=s_st.drops, load_imbalance=s_st.load_imbalance,
                    latency_p50_s=s_st.latency_p50_s,
                    latency_p99_s=s_st.latency_p99_s,
                    stage_seconds=s_st.stage_seconds,
                    batches=s_st.metrics.batches),
        dynamic=dict(zero_loss_pps=r_dy, zero_loss_gbps=s_dy.offered_gbps,
                     drops=s_dy.drops, load_imbalance=s_dy.load_imbalance,
                     latency_p50_s=s_dy.latency_p50_s,
                     latency_p99_s=s_dy.latency_p99_s,
                     stage_seconds=s_dy.stage_seconds,
                     batches=s_dy.metrics.batches,
                     flushes_migrate=s_dy.metrics.flushes_migrate,
                     buckets_moved=s_dy.control["buckets_moved"],
                     flows_migrated=s_dy.control["flows_migrated"],
                     rebalances=s_dy.control["rebalances"]),
        dynamic_over_static_pps=r_dy / r_st,
        seconds=time.perf_counter() - ta)
    emit("control", act="rebalance", **rebalance)
    check(s_st.drops == 0 and s_dy.drops == 0,
          f"drops at the zero-loss rates: {s_st.drops}, {s_dy.drops}")
    check(s_dy.load_imbalance <= s_st.load_imbalance,
          f"dynamic imbalance {s_dy.load_imbalance} above static "
          f"{s_st.load_imbalance}")
    text = obs.exporter.prometheus()
    problems = check_prometheus(text)
    observability = dict(
        prometheus_lines=len(text.splitlines()), prometheus_problems=problems,
        exporter_steps=obs.exporter.steps, audit=obs.audit.summary(),
        drift=dict((k, obs.drift.signal()[k]) for k in (
            "n_batches", "n_flows", "class_mix_shift", "max_class_shift")),
        slo=dict((k, obs.slo.signal()[k]) for k in (
            "samples", "violations", "attainment", "breaches")),
        trace=obs.tracer.summary())
    emit("control", act="observability", **observability)
    check(problems == [] and obs.exporter.steps > 0,
          f"the exporter's Prometheus text: {problems[:3]}")

    # 2. a mid-replay hot-swap onto rep_b, built through the deploy layer
    ta = time.perf_counter()
    point_b = BundlePoint(rep=reps["b"], cost=0.0, perf=0.0,
                          fidelity="trained", aux={},
                          compile_meta={"fused": True},
                          forest_doc=_forest_to_doc(forests["b"]))
    pipe_b = point_b.build(runtime=fleet(), device="cuda")
    svc_b = ServiceModel.measure(fleet(True, pipe=pipe_b), stream,
                                 n_pkt_sample=16000, reps=5)
    swap = make_swap(point_b, after_pkts=stream.n_events // 2, runtime=fleet(),
                     service=svc_b)
    rate = min(stream.base_pps, 0.5 * r_dy)
    swapped, post, agree = ctl.hot_swap(
        ds, stream, fleet, swap, svc_a, rate,
        lambda: fleet(True, pipe=pipe_b), ring=ring)
    m = swapped.metrics
    hot_swap = dict(offered_pps=rate, drops=swapped.drops,
                    flows_predicted=len(swapped.predictions),
                    flows=ds.n_flows,
                    duplicate_predictions=m.duplicate_predictions,
                    swaps=swapped.control["swaps"],
                    swap_at_pkts=swapped.control.get("swap_at_pkts"),
                    flushes_swap=m.flushes_swap,
                    post_swap_flows=len(post), post_swap_equal_new_only=agree,
                    pipe_b_device=str(pipe_b.device),
                    seconds=time.perf_counter() - ta)
    emit("control", act="hot_swap", **hot_swap)
    check(swapped.drops == 0 and len(swapped.predictions) == ds.n_flows
          and m.duplicate_predictions == 0 and swapped.control["swaps"] == 1,
          f"hot-swap: {hot_swap}")
    check(agree == len(post) > 0, f"post-swap flows: {agree} of {len(post)} "
          "equal the new pipeline's own replay")

    # 3. elastic scale-out and scale-in around the static fleet's rate
    ta = time.perf_counter()
    rates = {"high": 2.0 * r_st, "low": r_st / 40}
    runs = ctl.elastic(stream, lambda: fleet(shards=2, capacity=4096), svc_a,
                       rates)
    scaling = {k: dict(offered_pps=rates[k], drops=st.drops,
                       active_workers=st.control["active_workers"],
                       workers_added=st.control["workers_added"],
                       workers_retired=st.control["workers_retired"])
               for k, st in runs.items()}
    scaling["seconds"] = time.perf_counter() - ta
    emit("control", act="elastic", **scaling)
    check(scaling["high"]["workers_added"] > 0
          and scaling["low"]["workers_retired"] > 0, f"elastic: {scaling}")

    # 5. a multi-tenant bundle (tenants a, b; B4) compiled on the card by
    # compile_multi_tenant, hot-swapped mid-replay onto the bundle of the
    # same tenants in the other lane order
    ta = time.perf_counter()
    point_a = BundlePoint(rep=reps["a"], cost=1.0, perf=0.5,
                          fidelity="trained", aux={},
                          compile_meta={"fused": True},
                          forest_doc=_forest_to_doc(forests["a"]))
    mt_start = compile_multi_tenant([point_a, point_b], runtime=fleet(),
                                    device="cuda")
    mt_target = compile_multi_tenant([point_b, point_a], runtime=fleet(),
                                     device="cuda")
    swap = make_swap(mt_target, after_pkts=stream.n_events // 2,
                     runtime=fleet())
    mt_swapped = replay(
        stream, lambda: fleet(True, pipe=mt_start.pipeline),
        stream.base_pps, swap.service, ring_capacity=ring,
        session=ServeSession(control=ControlConfig(
            interval_pkts=512, rebalance=False, swap=swap)))
    shapes = {np.asarray(v).shape for v in mt_swapped.predictions.values()}
    multi_tenant = dict(offered_pps=stream.base_pps, drops=mt_swapped.drops,
                        flows_predicted=len(mt_swapped.predictions),
                        duplicate_predictions=(
                            mt_swapped.metrics.duplicate_predictions),
                        swaps=mt_swapped.control["swaps"],
                        prediction_shapes=sorted(shapes),
                        pipe_devices=[str(mt_start.pipeline.device),
                                      str(mt_target.pipeline.device)],
                        seconds=time.perf_counter() - ta)
    emit("control", act="multi_tenant_swap", **multi_tenant)
    check(mt_swapped.drops == 0 and mt_swapped.control["swaps"] == 1
          and len(mt_swapped.predictions) == ds.n_flows
          and mt_swapped.metrics.duplicate_predictions == 0
          and shapes == {(2,)}, f"multi-tenant swap: {multi_tenant}")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    check(launches["fused_forest_infer"] > 0
          and launches["fused_multi_forest_infer"] > 0,
          f"the control phase did not launch B2 and B4: {launches}")
    out = dict(flows=ds.n_flows, max_pkts=ds.max_pkts, events=stream.n_events,
               base_pps=stream.base_pps, shards=4, bisect_iters=CTRL_BISECT,
               ring_capacity=ring,
               service=dict(a=dict(pkt_accum_ns=svc_a.pkt_accum_ns,
                                   pkt_track_ns=svc_a.pkt_track_ns,
                                   bucket_ns=svc_a.bucket_ns),
                            b=dict(pkt_accum_ns=svc_b.pkt_accum_ns,
                                   pkt_track_ns=svc_b.pkt_track_ns,
                                   bucket_ns=svc_b.bucket_ns)),
               launches=launches, seconds=time.perf_counter() - t0)
    emit("control_summary", **out)

    # the drive itself at its reference's size, with its own checks
    reset_launches(*counters.values())
    drive = run_drive("serve_control")
    torch.cuda.synchronize()
    drive["launches"] = {k: fn.launches for k, fn in counters.items()}
    emit("drive", name="serve_control", **drive)
    check(drive["launches"]["fused_forest_infer"] > 0,
          f"serve_control.py did not launch B2: {drive['launches']}")
    return dict(rebalance=rebalance, hot_swap=hot_swap, elastic=scaling,
                multi_tenant_swap=multi_tenant, observability=observability,
                drive=drive, **out)


def selftune_phase(counters) -> dict:
    """`examples_torch/selftune_fleet.py` on the card (see phase 10), with
    ``--device cuda``: a frozen stale knee against a fleet that re-tunes
    itself when the class mix drifts and hot-swaps the new knee, compiled
    on the card; the drive's own checks, then this phase's."""
    reset_launches(*counters.values())
    out = run_drive("selftune_fleet")
    torch.cuda.synchronize()
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    emit("selftune", **out)
    check(out["retune_devices"] == ["cuda"],
          f"the re-tune ran on {out['retune_devices']}")
    check(out["launches"]["fused_forest_infer"] > 0,
          f"the selftune phase did not launch B2: {out['launches']}")
    return out


@contextlib.contextmanager
def plain_kernels():
    """Run the model path on the plain versions of B6-B8, on the card: the
    dispatchers in `repro_torch.kernels.ops`, which the layers call, are
    swapped for the plain functions while the block runs. B6 and B8 stay
    differentiable: their autograd functions with the plain pairs (B6's
    and B6b's, B8's and B8b's plain versions), which build no graph where
    no gradient is wanted."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.kernels.mamba_scan import MambaScan

    def flash_attention(q, k, v, *, causal=True, scale=None):
        return FlashAttention.apply(q, k, v, causal, scale, True)

    def mamba_scan(x, dt, A, Bm, Cm, *, chunk=128):
        return MambaScan.apply(x, dt, A, Bm, Cm, chunk, True)

    saved = ops.flash_attention, ops.decode_attention, ops.mamba_scan
    ops.flash_attention, ops.mamba_scan = flash_attention, mamba_scan
    ops.decode_attention = decode_attention_plain
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention, ops.mamba_scan = saved


def ops_rate(dtype: torch.dtype) -> float:
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S


def lm_kernel_phase(dev, flush) -> dict:
    """B6, B7 and B8 against their plain versions on the card, then their
    times at the main-path shapes. Inputs: normal draws on the card from
    seed 14, scaled as tests/test_kernels.py scales them."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention_kernel_call,
        decode_attention_plain,
        split_plan,
    )
    from repro_torch.kernels.flash_attention import (
        flash_attention_kernel_call,
        flash_attention_plain,
        tile_width,
    )
    from repro_torch.kernels.mamba_scan import (
        mamba_scan_kernel_call,
        mamba_scan_plain,
        scan_scratch_shapes,
    )

    gen = torch.Generator(device=dev).manual_seed(14)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    # B6: (B, Hq, Hkv, Tq, Tk, D); its plain version repeats each
    # instantiation's arithmetic (a small D on rows zero-padded to the
    # kernel's tile width), so the two agree to the last bit
    fa_inputs, fa_causal, da_inputs, cases = {}, {}, {}, []

    def check_b6(case_list):
        for name, (B, Hq, Hkv, Tq, Tk, D), dtype, causals in case_list:
            q = randn((B, Hq, Tq, D), dtype)
            k, v = randn((B, Hkv, Tk, D), dtype), randn((B, Hkv, Tk, D), dtype)
            fa_inputs[name], fa_causal[name] = (q, k, v), causals[0]
            for causal in causals:
                got = flash_attention_kernel_call(q, k, v, causal=causal)
                want = flash_attention_plain(q, k, v, causal=causal)
                cases.append(dict(
                    kernel="flash_attention", case=name,
                    shape=[B, Hq, Hkv, Tq, Tk, D], causal=causal,
                    dtype=str(dtype), max_abs_err=err(got, want),
                    bitwise=bool(torch.equal(got, want)), tol=0.0,
                    tile_width=tile_width(D)))
                check(cases[-1]["bitwise"], f"B6 {cases[-1]}")

    # B7: (B, Hq, Hkv, S, D), lengths in [1, S] (or as given); the plain
    # version repeats the split kernel's arithmetic, so the two agree to
    # the last bit, the rows' statistics (M, L) too; `out` is the same
    # with or without them
    def check_b7(case_list):
        for name, (B, Hq, Hkv, S, D), dtype, length in case_list:
            q = randn((B, Hq, D), dtype)
            kc, vc = randn((B, S, Hkv, D), dtype), randn((B, S, Hkv, D), dtype)
            if length is None:
                lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                                     dtype=torch.int32)
                lens[-1] = S
            elif isinstance(length, tuple):
                lens = torch.tensor(length, device=dev, dtype=torch.int32)
            else:
                lens = torch.full((B,), length, device=dev, dtype=torch.int32)
            da_inputs[name] = (q, kc, vc, lens)
            got = decode_attention_kernel_call(q, kc, vc, lens)
            want = decode_attention_plain(q, kc, vc, lens)
            got_s, st = decode_attention_kernel_call(q, kc, vc, lens,
                                                     stats=True)
            want_s, st_plain = decode_attention_plain(q, kc, vc, lens,
                                                      stats=True)
            n_split, split_len = split_plan(B, Hkv, S)
            cases.append(dict(kernel="decode_attention", case=name,
                              shape=[B, Hq, Hkv, S, D], lengths=lens.tolist(),
                              dtype=str(dtype), max_abs_err=err(got, want),
                              bitwise=bool(torch.equal(got, want)), tol=0.0,
                              stats_max_abs_err=err(st, st_plain),
                              stats_bitwise=bool(torch.equal(st, st_plain)),
                              out_unchanged_with_stats=bool(
                                  torch.equal(got_s, got)
                                  and torch.equal(want_s, want)),
                              n_split=n_split, split_len=split_len,
                              blocks=B * Hkv * n_split,
                              tile_width=tile_width(D)))
            check(cases[-1]["bitwise"] and cases[-1]["stats_bitwise"]
                  and cases[-1]["out_unchanged_with_stats"], f"B7 {cases[-1]}")

    check_b6(LM_B6_CASES)
    check_b7(LM_B7_CASES)
    # B8: (B, T, H, P, S)
    ms_inputs = {}
    for name, (B, T, H, P, S), dtype in LM_B8_CASES:
        x = randn((B, T, H, P), dtype, 0.5)
        dt = randn((B, T, H), scale=0.1).abs() + 0.01
        A = -randn((H,)).abs() - 0.1
        Bm, Cm = randn((B, T, S), dtype, 0.3), randn((B, T, S), dtype, 0.3)
        ms_inputs[name] = (x, dt, A, Bm, Cm)
        y, h = mamba_scan_kernel_call(x, dt, A, Bm, Cm)
        y_p, h_p = mamba_scan_plain(x, dt, A, Bm, Cm)
        scratch = scan_scratch_shapes(B, T, H, P, S)
        cases.append(dict(kernel="mamba_scan", case=name, shape=[B, T, H, P, S],
                          chunk=128, dtype=str(dtype), max_abs_err=err(y, y_p),
                          state_max_abs_err=err(h, h_p),
                          bitwise=bool(torch.equal(y, y_p)),
                          state_bitwise=bool(torch.equal(h, h_p)), tol=0.0,
                          blocks=B * H * scratch[0][2],
                          scratch_bytes=4 * sum(map(math.prod, scratch))))
        check(cases[-1]["bitwise"] and cases[-1]["state_bitwise"],
              f"B8 {cases[-1]}")
    # the small head dims, on rows zero-padded to the kernels' tile width
    check_b6(LM_SMALL_B6_CASES)
    check_b7(LM_SMALL_B7_CASES)
    # whisper-small's: non-causal, Tq != Tk, and decode at mem_len
    check_b6(LM_WHISPER_B6_CASES)
    check_b7(LM_WHISPER_B7_CASES)
    check_b7(LM_SEQ_B7_CASES)
    torch.cuda.synchronize()
    for c in cases:
        emit("lm_kernel_check", **c)

    # times at the main-path shapes, with bounds from these inputs
    timing = {}
    for name in LM_TIMED_B6:
        q, k, v = fa_inputs[name]
        causal = fa_causal[name]
        B, Hq, Tq, D = q.shape
        Tk = k.shape[2]
        # the (query, key) pairs attended: causal cases here have Tq = Tk
        pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk

        def kernel():
            return flash_attention_kernel_call(q, k, v, causal=causal)

        t = dict(
            ms=time_ms(kernel, KERNEL_REPS, flush),
            device_ms=time_ms(kernel, KERNEL_REPS, flush, queued=True),
            plain_ms=time_ms(lambda: flash_attention_plain(q, k, v,
                                                           causal=causal),
                             PLAIN_REPS, flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), KERNEL_REPS,
                flush),
            bytes=q.element_size() * (2 * q.numel() + k.numel() + v.numel()),
            ops=4 * D * pairs * B * Hq, shape=list(q.shape) + [Tk],
            causal=causal, dtype=str(q.dtype))
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"],
                                             ops_rate(q.dtype))
        t["tflops"] = t["ops"] / (t["ms"] * 1e-3) / 1e12
        t["library_tflops"] = t["ops"] / (t["library_ms"] * 1e-3) / 1e12
        timing[f"flash_attention/{name}"] = t
    # B7 at qwen3-8b's timed shape, at zamba2-1.2b's served cache, at the
    # reduced qwen3-8b's heads and head dim and at whisper-small's served
    # cross-attention decode
    for name in LM_TIMED_B7:
        q, kc, vc, lens = da_inputs[name]
        B, Hq, D = q.shape
        S, Hkv = kc.shape[1], kc.shape[2]
        n_valid = int(lens.sum())
        mask = (torch.arange(S, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        def kernel():
            return decode_attention_kernel_call(q, kc, vc, lens)

        def library():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                  enable_gqa=True)

        def kernel_stats():
            return decode_attention_kernel_call(q, kc, vc, lens, stats=True)

        t = dict(
            ms=time_ms(kernel, KERNEL_REPS, flush),
            plain_ms=time_ms(lambda: decode_attention_plain(q, kc, vc, lens),
                             PLAIN_REPS, flush),
            library_ms=time_ms(library, KERNEL_REPS, flush),
            device_ms=time_ms(kernel, KERNEL_REPS, flush, queued=True),
            # with the rows' (M, L) written too (decode over a cache cut by
            # sequence)
            stats_ms=time_ms(kernel_stats, KERNEL_REPS, flush),
            stats_device_ms=time_ms(kernel_stats, KERNEL_REPS, flush,
                                    queued=True),
            library_device_ms=time_ms(library, KERNEL_REPS, flush,
                                      queued=True),
            # q and out, the valid K and V rows, the lengths
            bytes=q.element_size() * (2 * q.numel() + 2 * n_valid * Hkv * D)
            + 4 * B,
            ops=4 * D * Hq * n_valid, shape=[B, Hq, Hkv, S, D],
            dtype=str(q.dtype),
            valid_positions=n_valid, split=list(split_plan(B, Hkv, S)))
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"],
                                             ops_rate(q.dtype))
        timing[f"decode_attention/{name}"] = t
    x, dt, A, Bm, Cm = ms_inputs["zamba2-1.2b"]
    B, T, H, P = x.shape
    S, c = Bm.shape[-1], 128
    tri = c * (c + 1) // 2
    per_chunk = tri * 2 * S + tri * 2 * P + 4 * c * P * S
    scratch = scan_scratch_shapes(B, T, H, P, S, c)

    def scan():
        return mamba_scan_kernel_call(x, dt, A, Bm, Cm)

    t = dict(
        ms=time_ms(scan, KERNEL_REPS, flush),
        device_ms=time_ms(scan, KERNEL_REPS, flush, queued=True),
        plain_ms=time_ms(lambda: mamba_scan_plain(x, dt, A, Bm, Cm),
                         PLAIN_REPS, flush),
        library_ms=None, blocks=B * H * scratch[0][2],
        scratch_bytes=4 * sum(map(math.prod, scratch)),
        # x and y, dt, A, Bm and Cm, the final state
        bytes=2 * 2 * x.numel() + 4 * dt.numel() + 4 * H + 2 * 2 * Bm.numel()
        + 4 * B * H * P * S,
        ops=B * H * (T // c) * per_chunk, shape=[B, T, H, P, S], chunk=c)
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"], ops_rate(x.dtype))
    # the device time of each of the kernel's four passes
    t["passes"] = [dict(name=r["name"], ms=r["ms"] / r["count"])
                   for r in device_profile(scan, 10)["top"]
                   if "kernel" in r["name"]]
    timing["mamba_scan/zamba2-1.2b"] = t
    return dict(cases=cases, timing=timing)


def train_kernel_phase(dev, flush) -> dict:
    """B6b and B8b against their plain versions on the card (bitwise, and
    bitwise again on a second launch: no atomics), then their times at
    zamba2-1.2b's training shapes beside the plain versions (the check's
    own run, host ms to a synchronised result), the bound and, for B6b,
    autograd's backward of `scaled_dot_product_attention` (each launch's
    device ms comes from the traced training step: `launch_times`).
    Inputs: normal draws on the card from seed 15."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel_call,
        flash_attention_bwd_plain,
        flash_attention_kernel_call,
    )
    from repro_torch.kernels.mamba_scan import (
        bwd_scratch_shapes,
        mamba_scan_bwd_kernel_call,
        mamba_scan_bwd_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(15)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def timed(fn):
        """fn() and its host ms to a synchronised result."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    cases, inputs, plain_ms = [], {}, {}
    for name, (B, Hq, Hkv, Tq, Tk, D), dtype, causal in TRAIN_B6B_CASES:
        q = randn((B, Hq, Tq, D), dtype)
        k, v = randn((B, Hkv, Tk, D), dtype), randn((B, Hkv, Tk, D), dtype)
        o = flash_attention_kernel_call(q, k, v, causal=causal)
        do = randn((B, Hq, Tq, D), dtype)
        got = flash_attention_bwd_kernel_call(q, k, v, o, do, causal=causal)
        again = flash_attention_bwd_kernel_call(q, k, v, o, do, causal=causal)
        want, ms = timed(lambda: flash_attention_bwd_plain(
            q, k, v, o, do, causal=causal))
        cases.append(dict(
            kernel="flash_attention_bwd", case=name,
            shape=[B, Hq, Hkv, Tq, Tk, D], causal=causal, dtype=str(dtype),
            max_abs_err=max(err(a, b) for a, b in zip(got, want)),
            bitwise=all(torch.equal(a, b) for a, b in zip(got, want)),
            repeat_bitwise=all(torch.equal(a, b) for a, b in zip(got, again)),
            tol=0.0))
        check(cases[-1]["bitwise"] and cases[-1]["repeat_bitwise"],
              f"B6b {cases[-1]}")
        if name == "zamba2-1.2b-train":
            inputs["flash_attention_bwd"] = (q, k, v, o, do)
            plain_ms["flash_attention_bwd"] = ms
        del got, again, want
    for name, (B, T, H, P, S), dtype, with_dh, chunk in TRAIN_B8B_CASES:
        x = randn((B, T, H, P), dtype, 0.5)
        dt = randn((B, T, H), scale=0.1).abs() + 0.01
        A = -randn((H,)).abs() - 0.1
        Bm, Cm = randn((B, T, S), dtype, 0.3), randn((B, T, S), dtype, 0.3)
        dy = randn((B, T, H, P), dtype)
        dh = randn((B, H, P, S)) if with_dh else None
        args = (x, dt, A, Bm, Cm, dy, dh)
        got = mamba_scan_bwd_kernel_call(*args, chunk=chunk)
        again = mamba_scan_bwd_kernel_call(*args, chunk=chunk)
        want, ms = timed(lambda: mamba_scan_bwd_plain(*args, chunk=chunk))
        cases.append(dict(
            kernel="mamba_scan_bwd", case=name, shape=[B, T, H, P, S],
            dh_last=with_dh, chunk=chunk, dtype=str(dtype),
            max_abs_err=max(err(a, b) for a, b in zip(got, want)),
            bitwise=all(torch.equal(a, b) for a, b in zip(got, want)),
            repeat_bitwise=all(torch.equal(a, b) for a, b in zip(got, again)),
            tol=0.0))
        check(cases[-1]["bitwise"] and cases[-1]["repeat_bitwise"],
              f"B8b {cases[-1]}")
        if name == "zamba2-1.2b-train":
            inputs["mamba_scan_bwd"] = args
            plain_ms["mamba_scan_bwd"] = ms
        del got, again, want
    torch.cuda.synchronize()
    for c in cases:
        emit("train_kernel_check", **c)

    timing = {}
    q, k, v, o, do = inputs["flash_attention_bwd"]
    B, Hq, T, D = q.shape
    pairs = T * (T + 1) // 2
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    def b6b():
        return flash_attention_bwd_kernel_call(q, k, v, o, do, causal=True)

    def library():
        return torch.autograd.grad(lib_out, (qs, ks, vs), do, retain_graph=True)

    t = dict(
        ms=time_ms(b6b, 10, flush),
        device_ms=time_ms(b6b, 10, flush, queued=True),
        plain_ms=plain_ms["flash_attention_bwd"],
        library_ms=time_ms(library, 10, flush),
        library_device_ms=time_ms(library, 10, flush, queued=True),
        # q, O, dO and dQ; k, v, dK and dV
        bytes=q.element_size() * (4 * q.numel() + 4 * k.numel()),
        # S, dP, dQ, dK, dV: five products of depth D per attended pair
        ops=5 * 2 * D * pairs * B * Hq, shape=[B, Hq, k.shape[1], T, T, D],
        causal=True, dtype=str(q.dtype))
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"], ops_rate(q.dtype))
    t["tflops"] = t["ops"] / (t["ms"] * 1e-3) / 1e12
    t["device_tflops"] = t["ops"] / (t["device_ms"] * 1e-3) / 1e12
    timing["flash_attention_bwd/zamba2-1.2b-train"] = t
    del qs, ks, vs, lib_out
    x, dt, A, Bm, Cm, dy, dh = inputs["mamba_scan_bwd"]
    B, T, H, P = x.shape
    S, c = Bm.shape[-1], 128
    tri = c * (c + 1) // 2
    # the chunked form's products, as B8's bound counts them: the forward's
    # CB^T and (L o CB^T) x (tri each), its states B^T x and reads C h
    # (c x P x S each); each has two products in the gradient (the states
    # the gradient needs are not counted again)
    per_chunk = 2 * (tri * 2 * S + tri * 2 * P + 4 * c * P * S)

    def b8b():
        return mamba_scan_bwd_kernel_call(x, dt, A, Bm, Cm, dy, dh, chunk=c)

    t = dict(
        ms=time_ms(b8b, 10, flush),
        device_ms=time_ms(b8b, 10, flush, queued=True),
        plain_ms=plain_ms["mamba_scan_bwd"],
        library_ms=None,
        # x, dy and dx; dt and ddt; A and dA; Bm, Cm, dBm and dCm
        bytes=x.element_size() * 3 * x.numel() + 4 * 2 * dt.numel()
        + 4 * 2 * H + Bm.element_size() * 4 * Bm.numel(),
        ops=B * H * -(-T // c) * per_chunk, shape=[B, T, H, P, S],
        chunk=c, dtype=str(x.dtype),
        scratch_bytes=4 * sum(map(math.prod,
                                  bwd_scratch_shapes(B, T, H, P, S, c))),
        blocks=B * H * -(-T // c))
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"], ops_rate(x.dtype))
    timing["mamba_scan_bwd/zamba2-1.2b-train"] = t
    return dict(cases=cases, timing=timing)


def train_counters() -> dict:
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel_call,
        flash_attention_kernel_call,
    )
    from repro_torch.kernels.mamba_scan import (
        mamba_scan_bwd_kernel_call,
        mamba_scan_kernel_call,
    )

    return {"flash_attention": flash_attention_kernel_call,
            "flash_attention_bwd": flash_attention_bwd_kernel_call,
            "mamba_scan": mamba_scan_kernel_call,
            "mamba_scan_bwd": mamba_scan_bwd_kernel_call}


# the kernels each training kernel call launches, by name (B8b's first
# three are B8's passes, which its forward launches too)
TRAIN_KERNEL_NAMES = {
    "flash_attention_bwd": ("fa_bwd_",),
    "mamba_scan_bwd": ("chunk_cb_kernel", "chunk_state_kernel",
                       "state_pass_kernel", "state_grad_term_kernel",
                       "state_grad_pass_kernel", "chunk_bwd_kernel",
                       "scan_bwd_reduce_kernel")}


def launch_times(prof: dict, names: tuple[str, ...]) -> list[dict]:
    """Each kernel of `prof` (a `device_profile` with every row) whose
    name holds one of `names`: its launches and device ms a launch."""
    return [dict(name=r["name"], launches=r["count"], ms=r["ms"] / r["count"])
            for r in prof["top"] if any(n in r["name"] for n in names)]


def step0_vs_plain(dev) -> dict:
    """Loss and every gradient of zamba2-1.2b's first TRAIN_CHECK_LAYERS
    layers at full width (seed-0 weights, step 0's first microbatch) on
    the kernel path against the plain path, on the card."""
    from repro_torch import configs
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train.data import make_batch

    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              n_layers=TRAIN_CHECK_LAYERS)
    params = init_params(cfg, 0, dev)
    params.requires_grad_(True)
    plist = list(params.parameters())
    batch = make_batch(cfg, ShapeSpec("cli", TRAIN_T, TRAIN_BATCH, "train"),
                       0, 0, dev)
    mb = {k: v[:TRAIN_BATCH // TRAIN_MB] for k, v in batch.items()}

    def grads():
        loss = loss_fn(params, mb, cfg)
        return loss.detach(), torch.autograd.grad(loss, plist)

    counters = train_counters()
    reset_launches(*counters.values())
    k_loss, k_grads = grads()
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    with plain_kernels():
        p_loss, p_grads = grads()
    torch.cuda.synchronize()
    out = dict(
        layers=TRAIN_CHECK_LAYERS, tokens=list(mb["tokens"].shape),
        loss=float(k_loss), plain_loss=float(p_loss),
        loss_equal=bool(torch.equal(k_loss, p_loss)),
        grad_leaves=len(plist),
        grads_bitwise=sum(int(torch.equal(a, b))
                          for a, b in zip(k_grads, p_grads)),
        max_abs_err=max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(k_grads, p_grads)),
        finite=all(bool(torch.isfinite(g.float()).all()) for g in k_grads),
        launches=launches, seconds=time.perf_counter() - t0)
    check(out["loss_equal"] and out["grads_bitwise"] == len(plist)
          and out["finite"], f"train step 0, kernel vs plain path: {out}")
    check(all(n > 0 for n in launches.values()),
          f"step 0's kernel path launched {launches}")
    return out


def train_argv(ckpt_dir, batch: int = TRAIN_BATCH) -> list:
    """`launch.train`'s arguments of the train phase: zamba2-1.2b at full
    width and depth, T TRAIN_T, global batch `batch` in TRAIN_MB
    microbatches, TRAIN_STEPS steps (the schedule's length), seed 0, and
    with a `ckpt_dir` a checkpoint every 2 steps there."""
    ckpt = [] if ckpt_dir is None else ["--ckpt-dir", str(ckpt_dir),
                                        "--ckpt-every", "2"]
    return ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
            "--batch", str(batch), "--seq", str(TRAIN_T),
            "--microbatches", str(TRAIN_MB), *ckpt, "--seed", "0",
            "--device", "cuda"]


def train_phase(dev, d) -> dict:
    """`repro_torch.launch.train.main` through its argv: zamba2-1.2b at
    full width and depth, bf16, seed-0 weights, T TRAIN_T, global batch
    TRAIN_BATCH in TRAIN_MB microbatches, TRAIN_STEPS steps, checkpoints
    every 2 steps in a temporary directory under build/; one more step
    traced; then, as if the job had died after the step-2 checkpoint, the
    same command again, resuming from it. Checked: losses finite and
    falling from step 0 to the last, the resumed steps' losses bitwise the
    uninterrupted run's, every kernel of the path launched. The checkpoints
    stay in `d` (the caller's): `multicard_phase` holds its own step 2 to
    this run's."""
    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import AdamW, cosine_schedule, make_train_step
    from repro_torch.train.data import make_batch

    counters = train_counters()
    argv = train_argv(d)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(*counters.values())
    full = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        losses = launch_train.main(argv, report=full)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state = full.pop("state")
    # one more step, traced: the card's busy share of a training step
    cfg = configs.get(TRAIN_ARCH)
    step_fn = make_train_step(cfg, AdamW(lr=cosine_schedule(
        3e-4, 10, TRAIN_STEPS)), TRAIN_MB)
    batch = make_batch(cfg, ShapeSpec("cli", TRAIN_T, TRAIN_BATCH,
                                      "train"), TRAIN_STEPS, 0, dev)
    prof = device_profile(lambda: step_fn(state, batch), 1,
                          host_ops=False, top=None)
    del state, batch, step_fn
    torch.cuda.empty_cache()
    shutil.rmtree(Path(d) / f"step_{TRAIN_STEPS:08d}")
    (Path(d) / "LATEST").write_text("2")
    resumed = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        launch_train.main(argv, report=resumed)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resumed.pop("state")
    steady = sorted(full["step_seconds"][1:])
    step_s = statistics.median(steady)
    out = dict(
        arch=TRAIN_ARCH, dtype="bfloat16", layers=configs.get(TRAIN_ARCH).n_layers,
        seq=TRAIN_T, global_batch=TRAIN_BATCH, microbatches=TRAIN_MB,
        steps=TRAIN_STEPS, losses=losses, grad_norms=full["grad_norms"],
        lrs=full["lrs"], step_seconds=full["step_seconds"],
        step_ms=step_s * 1e3, tokens_per_s=TRAIN_BATCH * TRAIN_T / step_s,
        peak_gb=peak_gb, launches=launches,
        launches_per_step={k: n / TRAIN_STEPS for k, n in launches.items()},
        traced_step=dict(prof, top=prof["top"][:5]),
        launch_ms={k: launch_times(prof, names)
                   for k, names in TRAIN_KERNEL_NAMES.items()},
        run_seconds=run_s,
        resumed=dict(start=resumed["start"], losses=resumed["losses"],
                     step_seconds=resumed["step_seconds"],
                     equal=resumed["losses"] == losses[2:],
                     seconds=resume_s),
        stragglers=full["stragglers"])
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(resumed["start"] == 2 and out["resumed"]["equal"],
          f"resumed losses {resumed['losses']} vs {losses[2:]}")
    check(all(n > 0 for n in launches.values()), f"train launches {launches}")
    return out


def train_reduced_phase(dev) -> dict:
    """Every reduced config in float32 and bf16, weights from seed 0 on the
    card: one `make_train_step` step (2 x 40 tokens of the config's
    synthetic batch, 2 microbatches, AdamW) on the kernel path, then the
    same on the plain path; loss, grad norm, every gradient and every
    updated parameter bitwise (checked), each config's kernels launched.
    Then examples_torch/train_lm.py with --device cuda."""
    from repro_torch import configs
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import AdamW, init_state, make_train_step
    from repro_torch.train.data import make_batch

    counters = train_counters()
    shape = ShapeSpec("t", TRAIN_REDUCED_T, TRAIN_REDUCED_B, "train")
    cases = []
    for arch in LM_REDUCED_ARCHS:
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            cfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype)
            batch = make_batch(cfg, shape, 0, 0, dev)

            def run():
                opt = AdamW(lr=1e-3)
                state = init_state(cfg, 0, opt, dev)
                seen = {}
                update = opt.update

                def spy(grads, st, params):
                    seen.update({k: g.clone() for k, g in grads.items()})
                    return update(grads, st, params)

                opt.update = spy
                state, met = make_train_step(cfg, opt, 2)(state, batch)
                return met, seen, [p.detach().clone()
                                   for p in state["params"].parameters()]

            reset_launches(*counters.values())
            k_met, k_g, k_p = run()
            torch.cuda.synchronize()
            launches = {k: f.launches for k, f in counters.items()}
            with plain_kernels():
                p_met, p_g, p_p = run()
            torch.cuda.synchronize()
            res = dict(
                arch=arch, family=cfg.family, dtype=dtype,
                loss=float(k_met["loss"]),
                loss_equal=bool(torch.equal(k_met["loss"], p_met["loss"])),
                grad_norm_equal=bool(torch.equal(k_met["grad_norm"],
                                                 p_met["grad_norm"])),
                grads_bitwise=all(torch.equal(k_g[n], p_g[n]) for n in k_g),
                params_bitwise=all(torch.equal(a, b) for a, b in zip(k_p, p_p)),
                max_abs_err=max(float((k_g[n].float() - p_g[n].float()).abs()
                                      .max()) for n in k_g),
                finite=math.isfinite(float(k_met["loss"])),
                launches=launches, seconds=time.perf_counter() - t0)
            emit("train_reduced", **res)
            check(res["loss_equal"] and res["grad_norm_equal"]
                  and res["grads_bitwise"] and res["params_bitwise"]
                  and res["finite"],
                  f"{arch} ({dtype}) train step, kernel vs plain: {res}")
            want = {"hybrid": list(counters), "ssm": []}.get(
                cfg.family, ["flash_attention", "flash_attention_bwd"])
            check(all(launches[k] > 0 for k in want),
                  f"{arch} ({dtype}) train launches {launches}")
            cases.append(res)
    reset_launches(*counters.values())
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        losses = load_drive("train_lm").main(["--device", "cuda"])
    torch.cuda.synchronize()
    example = dict(losses=[losses[0], losses[-1]], steps=len(losses),
                   launches={k: f.launches for k, f in counters.items()},
                   seconds=time.perf_counter() - t0)
    check(losses[-1] < losses[0] and example["launches"][
        "flash_attention_bwd"] > 0, f"train_lm.py: {example}")
    return dict(cases=cases, example=example, launches={
        k: sum(r["launches"][k] for r in cases) for k in counters})


def nccl_rows(prof: dict) -> dict:
    """The collectives' device time in a `device_profile` with every row:
    NCCL's kernels by name, and the device-to-device copies (over one rank
    NCCL copies with cudaMemcpyAsync, which the trace cannot tell from
    torch's own copies)."""
    nccl = [r for r in prof["top"] if "nccl" in r["name"].lower()]
    copies = [r for r in prof["top"] if "Memcpy DtoD" in r["name"]]
    return dict(nccl_ms=sum(r["ms"] for r in nccl), nccl=nccl,
                memcpy_dtod_ms=sum(r["ms"] for r in copies),
                memcpy_dtod=sum(r["count"] for r in copies))


def multicard_train_rank(dev, world: int, train_dir, counters) -> dict:
    """This rank's `multicard_train`: 2 steps of the train phase's command
    (without its checkpoints) through `launch.train` over the NCCL group
    (``--data`` W); at W = 1 every parameter after step 2 held bitwise to
    the train phase's step-2 checkpoint in `train_dir`; then one more step
    traced."""
    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.specs import batch_pspecs
    from repro_torch.models.config import ShapeSpec
    from repro_torch.parallel import gather_full, local_shard, parallel_ctx
    from repro_torch.parallel.collectives import counts, reset_counts
    from repro_torch.train import AdamW, cosine_schedule, make_train_step
    from repro_torch.train.checkpoint import read_leaves
    from repro_torch.train.data import make_batch

    # each rank takes the one-card step's batch: the global batch grows
    # with W. Steps 0 and 1 lie in the 10-step warm-up, whose learning
    # rates do not depend on --steps, so 2 steps give the train phase's.
    argv = train_argv(None, TRAIN_BATCH * world) + [
        "--data", str(world), "--steps", "2"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches(*counters.values())
    report = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        losses = launch_train.main(argv, report=report)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state, mesh = report.pop("state"), report.pop("mesh")
    t0 = time.perf_counter()
    params = dict(state["params"].named_parameters())
    n_params, equal = len(params), None
    if world == 1:
        want = read_leaves(train_dir, 2, set(params))
        pl = state["placement"]
        equal = sum(int(torch.equal(
            gather_full(p, pl.params[n], mesh).cpu(), want[n]))
            for n, p in params.items())
        del want
    compare_s = time.perf_counter() - t0
    cfg = configs.get(TRAIN_ARCH)
    step_fn = make_train_step(cfg, AdamW(lr=cosine_schedule(
        3e-4, 10, TRAIN_STEPS)), TRAIN_MB)
    with parallel_ctx(mesh) as ctx:
        batch = make_batch(cfg, ShapeSpec("cli", TRAIN_T, TRAIN_BATCH * world,
                                          "train"), 2, 0, dev)
        specs = batch_pspecs(batch, ctx)
        batch = {k: local_shard(v, specs[k], mesh) for k, v in batch.items()}
        reset_counts()
        t0 = time.perf_counter()
        prof = device_profile(lambda: step_fn(state, batch), 1,
                              host_ops=False, top=None)
        trace_s = time.perf_counter() - t0
        traced = counts()
    del state, batch, step_fn, params
    torch.cuda.empty_cache()
    return dict(mesh=mesh.shape, losses=losses,
                step_seconds=report["step_seconds"],
                grad_norms=report["grad_norms"], lrs=report["lrs"],
                collectives=report["collectives"], run_seconds=run_s,
                compare_seconds=compare_s, trace_seconds=trace_s,
                peak_gb=peak_gb, launches=launches, param_leaves=n_params,
                params_equal_train=equal,
                traced_step=dict(window_ms=prof["window_ms"],
                                 device_busy_ms=prof["device_busy_ms"],
                                 busy_share=prof["busy_share"],
                                 kernels=prof["kernels"], collectives=traced,
                                 **nccl_rows(prof)))


def tp_meshes(world: int) -> list:
    """The (data, model) meshes `multicard_tp_rank` trains zamba2-1.2b on
    over `world` > 1 cards: (world / 2, 2) from four cards up, else
    (world, 1) (a data axis above 1 either way), restarted from its
    checkpoint; then (1, world)."""
    return [(world // 2, 2) if world >= 4 else (world, 1), (1, world)]


def multicard_tp_rank(dev, world: int, train_dir, counters) -> dict:
    """This rank's `multicard_tp` (W > 1): the train phase's zamba2-1.2b
    command through `launch.train` on each of `tp_meshes` (the first 3
    steps with a checkpoint at step 2, then again from that checkpoint;
    the next 2 steps, the global batch the one-card one); then
    MC_TP_ARCH at full width on (1, W), MC_TP_STEPS steps and one more
    traced."""
    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import batch_pspecs, train_collectives
    from repro_torch.models.config import ShapeSpec
    from repro_torch.parallel import local_shard, parallel_ctx
    from repro_torch.parallel.collectives import counts, reset_counts
    from repro_torch.train import AdamW, cosine_schedule, make_train_step
    from repro_torch.train.data import make_batch

    def run(argv):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(*counters.values())
        report = {}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            losses = launch_train.main(argv, report=report)
        torch.cuda.synchronize()
        steady = sorted(report["step_seconds"][1:]) or report["step_seconds"]
        return dict(
            mesh=report["mesh"].shape, start=report["start"], losses=losses,
            grad_norms=report["grad_norms"], lrs=report["lrs"],
            step_seconds=report["step_seconds"],
            step_ms=statistics.median(steady) * 1e3,
            collectives=report["collectives"],
            launches={k: f.launches for k, f in counters.items()},
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            run_seconds=time.perf_counter() - t0), report

    out = {"zamba2": []}
    for data, model in tp_meshes(world):
        restart = data > 1
        d = Path(train_dir) / f"tp_{data}x{model}"
        argv = train_argv(d if restart else None) + [
            "--data", str(data), "--model", str(model),
            "--steps", "3" if restart else "2"]
        res, report = run(argv)
        del report
        if restart:
            again, report = run(argv)
            del report
            res["restart"] = dict(start=again["start"], losses=again["losses"],
                                  step_seconds=again["step_seconds"],
                                  equal=again["losses"] == res["losses"][2:],
                                  run_seconds=again["run_seconds"])
        res["tokens_per_s"] = TRAIN_BATCH * TRAIN_T / res["step_ms"] * 1e3
        out["zamba2"].append(res)
    if world < 4:
        return out
    # MC_TP_ARCH at full width over the model axis: cut in depth (held to
    # one card), then whole, then one step traced
    cut = tp_cut_run(dev, make_local_mesh(1, world, dev))
    cfg = configs.get(MC_TP_ARCH)
    shape = ShapeSpec("cli", TRAIN_T, MC_TP_BATCH, "train")
    argv = ["--arch", MC_TP_ARCH, "--steps", str(MC_TP_STEPS),
            "--batch", str(MC_TP_BATCH), "--seq", str(TRAIN_T),
            "--microbatches", str(MC_TP_MB), "--seed", "0", "--device", "cuda",
            "--data", "1", "--model", str(world)]
    res, report = run(argv)
    state, mesh = report.pop("state"), report.pop("mesh")
    res["cut"] = cut
    res["loss_rose"] = res["losses"][-1] > res["losses"][0]
    res["tokens_per_s"] = MC_TP_BATCH * TRAIN_T / res["step_ms"] * 1e3
    res["closed_form"] = train_collectives(cfg, shape, 1, world, MC_TP_MB)
    res["collectives_equal_closed_form"] = [
        c == res["closed_form"] for c in res["collectives"]]
    step_fn = make_train_step(cfg, AdamW(lr=cosine_schedule(
        3e-4, 10, MC_TP_STEPS)), MC_TP_MB)
    with parallel_ctx(mesh) as ctx:
        batch = make_batch(cfg, shape, MC_TP_STEPS, 0, dev)
        specs = batch_pspecs(batch, ctx)
        batch = {k: local_shard(v, specs[k], mesh) for k, v in batch.items()}
        reset_counts()
        t0 = time.perf_counter()
        prof = device_profile(lambda: step_fn(state, batch), 1,
                              host_ops=False, top=None)
        res["traced_step"] = dict(
            window_ms=prof["window_ms"], device_busy_ms=prof["device_busy_ms"],
            busy_share=prof["busy_share"], kernels=prof["kernels"],
            collectives=counts(), seconds=time.perf_counter() - t0,
            **nccl_rows(prof))
    res["params"] = sum(p.numel() for p in state["params"].parameters())
    del state, batch, step_fn, report
    torch.cuda.empty_cache()
    out[MC_TP_ARCH] = res
    return out


def tp_cut_run(dev, mesh=None) -> dict:
    """MC_TP_ARCH at full width cut to MC_TP_CHECK_LAYERS layers:
    MC_TP_STEPS steps of the launcher's schedule and batches (seed 0), on
    one card or over `mesh`, each rank its block of the batch."""
    from repro_torch import configs
    from repro_torch.launch.specs import batch_pspecs
    from repro_torch.models.config import ShapeSpec
    from repro_torch.parallel import local_shard, parallel_ctx
    from repro_torch.train import (
        AdamW,
        cosine_schedule,
        init_state,
        make_train_step,
    )
    from repro_torch.train.data import make_batch

    cfg = dataclasses.replace(configs.get(MC_TP_ARCH),
                              n_layers=MC_TP_CHECK_LAYERS)
    shape = ShapeSpec("cut", TRAIN_T, MC_TP_BATCH, "train")
    opt = AdamW(lr=cosine_schedule(3e-4, 10, MC_TP_STEPS))
    step = make_train_step(cfg, opt, MC_TP_MB)
    losses, gnorms = [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with parallel_ctx(mesh) as ctx:
        state = init_state(cfg, 0, opt, dev, mesh)
        for i in range(MC_TP_STEPS):
            batch = make_batch(cfg, shape, i, 0, dev)
            if mesh is not None:
                specs = batch_pspecs(batch, ctx)
                batch = {k: local_shard(v, specs[k], mesh)
                         for k, v in batch.items()}
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
    del state, batch
    torch.cuda.empty_cache()
    return dict(layers=MC_TP_CHECK_LAYERS, losses=losses, grad_norms=gnorms,
                loss_rose=losses[-1] > losses[0],
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def one_card_tp_reference(dev) -> dict:
    """The train phase's zamba2-1.2b command on one card for 2 steps: the
    losses and grad norms `multicard_tp`'s (1, W) run is held to."""
    from repro_torch.launch import train as launch_train

    report = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        losses = launch_train.main(train_argv(None) + ["--steps", "2"],
                                   report=report)
    torch.cuda.synchronize()
    del report["state"]
    torch.cuda.empty_cache()
    return dict(losses=losses, grad_norms=report["grad_norms"],
                step_seconds=report["step_seconds"], cut=tp_cut_run(dev),
                seconds=time.perf_counter() - t0)


def multicard_moe_rank(dev, world: int, counters, flush) -> dict:
    """This rank's `multicard_moe`: MC_MOE_ARCH at full width cut to
    MC_MOE_LAYERS layers, one forward and backward of `loss_fn` through
    `moe_sharded` over the NCCL group; at a world of one, the same through
    `moe_ref` at the capacity factor that makes its capacity C2."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import batch_pspecs
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import moe as tmoe
    from repro_torch.models.config import ShapeSpec
    from repro_torch.parallel import (
        all_to_all,
        local_shard,
        param_pspecs,
        parallel_ctx,
        psum,
        shard_module,
    )
    from repro_torch.parallel.collectives import counts, reset_counts
    from repro_torch.train.data import make_batch

    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get(MC_MOE_ARCH), n_layers=MC_MOE_LAYERS)
    mesh = make_local_mesh(world, 1, dev)
    params = init_params(cfg, 0, dev)
    params.requires_grad_(True)
    with parallel_ctx(mesh) as ctx:
        shard_module(params, param_pspecs(params, ctx), mesh)
        batch = make_batch(cfg, ShapeSpec("mc", MC_MOE_T, MC_MOE_B * world,
                                          "train"), 0, 0, dev)
        specs = batch_pspecs(batch, ctx)
        batch = {k: local_shard(v, specs[k], mesh) for k, v in batch.items()}
    plist = list(params.parameters())
    N = batch["tokens"].numel()
    k, cf, E = cfg.experts_per_tok, cfg.capacity_factor, cfg.expert_slots
    C = tmoe._capacity(N * k, world, cf)
    C2 = tmoe._capacity(world * C, E // world, cf)

    def run(c, ctx_mesh):
        with parallel_ctx(ctx_mesh):
            loss = loss_fn(params, batch, c)
            return loss.detach(), torch.autograd.grad(loss, plist)

    def sharded():
        return run(cfg, mesh)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(*counters.values())
    reset_counts()
    s_loss, s_grads = sharded()
    torch.cuda.synchronize()
    coll = counts()
    launches = {k: f.launches for k, f in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out = dict(arch=MC_MOE_ARCH, layers=MC_MOE_LAYERS, dtype=cfg.dtype,
               tokens=[MC_MOE_B * world, MC_MOE_T], local_tokens=N, capacity=C,
               capacity_c2=C2, collectives=coll, launches=launches,
               peak_gb=peak_gb, grad_leaves=len(plist),
               finite=math.isfinite(float(s_loss)) and all(
                   bool(torch.isfinite(g.float()).all()) for g in s_grads))
    with parallel_ctx(mesh):
        out["loss"] = float(psum(s_loss, "data") / world)
    if world == 1:
        cf2 = (C2 - 0.5) * cfg.n_experts / (N * k)
        check(tmoe._capacity(N * k, cfg.n_experts, cf2) == C2,
              f"no capacity factor gives moe_ref C2 = {C2}")
        ref_cfg = dataclasses.replace(cfg, capacity_factor=cf2)

        def ref():
            return run(ref_cfg, None)

        r_loss, r_grads = ref()
        torch.cuda.synchronize()
        out.update(
            ref_loss=float(r_loss),
            loss_equal=bool(torch.equal(s_loss, r_loss)),
            grads_bitwise=sum(int(torch.equal(a, b))
                              for a, b in zip(s_grads, r_grads)),
            max_abs_err=max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(s_grads, r_grads)))
        del r_grads
        out["ref_ms"] = time_ms(ref, MC_MOE_REPS, flush, warmup=1)
    del s_grads
    out["ms"] = time_ms(sharded, MC_MOE_REPS, flush, warmup=1)
    # one all_to_all of a layer's first-stage token buffer, alone: over
    # one rank NCCL copies with cudaMemcpyAsync, which a trace cannot tell
    # from torch's own copies
    buf = torch.zeros((world, C, cfg.d_model), dtype=torch.bfloat16,
                      device=dev)
    out["a2a_ms_each"] = time_ms(lambda: all_to_all(buf, "data", mesh),
                                 MC_MOE_REPS, flush, warmup=1)
    out["a2a_bytes_each"] = buf.numel() * buf.element_size()
    del buf
    prof = device_profile(sharded, 1, host_ops=False, top=None)
    out["traced"] = dict(window_ms=prof["window_ms"],
                         device_busy_ms=prof["device_busy_ms"],
                         kernels=prof["kernels"], **nccl_rows(prof))
    out["seconds"] = time.perf_counter() - t0
    del params, plist
    torch.cuda.empty_cache()
    return out


def serve_cases(world: int) -> list:
    """(arch, (data, model)) of `multicard_serve` on `world` cards."""
    if world == 1:
        return [("zamba2-1.2b", (1, 1))]
    if world >= 4:
        return [("qwen3-8b", (1, 4)), ("phi3-medium-14b", (1, 4)),
                ("zamba2-1.2b", (2, 2))]
    return [("qwen3-8b", (1, world)), ("zamba2-1.2b", (world, 1))]


def serve_run(params, cfg, prompt, forced, n_greedy: int, dev, mesh=None,
              counters=None) -> dict:
    """Prefill `prompt` and decode `forced` then `n_greedy` greedy tokens
    from an empty cache of MC_SERVE_MAX_LEN positions, on one card
    (`mesh` None: `make_prefill`, `decode_step`, `make_serve_step`) or on
    this rank's blocks under `mesh` (`build_cell`'s prefill and decode
    cells, the forced steps through `decode_step` under the mesh's
    context, the cache cut by `tp_cache_pspecs`). Returns the whole
    batch's prefill logits, forced logits and greedy tokens (gathered
    over data), the whole cache, the times, the collectives of the
    prefill and of the first forced step, and under a mesh one greedy
    step traced (NCCL's device time)."""
    from repro_torch.launch.specs import batch_pspecs, build_cell
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.config import ShapeSpec
    from repro_torch.parallel import gather_full, local_shard, parallel_ctx
    from repro_torch.parallel.collectives import counts, reset_counts
    from repro_torch.parallel.sharding import tp_cache_pspecs
    from repro_torch.serve import make_prefill, make_serve_step

    B = forced.shape[0]
    ctx = parallel_ctx(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx as c:
        cache = init_cache(cfg, B, MC_SERVE_MAX_LEN, dev)
        if mesh is None:
            prefill = make_prefill(cfg, dev)
            greedy = make_serve_step(cfg, device=dev)
            tok_spec, c_specs = None, None
        else:
            prefill = build_cell(cfg, ShapeSpec("mc", MC_SERVE_T, MC_SERVE_B,
                                                "prefill"), mesh,
                                 device=dev).fn
            greedy = build_cell(cfg, ShapeSpec("mc", MC_SERVE_MAX_LEN, B,
                                               "decode"), mesh, device=dev).fn
            c_specs = tp_cache_pspecs(cache, cfg, c)
            cache = {k: local_shard(v, c_specs[k], mesh)
                     for k, v in cache.items()}
            tok_spec = batch_pspecs(forced[:, 0], c)

    def cut(t, spec):
        return t if spec is None else local_shard(t, spec, mesh)

    def whole(t, spec):
        return t if spec is None else gather_full(t, spec, mesh)

    p_spec = None if mesh is None else (tok_spec[0], None)
    prompt_l = cut(prompt, p_spec)
    forced_l = cut(forced, p_spec)
    if counters is not None:
        reset_launches(*counters.values())
    times = []
    for i in range(3):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": prompt_l})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i < 2:
            pre_counts = counts()
            del logits
    out = dict(prefill_ms=statistics.median(times[1:]), prefill_ms_all=times,
               prefill_collectives=pre_counts,
               prefill=whole(logits, (None if mesh is None else tok_spec[0],
                                      None, None)).cpu())
    del logits
    ctx = parallel_ctx(mesh) if mesh is not None else contextlib.nullcontext()
    step_logits, step_ms = [], []
    with ctx, torch.no_grad():
        for t in range(forced.shape[1]):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg = decode_step(params, cache, forced_l[:, t], cfg,
                             MC_SERVE_MAX_LEN)[0]
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if t == 0:
                out["decode_collectives"] = counts()
            step_logits.append(whole(lg, None if mesh is None
                                     else (tok_spec[0], None)).cpu())
        tok = lg.argmax(-1).to(torch.int32)
        tokens, greedy_ms = [], []
        for _ in range(n_greedy):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, cache = greedy(params, cache, tok)
            torch.cuda.synchronize()
            greedy_ms.append((time.perf_counter() - t0) * 1e3)
            tokens.append(whole(tok, tok_spec).cpu())
    if counters is not None:
        out["launches"] = {k: f.launches for k, f in counters.items()}
    out.update(forced_logits=torch.stack(step_logits),
               tokens=torch.stack(tokens, 1) if tokens else None,
               forced_ms=statistics.median(step_ms[1:]),
               decode_ms=statistics.median(greedy_ms[1:]) if tokens else None,
               cache={k: whole(v, None if c_specs is None else c_specs[k]
                               ).to("cpu", copy=True) for k, v in cache.items()})
    if mesh is not None:
        prof = device_profile(lambda: greedy(params, cache, tok), 1,
                              host_ops=False, top=None)
        out["traced_decode_step"] = dict(
            window_ms=prof["window_ms"], device_busy_ms=prof["device_busy_ms"],
            kernels=prof["kernels"], **nccl_rows(prof))
    return out


def serve_truth(params, cfg, prompt, forced, dev) -> dict:
    """The prefill and forced-step logits of a float32 copy of `params`
    (the same weights, upcast) on this card alone."""
    from repro_torch.models.zoo import LM

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = LM(cfg32, dev)
    with torch.no_grad():
        for (_, a), (_, b) in zip(p32.named_parameters(),
                                  params.named_parameters()):
            a.copy_(b.float())
    run = serve_run(p32, cfg32, prompt, forced, 0, dev)
    del p32
    torch.cuda.empty_cache()
    return {k: run[k] for k in ("prefill", "forced_logits")}


def serve_gaps(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Logits `a` against `b` (any leading dims): the largest and mean
    gap, the share of positions with the same argmax."""
    d = (a.float() - b.float()).abs()
    same = a.argmax(-1) == b.argmax(-1)
    return dict(max_gap=float(d.max()), mean_gap=float(d.mean()),
                argmax_agree=float(same.float().mean()), rows=same.numel())


def multicard_serve_rank(dev, world: int, counters) -> dict:
    """This rank's `multicard_serve` (MC_SERVE_*): for each of
    `serve_cases`, the model drawn whole on every card from seed 0, its
    one-card run on rank 0 while the others wait (its cache and logits
    kept on the host), then every rank cuts its blocks (`tp_pspecs`) and
    serves over the mesh (`serve_run`); rank 0 compares."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import decode_attention_kernel_call
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import serve_collectives
    from repro_torch.models import init_params
    from repro_torch.models.config import ShapeSpec
    from repro_torch.parallel import parallel_ctx, shard_module
    from repro_torch.parallel.sharding import tp_pspecs

    rank = dist.get_rank()
    n_forced, n_greedy = MC_SERVE_STEPS[1 if world == 1 else 4]
    counters = dict(counters, decode_attention=decode_attention_kernel_call)
    out = []
    for arch, shape in serve_cases(world):
        t0 = time.perf_counter()
        cfg = configs.get(arch)
        gen = torch.Generator().manual_seed(17)
        prompt = torch.randint(0, cfg.vocab_size, (MC_SERVE_B, MC_SERVE_T),
                               generator=gen, dtype=torch.int32).to(dev)
        forced = torch.randint(0, cfg.vocab_size, (MC_SERVE_DECODE_B,
                                                   n_forced), generator=gen,
                               dtype=torch.int32).to(dev)
        params = init_params(cfg, 0, dev)
        one = None
        if rank == 0:
            one = serve_run(params, cfg, prompt, forced, n_greedy, dev)
            if world > 1 and cfg.family == "hybrid":
                truth = serve_truth(params, cfg, prompt, forced, dev)
            torch.cuda.empty_cache()
        dist.barrier()
        mesh = make_mesh(shape, ("data", "model"), dev)
        with parallel_ctx(mesh) as ctx:
            shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
            shard_module(params, tp_pspecs(shapes, cfg, ctx)[0], mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        run = serve_run(params, cfg, prompt, forced, n_greedy, dev, mesh,
                        counters)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        rank_params = sum(p.numel() for p in params.parameters())
        del params
        torch.cuda.empty_cache()
        res = dict(arch=arch, mesh=dict(data=shape[0], model=shape[1]),
                   world=world, peak_gb=peak_gb, rank_params=rank_params,
                   params=sum(math.prod(s) for s in shapes.values()),
                   **{k: run[k] for k in ("prefill_ms", "prefill_ms_all",
                                          "forced_ms", "decode_ms",
                                          "prefill_collectives",
                                          "decode_collectives",
                                          "traced_decode_step", "launches")})
        if cfg.family == "dense":
            dshape = ShapeSpec("mc", MC_SERVE_MAX_LEN, MC_SERVE_DECODE_B,
                               "decode")
            pshape = ShapeSpec("mc", MC_SERVE_T, MC_SERVE_B, "prefill")
            res["closed_form"] = dict(
                prefill=serve_collectives(cfg, pshape, *shape),
                decode=serve_collectives(cfg, dshape, *shape))
            res["collectives_equal_closed_form"] = [
                run["prefill_collectives"] == res["closed_form"]["prefill"],
                run["decode_collectives"] == res["closed_form"]["decode"]]
        if rank == 0:
            res["one_card"] = {k: one[k] for k in ("prefill_ms", "forced_ms",
                                                   "decode_ms")}
            res["prefill_vs_one_card"] = serve_gaps(run["prefill"],
                                                    one["prefill"])
            res["forced_vs_one_card"] = [
                serve_gaps(a, b) for a, b in zip(run["forced_logits"],
                                                 one["forced_logits"])]
            if world > 1 and cfg.family == "hybrid":
                res["vs_truth"] = {
                    side: dict(prefill=serve_gaps(r["prefill"],
                                                  truth["prefill"]),
                               forced=serve_gaps(r["forced_logits"],
                                                 truth["forced_logits"]))
                    for side, r in (("mesh", run), ("one_card", one))}
                del truth
            same = (run["tokens"] == one["tokens"]).all(0)
            res["greedy_steps_equal"] = int(same.long().cumprod(0).sum())
            res["greedy_steps"] = n_greedy
            if world == 1:
                res["bitwise"] = dict(
                    prefill=bool(torch.equal(run["prefill"], one["prefill"])),
                    forced=bool(torch.equal(run["forced_logits"],
                                            one["forced_logits"])),
                    tokens=bool(torch.equal(run["tokens"], one["tokens"])),
                    cache={k: bool(torch.equal(v, one["cache"][k]))
                           for k, v in run["cache"].items()})
        res["seconds"] = time.perf_counter() - t0
        out.append(res)
        del run, one
        dist.barrier()
    return out


def check_serve(serve: list, world: int) -> list:
    """`multicard_serve`'s checks, each case's line printed first: every
    kernel of the path launched; the dense cases' collectives the closed
    form's; at W = 1 everything bitwise the one-card path; above, the
    prefill's logits and each forced step's within MC_SERVE_MEAN_GAP and
    MC_SERVE_MAX_GAP of one card's, and the share of equal argmaxes at
    least MC_SERVE_ARGMAX_MIN over the prefill's positions and over all
    the forced steps' rows together (one step's 8 rows move in eighths:
    a single near-tie flipped by bf16 partial sums would take it to
    0.875)."""
    for res in serve:
        if world > 1:
            res["forced_argmax_agree"] = statistics.fmean(
                g["argmax_agree"] for g in res["forced_vs_one_card"])
        emit("multicard_serve", **res)
        what = f"multicard_serve {res['arch']} {res['mesh']}"
        want = ("flash_attention", "decode_attention") + (
            ("mamba_scan",) if res["arch"].startswith("zamba2") else ())
        check(all(res["launches"][k] > 0 for k in want),
              f"{what} launches {res['launches']}")
        if "collectives_equal_closed_form" in res:
            check(all(res["collectives_equal_closed_form"]),
                  f"{what} collectives {res['prefill_collectives']}, "
                  f"{res['decode_collectives']} vs {res['closed_form']}")
        if world == 1:
            b = res["bitwise"]
            check(b["prefill"] and b["forced"] and b["tokens"]
                  and all(b["cache"].values()), f"{what} bitwise {b}")
            continue
        forced = res["forced_vs_one_card"]
        if "vs_truth" in res:
            t = res["vs_truth"]
            for part in ("prefill", "forced"):
                m, o = t["mesh"][part], t["one_card"][part]
                p = o["argmax_agree"]
                slack = MC_SERVE_TRUTH_SIGMAS * math.sqrt(
                    2 * p * (1 - p) / o["rows"])
                check(m["argmax_agree"] >= p - slack
                      and m["mean_gap"] <= MC_SERVE_TRUTH_RATIO
                      * o["mean_gap"],
                      f"{what} {part} vs float32: mesh {m}, one card {o}, "
                      f"slack {slack}")
        else:
            check(res["forced_argmax_agree"] >= MC_SERVE_ARGMAX_MIN
                  and res["prefill_vs_one_card"]["argmax_agree"]
                  >= MC_SERVE_ARGMAX_MIN,
                  f"{what} argmax vs one card: prefill "
                  f"{res['prefill_vs_one_card']}, forced steps "
                  f"{res['forced_argmax_agree']}")
        for g in [res["prefill_vs_one_card"], *forced]:
            check(g["mean_gap"] <= MC_SERVE_MEAN_GAP
                  and g["max_gap"] <= MC_SERVE_MAX_GAP,
                  f"{what} vs one card: {g}")
    return serve


def multicard_rank(rank: str, world: str, init: str, out_path: str,
                   train_dir: str, started: str, phases: str = "all") -> None:
    """One rank of the multicard phases, in a process of its own (the
    parent starts W of them at wall-clock time `started`): the NCCL group,
    `multicard_train_rank` on (W, 1), at W > 1 then `multicard_tp_rank`,
    then `multicard_moe_rank`, then `multicard_serve_rank` (with `phases`
    "serve" that one alone); rank 0 writes what they returned to
    `out_path`."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = int(rank), int(world)
    t0 = time.perf_counter()
    dev = init_distributed("cuda", rank, world, init, local_rank=rank)
    out = dict(rank=rank, world=world,
               start_seconds=time.time() - float(started),
               init_seconds=time.perf_counter() - t0)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    counters = train_counters()
    try:
        if phases == "all":
            t0 = time.perf_counter()
            out["train"] = multicard_train_rank(dev, world, train_dir,
                                                counters)
            out["train"]["rank_seconds"] = time.perf_counter() - t0
            if world > 1:
                t0 = time.perf_counter()
                out["tp"] = multicard_tp_rank(dev, world, train_dir, counters)
                out["tp"]["rank_seconds"] = time.perf_counter() - t0
            out["moe"] = multicard_moe_rank(dev, world, counters, flush)
        del flush
        torch.cuda.empty_cache()
        out["serve"] = multicard_serve_rank(dev, world, counters)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        Path(out_path).write_text(json.dumps(out))


def multicard_phase(train_dir, train: dict | None, phases: str = "all",
                    during=None) -> tuple:
    """The multicard phases over an NCCL group of W =
    torch.cuda.device_count() ranks, one process a card, started here and
    stopped here whatever happens: (`multicard_train`, `multicard_tp` or
    None at W = 1, `multicard_moe`, `multicard_serve`; with `phases`
    "serve" the first three None). `multicard_train` must give finite
    losses, run the collectives of both axes at each step and launch every
    training kernel. At W = 1 (`train`: the train phase's line) it is also
    checked bitwise against the train phase: its losses at steps 0 and 1,
    and every parameter after step 2 against the train phase's step-2
    checkpoint in `train_dir`; `multicard_moe` against `moe_ref` at
    capacity C2 (loss and every gradient bitwise). At W > 1 (`train`:
    `one_card_tp_reference`'s line) `multicard_tp` follows, checked by
    `check_tp`. `multicard_serve` is checked by `check_serve`. `during`,
    a function of no arguments, runs here on the host while the ranks
    work on their cards (the census, which computes nothing on a card);
    what it returns comes last in the tuple."""
    W = torch.cuda.device_count()
    out_path = Path(train_dir) / "multicard.json"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--multicard-rank",
         str(r), str(W), f"file://{Path(train_dir) / 'multicard_pg'}",
         str(out_path), str(train_dir), repr(time.time()), phases],
        stdout=sys.stderr, stderr=sys.stderr) for r in range(W)]
    limit = MC_SERVE_TIMEOUT if phases == "serve" else \
        MC_TIMEOUT if W == 1 else MC_TP_TIMEOUT
    deadline = time.monotonic() + limit
    try:
        meanwhile = during() if during is not None else None
        while any(p.poll() is None for p in procs):
            check(time.monotonic() < deadline,
                  f"multicard ranks outlived {limit} s")
            check(all(p.poll() in (None, 0) for p in procs),
                  f"a multicard rank failed: {[p.poll() for p in procs]}")
            time.sleep(0.2)
        check(all(p.returncode == 0 for p in procs),
              f"multicard ranks exited {[p.returncode for p in procs]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    res = json.loads(out_path.read_text())
    serve = check_serve(res["serve"], W)
    if phases == "serve":
        return None, None, None, serve, meanwhile
    moe = res["moe"]
    moe.update(world=W)
    check(moe["finite"] and moe["collectives"]["all_to_all"]["calls"] > 0,
          f"multicard_moe: {moe}")
    check(moe["launches"]["flash_attention"] > 0
          and moe["launches"]["flash_attention_bwd"] > 0,
          f"multicard_moe launches {moe['launches']}")
    tr = res["train"]
    calls = [{k: v["calls"] for k, v in c.items()} for c in tr["collectives"]]
    tr.update(world=W, start_seconds=res["start_seconds"],
              init_seconds=res["init_seconds"],
              step1_ms=tr["step_seconds"][-1] * 1e3, collective_calls=calls,
              tokens_per_s=TRAIN_BATCH * W * TRAIN_T / tr["step_seconds"][-1])
    check(all(math.isfinite(x) for x in tr["losses"]) and len(tr["losses"]) == 2,
          f"multicard_train losses {tr['losses']}")
    check(all(c.get("all_reduce", 0) > 0 and c.get("reduce_scatter", 0) > 0
              and c.get("all_gather", 0) > 0 for c in calls),
          f"multicard_train collectives {calls}")
    check(all(n > 0 for n in tr["launches"].values()),
          f"multicard_train launches {tr['launches']}")
    if W > 1:
        tp = check_tp(res["tp"], train, W)
        tp.update(world=W, seconds=tp["rank_seconds"])
        return (dict(tr, seconds=tr["rank_seconds"],
                     multicard_seconds=seconds), tp, moe, serve, meanwhile)
    tr.update(train_step_ms=train["step_ms"],
              losses_equal_train=tr["losses"] == train["losses"][:2],
              loss_gaps=[a - b for a, b in zip(tr["losses"],
                                               train["losses"])])
    check(tr["losses_equal_train"],
          f"multicard_train losses {tr['losses']} vs train's "
          f"{train['losses'][:2]}")
    check(tr["params_equal_train"] == tr["param_leaves"],
          f"multicard_train parameters after step 2 vs train's: "
          f"{tr['params_equal_train']} of {tr['param_leaves']} equal")
    check(moe["loss_equal"] and moe["grads_bitwise"] == moe["grad_leaves"],
          f"multicard_moe vs moe_ref at C2: {moe}")
    # the train phase's seconds: the ranks' start and NCCL's set-up with it
    return dict(tr, seconds=seconds - moe["seconds"]
                - sum(r["seconds"] for r in serve),
                multicard_seconds=seconds), None, moe, serve, meanwhile


def vs_one_card(run: dict, one: dict, what: str) -> dict:
    """`run`'s losses and grad norms against `one`'s (one card, the same
    global batches), checked within MC_TP_LOSS_ATOL and MC_TP_GNORM_RTOL."""
    out = dict(one_card=one, loss_gaps=[a - b for a, b in zip(
        run["losses"], one["losses"])], grad_norm_rel=[
            a / b - 1 for a, b in zip(run["grad_norms"], one["grad_norms"])])
    check(len(run["losses"]) == len(one["losses"])
          and all(abs(g) <= MC_TP_LOSS_ATOL for g in out["loss_gaps"])
          and all(abs(g) <= MC_TP_GNORM_RTOL for g in out["grad_norm_rel"]),
          f"multicard_tp {what} vs one card: {out}")
    return out


def check_tp(tp: dict, one: dict, world: int) -> dict:
    """`multicard_tp`'s checks (W > 1): on every mesh finite losses, the
    model axis's collectives each step and every training kernel launched;
    the first mesh's restart from its step-2 checkpoint bitwise the
    uninterrupted step; the (1, W) run's losses and grad norms within
    MC_TP_LOSS_ATOL and MC_TP_GNORM_RTOL of `one` (the one-card run of the
    same global batch); MC_TP_ARCH cut to MC_TP_CHECK_LAYERS layers held
    to one card the same way; MC_TP_ARCH's losses finite, each step's
    collectives the closed form's."""
    for run in tp["zamba2"]:
        mesh = (run["mesh"]["data"], run["mesh"]["model"])
        check(all(math.isfinite(x) for x in run["losses"]),
              f"multicard_tp {mesh} losses {run['losses']}")
        check(all(c.get("reduce_scatter", {}).get("calls", 0) > 0
                  and c.get("all_gather", {}).get("calls", 0) > 0
                  for c in run["collectives"]),
              f"multicard_tp {mesh} collectives {run['collectives']}")
        check(all(n > 0 for n in run["launches"].values()),
              f"multicard_tp {mesh} launches {run['launches']}")
        if "restart" in run:
            check(run["restart"]["start"] == 2 and run["restart"]["equal"],
                  f"multicard_tp {mesh} restart {run['restart']} vs "
                  f"{run['losses']}")
        if mesh == (1, world):
            run["vs_one_card"] = vs_one_card(run, one, f"{mesh}")
    big = tp.get(MC_TP_ARCH)
    if big is not None:
        check(all(math.isfinite(x) for x in big["losses"]),
              f"multicard_tp {MC_TP_ARCH} losses {big['losses']}")
        big["cut"]["vs_one_card"] = vs_one_card(
            big["cut"], one["cut"], f"{MC_TP_ARCH} cut to "
            f"{MC_TP_CHECK_LAYERS} layers on (1, {world})")
        check(all(big["collectives_equal_closed_form"]),
              f"multicard_tp {MC_TP_ARCH} collectives {big['collectives']} vs "
              f"the closed form {big['closed_form']}")
        check(big["launches"]["flash_attention"] > 0
              and big["launches"]["flash_attention_bwd"] > 0,
              f"multicard_tp {MC_TP_ARCH} launches {big['launches']}")
    return tp


def lm_batch(cfg, B: int, n_tokens: int, gen, dev, n_embed: int = 0,
             zeros: bool = False) -> dict:
    """A prefill batch on the card: tokens (B, n_tokens) drawn from `gen`,
    then the family's stub embeddings, (B, n_embed, d) in the config's
    type: internvl2's patches, whisper's frames, normal draws at
    LM_EMBED_SCALE (or zeros)."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, n_tokens),
                                     generator=gen, device=dev)}
    key = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
    if key is not None:
        shape = (B, n_embed, cfg.d_model)
        emb = (torch.zeros(shape, device=dev) if zeros else
               torch.randn(shape, generator=gen, device=dev) * LM_EMBED_SCALE)
        batch[key] = emb.to(getattr(torch, cfg.dtype))
    return batch


def lm_full_batch(cfg, gen, dev) -> tuple[dict, int]:
    """lm_serve's prefill batch of LM_PREFILL_B x LM_PREFILL_T positions
    and the length of its logits: the vlm family's T counts its patches
    first, the audio family's is half frames, half tokens."""
    B, T = LM_PREFILL_B, LM_PREFILL_T
    if cfg.family == "vlm":
        return lm_batch(cfg, B, T - cfg.num_patches, gen, dev,
                        cfg.num_patches), T
    if cfg.family == "audio":
        return lm_batch(cfg, B, T // 2, gen, dev, T // 2), T // 2
    return lm_batch(cfg, B, T, gen, dev), T


class Float32Layers(torch.nn.ModuleList):
    """A model's layer list whose iteration hands out each layer with its
    parameters in float32, put back after: a forward through it computes
    in float32 while the card holds a single float32 layer."""

    def __iter__(self):
        for layer in super().__iter__():
            saved = [(p, p.data) for p in layer.parameters()]
            for p, data in saved:
                p.data = data.float()
            try:
                yield layer
            finally:
                for p, data in saved:
                    p.data = data


@contextlib.contextmanager
def float32_streamed(params):
    """`params` computing in float32 without a float32 copy of the model:
    the parameters outside its layer lists (embeddings, head, norms,
    zamba2's shared block) are upcast in place, the layer lists stream
    (`Float32Layers`); everything is put back on exit. The float32 truth
    of a model whose float32 copy does not fit beside its bf16 weights
    (qwen2-moe-a2.7b's 60.6 GB, internvl2-26b's 79.4 GB)."""
    lists = {n: m for n, m in params.named_children()
             if isinstance(m, torch.nn.ModuleList)}
    others = [(p, p.data) for n, p in params.named_parameters()
              if n.split(".")[0] not in lists]
    for p, data in others:
        p.data = data.float()
    for n, m in lists.items():
        setattr(params, n, Float32Layers(m))
    try:
        yield params
    finally:
        for n, m in lists.items():
            setattr(params, n, m)
        for p, data in others:
            p.data = data


MOE_STEPS = ("router_topk", "_dispatch_indices", "_dispatch", "_expert_ffn",
             "_combine", "_shared_expert")


def moe_breakdown(run, params, batch, cfg, flush) -> dict:
    """Where an MoE prefill's time goes: one `run()` traced with each step
    of `moe_ref` in a `record_function` range (the device time of the
    kernels each range launched, over the trace's busy time), and each
    step timed alone with CUDA events on layer 0's input shape (the token
    embeddings normed by its ln2, a stand-in for its real input)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import repro_torch.models.moe as moe
    from repro_torch.models.layers import rms_norm

    saved = {n: getattr(moe, n) for n in MOE_STEPS}

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(f"moe.{name}"):
                return fn(*a, **kw)
        return call

    for n in MOE_STEPS:
        setattr(moe, n, ranged(n, saved[n]))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(moe, n, fn)
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    ranges = {e.key[4:]: dict(calls=e.count,
                              device_ms=getattr(e, "device_time_total",
                                                0.0) / 1e3)
              for e in events if e.key.startswith("moe.")}
    traced = dict(busy_ms=busy, steps=ranges)
    if busy > 0:
        disp = sum(ranges.get(k, {}).get("device_ms", 0.0) for k in (
            "_dispatch_indices", "_dispatch", "_combine"))
        traced["dispatch_combine_share"] = disp / busy

    # each step alone, at layer 0's shape
    blk = params.blocks[0]
    p = blk.moe
    xt = rms_norm(torch.nn.functional.embedding(batch["tokens"],
                                                params.tok_emb),
                  blk.ln2).reshape(-1, cfg.d_model)
    N, k, E = xt.shape[0], cfg.experts_per_tok, cfg.expert_slots
    C = moe._capacity(N * k, cfg.n_experts, cfg.capacity_factor)
    weights, sel = moe.router_topk(xt, p.w_router, k)
    order, sorted_e, pos, keep = moe._dispatch_indices(sel.reshape(-1), E, C)
    x_slots = xt[:, None].expand(N, k, cfg.d_model)
    buf = moe._dispatch(x_slots, order, sorted_e, pos, keep, E, C)
    out_buf = moe._expert_ffn(buf, p.w_gate, p.w_up, p.w_down)
    w_sorted = weights.reshape(-1)[order]
    steps = {
        "router_topk": lambda: moe.router_topk(xt, p.w_router, k),
        "_dispatch_indices": lambda: moe._dispatch_indices(
            sel.reshape(-1), E, C),
        "_dispatch": lambda: moe._dispatch(x_slots, order, sorted_e, pos,
                                           keep, E, C),
        "_expert_ffn": lambda: moe._expert_ffn(buf, p.w_gate, p.w_up,
                                               p.w_down),
        "_combine": lambda: moe._combine(out_buf, w_sorted, order, sorted_e,
                                         pos, keep, N, k),
        "_shared_expert": lambda: moe._shared_expert(xt, p.shared),
        "moe_ref": lambda: moe.moe_ref(xt[None], p, cfg)}
    alone = {n: time_ms(fn, 10, flush) for n, fn in steps.items()}
    return dict(traced=traced, alone_ms=alone, tokens=N, capacity=C,
                kept_slots=int(keep.sum()), slots=N * k,
                alone_dispatch_combine_share=sum(alone[n] for n in (
                    "_dispatch_indices", "_dispatch", "_combine"))
                / alone["moe_ref"])


def slstm_measure(params, toks, cfg) -> dict:
    """One sLSTM layer of xLSTM's prefill alone at the full batch: its
    host time with the card synchronised (median of 3), and one traced
    call's kernel launches and device busy share. Its scan is a Python loop
    over T, each step a few launches (the reference scans it in XLA)."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.ssm import slstm_forward

    pair = params.pairs[0]
    x = rms_norm(torch.nn.functional.embedding(toks, params.tok_emb),
                 pair.ln_s)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slstm_forward(x, pair.slstm)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prof = device_profile(lambda: slstm_forward(x, pair.slstm), 1)
    return dict(batch=toks.shape[0], seq=toks.shape[1], ms=statistics.median(
        times), launches=prof["kernels"], launches_per_token=prof["kernels"]
        / toks.shape[1], busy_share=prof["busy_share"],
        device_busy_ms=prof["device_busy_ms"])


def lm_serve_phase(dev, flush) -> dict:
    """The LM serving path of a model of every family at full width (see
    phase 11)."""
    from repro_torch import configs
    from repro_torch.kernels.decode_attention import decode_attention_kernel_call
    from repro_torch.kernels.flash_attention import flash_attention_kernel_call
    from repro_torch.kernels.mamba_scan import mamba_scan_kernel_call
    from repro_torch.models import decode_step, forward, init_cache, init_params
    from repro_torch.serve import make_prefill, make_serve_step

    counters = {"flash_attention": flash_attention_kernel_call,
                "decode_attention": decode_attention_kernel_call,
                "mamba_scan": mamba_scan_kernel_call}
    out = {}
    for arch in LM_ARCHS:
        t_arch = time.perf_counter()
        cfg = configs.get(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.parameters())
        gen = torch.Generator(device=dev).manual_seed(0)
        batch, n_logits = lm_full_batch(cfg, gen, dev)
        prefill = make_prefill(cfg)
        with plain_kernels():
            ref = prefill(params, batch)
        torch.cuda.synchronize()

        # the counted run: prefills, then the served batch
        reset_launches(*counters.values())
        times = []
        for _ in range(LM_PREFILL_REPS):
            t0 = time.perf_counter()
            logits = prefill(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        step = make_serve_step(cfg)
        cache = init_cache(cfg, LM_SERVE_B, LM_CACHE_LEN)
        prompt = torch.randint(0, cfg.vocab_size, (LM_SERVE_B, LM_PROMPT),
                               generator=gen, device=dev, dtype=torch.int32)
        t0 = time.perf_counter()
        tok = prompt[:, 0]
        for i in range(1, LM_PROMPT):
            _, cache = step(params, cache, tok)
            tok = prompt[:, i]
        torch.cuda.synchronize()
        prompt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        generated = []
        for _ in range(LM_GEN):
            tok, cache = step(params, cache, tok)
            generated.append(tok)
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        peak = torch.cuda.max_memory_allocated()

        # checks: kernel path against the plain path, the served tokens
        diff = (logits.float() - ref.float()).abs()
        max_err, mean_err = float(diff.max()), float(diff.mean())
        del diff
        agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
        gen_t = torch.stack(generated, 1)
        finite = bool(torch.isfinite(logits).all())
        served_pos = int(cache["pos"][0])

        # decode on the kernel path against the plain path: each step from
        # the same cache (the served batch's, copied for the plain step),
        # fed the kernel path's greedy token
        got, want = [], []
        for _ in range(LM_DECODE_CHECK):
            plain_cache = {k: v.clone() for k, v in cache.items()}
            with plain_kernels():
                want.append(decode_step(params, plain_cache, tok, cfg)[0])
            del plain_cache
            step_logits, cache = decode_step(params, cache, tok, cfg)
            got.append(step_logits)
            tok = step_logits.argmax(-1).to(torch.int32)
        got, want = torch.stack(got).float(), torch.stack(want).float()
        d_gap = (got - want).abs()
        decode_vs_plain = dict(
            steps=LM_DECODE_CHECK, max_abs_err=float(d_gap.max()),
            mean_abs_err=float(d_gap.mean()),
            argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                               .float().mean()),
            finite=bool(torch.isfinite(got).all()))
        del got, want, d_gap
        res = dict(
            arch=arch, family=cfg.family, params=n_params, dtype=cfg.dtype,
            layers=cfg.n_layers, init_s=init_s,
            prefill=dict(batch=LM_PREFILL_B, seq=LM_PREFILL_T,
                         inputs={k: list(v.shape) for k, v in batch.items()},
                         first_ms=times[0] * 1e3,
                         ms=statistics.median(times[1:]) * 1e3,
                         tokens_per_s=LM_PREFILL_B * LM_PREFILL_T
                         / statistics.median(times[1:])),
            vs_plain=dict(max_abs_err=max_err, mean_abs_err=mean_err,
                          argmax_agree=agree, max_abs_logit=float(
                              ref.float().abs().max())),
            decode_vs_plain=decode_vs_plain,
            serve=dict(batch=LM_SERVE_B, prompt=LM_PROMPT, generated=LM_GEN,
                       cache_len=LM_CACHE_LEN,
                       prompt_ms_per_step=prompt_s * 1e3 / (LM_PROMPT - 1),
                       decode_ms_per_step=gen_s * 1e3 / LM_GEN,
                       issue_ms_per_step=issue_s * 1e3 / LM_GEN,
                       **host_state(),
                       decode_tokens_per_s=LM_SERVE_B * LM_GEN / gen_s,
                       first_tokens=gen_t[0, :8].tolist()),
            launches=launches, peak_gb=peak / 1e9)
        check(finite and logits.shape == (LM_PREFILL_B, n_logits,
                                          cfg.vocab_size), f"{arch} logits")
        check(agree >= LM_ARGMAX_MIN and max_err <= LM_LOGIT_MAX_ERR
              and mean_err <= LM_LOGIT_MEAN_ERR, f"{arch} kernel vs plain "
              f"prefill: {res['vs_plain']}")
        check(bool(((gen_t >= 0) & (gen_t < cfg.vocab_size)).all())
              and served_pos == LM_PROMPT + LM_GEN - 1,
              f"{arch} served tokens")
        # B7's plain version repeats the split kernel's arithmetic, and
        # decode reaches no other kernel: the two paths are bitwise twins,
        # every logit equal and so every argmax
        check(decode_vs_plain["finite"]
              and decode_vs_plain["max_abs_err"] == 0.0
              and decode_vs_plain["argmax_agree"] == 1.0,
              f"{arch} kernel vs plain decode: {decode_vs_plain}")
        want = {"hybrid": ["flash_attention", "decode_attention",
                           "mamba_scan"], "ssm": []}.get(
            cfg.family, ["flash_attention", "decode_attention"])
        check(all(launches[k] > 0 for k in want), f"{arch} launches {launches}")

        # where the card's time goes: one prefill (xLSTM's of
        # LM_SSM_PROFILE_T tokens, with its sLSTM layer measured alone),
        # and 4 decode steps; an MoE prefill's steps
        if cfg.family == "ssm":
            short = {"tokens": batch["tokens"][:, :LM_SSM_PROFILE_T]}
            res["profile"] = dict(
                prefill=dict(device_profile(lambda: prefill(params, short), 1),
                             seq=LM_SSM_PROFILE_T))
            res["slstm"] = slstm_measure(params, batch["tokens"], cfg)
        else:
            res["profile"] = dict(prefill=device_profile(
                lambda: prefill(params, batch), 1))
        res["profile"]["decode"] = device_profile(
            lambda: step(params, cache, tok), LM_PROFILE_STEPS)
        if cfg.family == "moe":
            res["moe_breakdown"] = moe_breakdown(
                lambda: prefill(params, batch), params, batch, cfg, flush)

        # both bf16 prefills against a float32 run of the same weights, on
        # the plain path, streamed a layer at a time: the kernel path must
        # come as close to it as the plain path does
        del cache
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        with plain_kernels(), float32_streamed(params):
            truth = make_prefill(cfg32)(params, batch)
        torch.cuda.synchronize()
        truth_peak = torch.cuda.max_memory_allocated()
        del params
        truth_arg = truth.argmax(-1)
        vs_truth = {}
        for side, lg in (("kernel", logits), ("plain", ref)):
            vs_truth[f"{side}_argmax_agree"] = float(
                (lg.argmax(-1) == truth_arg).float().mean())
            vs_truth[f"{side}_mean_abs_err"] = float(
                (lg.float() - truth).abs().mean())
        vs_truth.update(
            truth_dtype=str(truth.dtype), streamed=True,
            peak_gb=truth_peak / 1e9,
            argmax_slack=LM_TRUTH_ARGMAX_SLACK, gap_ratio=LM_TRUTH_GAP_RATIO)
        res["vs_truth"] = vs_truth
        check(truth.dtype == torch.float32 and bool(torch.isfinite(truth).all()),
              f"{arch} float32 truth")
        check(vs_truth["kernel_argmax_agree"]
              >= vs_truth["plain_argmax_agree"] - LM_TRUTH_ARGMAX_SLACK
              and vs_truth["kernel_mean_abs_err"]
              <= LM_TRUTH_GAP_RATIO * vs_truth["plain_mean_abs_err"],
              f"{arch} kernel path against the float32 truth: {vs_truth}")
        del logits, ref, truth, truth_arg, batch
        torch.cuda.empty_cache()

        # float32 at full width, 4 layers: decode reproduces the prefill,
        # and the decode on the plain path reproduces the kernel path's.
        # Where the two compute the same function: MoE at a capacity that
        # drops no slot, the VLM with no patches, whisper with zero frames
        # (its memory then 0, as the decode cache's)
        cfg32 = dataclasses.replace(cfg, n_layers=LM_F32_LAYERS,
                                    dtype="float32")
        if cfg.family == "audio":
            cfg32 = dataclasses.replace(cfg32, encoder_layers=LM_F32_LAYERS)
        if cfg.family == "moe":
            cfg32 = dataclasses.replace(cfg32,
                                        capacity_factor=float(cfg.n_experts))
        p32 = init_params(cfg32, seed=1)
        batch32 = lm_batch(cfg32, 2, LM_F32_T, gen, dev,
                           LM_F32_T if cfg.family == "audio" else 0, zeros=True)
        toks32 = batch32["tokens"]
        full = forward(p32, batch32, cfg32)

        def decode_all():
            c = init_cache(cfg32, 2, LM_F32_T + 1)
            return torch.stack([decode_step(p32, c, toks32[:, t], cfg32)[0]
                                for t in range(LM_F32_T)], 1)

        dec = decode_all()
        with plain_kernels():
            dec_plain = decode_all()

        def gaps(a, b, tol):
            gap = (a - b).abs()
            return dict(max_abs_err=float(gap.max()),
                        max_excess_over_rtol=float((gap - tol * b.abs()).max()),
                        argmax_agree=float((a.argmax(-1) == b.argmax(-1))
                                           .float().mean()))

        vs_fwd = gaps(dec, full, LM_F32_DECODE_TOL)
        vs_plain32 = gaps(dec, dec_plain, LM_F32_PLAIN_TOL)
        res["f32_decode_vs_forward"] = dict(layers=LM_F32_LAYERS, seq=LM_F32_T,
                                            **vs_fwd)
        res["f32_decode_vs_plain"] = dict(layers=LM_F32_LAYERS, seq=LM_F32_T,
                                          **vs_plain32)
        check(vs_fwd["max_excess_over_rtol"] <= LM_F32_DECODE_TOL,
              f"{arch} float32 decode vs forward {res['f32_decode_vs_forward']}")
        check(vs_plain32["max_excess_over_rtol"] <= LM_F32_PLAIN_TOL
              and vs_plain32["argmax_agree"] >= LM_ARGMAX_MIN,
              f"{arch} float32 decode, kernel vs plain path "
              f"{res['f32_decode_vs_plain']}")
        del p32, full, dec, dec_plain
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t_arch
        emit("lm_serve", **res)
        out[arch] = res
    return out


def lm_reduced_phase(dev) -> dict:
    """Each reduced config, in float32 (its own type) and in bf16, weights
    from seed 0 on the card: a prefill of LM_REDUCED_B x LM_REDUCED_T
    tokens (and internvl2's patches, whisper's frames) through
    `make_prefill` (B6 at the config's head dim, on rows padded to the
    kernels' tile width), then a fresh cache, the prompt teacher-forced and
    LM_REDUCED_GEN greedy tokens through `decode_step` (B7). Held bitwise
    against the same run under `plain_kernels()`: the prefill logits, every
    decode step's logits and the greedy tokens. B6's and B7's launches (and
    B8's, for the hybrid) are counted from 0 over the kernel run and must
    be above 0 (xLSTM launches none)."""
    from repro_torch import configs
    from repro_torch.kernels.decode_attention import decode_attention_kernel_call
    from repro_torch.kernels.flash_attention import (
        flash_attention_kernel_call,
        tile_width,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan_kernel_call
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serve import make_prefill

    counters = {"flash_attention": flash_attention_kernel_call,
                "decode_attention": decode_attention_kernel_call,
                "mamba_scan": mamba_scan_kernel_call}
    B, T, n_gen = LM_REDUCED_B, LM_REDUCED_T, LM_REDUCED_GEN
    out = []
    for arch in LM_REDUCED_ARCHS:
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            cfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype)
            params = init_params(cfg, seed=0)
            gen = torch.Generator(device=dev).manual_seed(0)
            n_embed = {"vlm": cfg.num_patches,
                       "audio": T + LM_REDUCED_FRAMES_EXTRA}.get(cfg.family, 0)
            batch = lm_batch(cfg, B, T, gen, dev, n_embed)
            toks = batch["tokens"]
            prefill = make_prefill(cfg)

            def run():
                logits = prefill(params, batch)
                cache = init_cache(cfg, B, T + n_gen)
                steps, tokens = [], []
                tok = toks[:, 0].to(torch.int32)
                for i in range(T + n_gen - 1):
                    step_logits, cache = decode_step(params, cache, tok, cfg)
                    steps.append(step_logits)
                    if i + 1 < T:
                        tok = toks[:, i + 1].to(torch.int32)
                    else:
                        tok = step_logits.argmax(-1).to(torch.int32)
                        tokens.append(tok)
                return logits, torch.stack(steps, 1), torch.stack(tokens, 1)

            reset_launches(*counters.values())
            got = run()
            torch.cuda.synchronize()
            launches = {k: f.launches for k, f in counters.items()}
            with plain_kernels():
                want = run()
            torch.cuda.synchronize()
            res = dict(
                arch=arch, family=cfg.family, dtype=dtype, layers=cfg.n_layers,
                heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.hd,
                tile_width=tile_width(cfg.hd) if cfg.family != "ssm" else None,
                batch=B, prompt=T,
                inputs={k: list(v.shape) for k, v in batch.items()},
                generated=n_gen, launches=launches,
                prefill_bitwise=bool(torch.equal(got[0], want[0])),
                decode_bitwise=bool(torch.equal(got[1], want[1])),
                tokens_equal=bool(torch.equal(got[2], want[2])),
                max_abs_err=max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(got[:2], want[:2])),
                finite=bool(torch.isfinite(got[0]).all()
                            and torch.isfinite(got[1]).all()),
                first_tokens=got[2][0].tolist(),
                seconds=time.perf_counter() - t0)
            emit("lm_reduced", **res)
            check(res["prefill_bitwise"] and res["decode_bitwise"]
                  and res["tokens_equal"] and res["finite"],
                  f"{arch} reduced ({dtype}) kernel vs plain path: {res}")
            want_k = {"hybrid": ["flash_attention", "decode_attention",
                                 "mamba_scan"], "ssm": []}.get(
                cfg.family, ["flash_attention", "decode_attention"])
            check(all(launches[k] > 0 for k in want_k),
                  f"{arch} reduced ({dtype}) launches {launches}")
            out.append(res)
            del params, got, want
    return dict(cases=out, launches={
        k: sum(r["launches"][k] for r in out) for k in counters})


def main() -> None:
    t_start = time.perf_counter()

    # 1. device -------------------------------------------------------------
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device; it runs "
                         "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")

    from repro_torch.convert import forest_from_numpy, forest_tables
    from repro_torch.core.forest import train_forest
    from repro_torch.core.search_space import FeatureRep
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_pipeline import (
        agg_op_table,
        encode_plan,
        fused_agg_call,
        fused_agg_infer_plain,
        fused_forest_infer_plain,
        fused_multi_forest_call,
        fused_pipeline_call,
    )
    from repro_torch.kernels.tree_infer import (
        forest_infer_kernel_call,
        forest_infer_plain,
    )
    from repro_torch.serve.runtime import (
        PacketStream,
        ReuseConfig,
        ServiceModel,
        ShardedRuntime,
        find_zero_loss_rate,
        replay,
    )
    from repro_torch.traffic.extraction import (
        dataset_tensors,
        emit_agg_features,
        extract_features,
        stats_plan,
    )
    from repro_torch.traffic.features import FEATURE_NAMES
    from repro_torch.traffic.models import macro_f1, train_traffic_model
    from repro_torch.traffic.pipeline import build_pipeline
    from repro_torch.traffic.synth import make_dataset, make_scenario_dataset

    # printed only once the port imports: outside a checkout nothing prints
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         seconds=time.perf_counter() - t0)

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build_library()
    _build.load_library()
    log = (lib.parent / "build.log").read_text()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib),
         nvcc_flags=" ".join(_build.NVCC_FLAGS),
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])
    emit("build_ptxas", entries=ptxas_entries(log, (
        "decode_split_kernel", "decode_merge_kernel", "forest_infer_kernel",
        "fused_forest_infer_kernel", "fused_agg_infer_kernel",
        "fused_multi_forest_kernel",
        "chunk_cb_kernel", "chunk_state_kernel", "state_pass_kernel",
        "chunk_scan_kernel")))

    # 3. data and forests ----------------------------------------------------
    t0 = time.perf_counter()
    ds = make_dataset("iot-class", n_flows=4000, max_pkts=128, seed=0)
    train, test = ds.split(test_frac=0.2, seed=0)
    conn_depth = 50
    rep = FeatureRep(tuple(FEATURE_NAMES), depth=conn_depth)
    x_train = extract_features(train, rep.features, conn_depth, device="cpu")
    rf, val_f1 = train_traffic_model(x_train, train.label, model="rf", seed=0)
    deep = train_forest(x_train, train.label, n_trees=25, max_depth=10,
                        max_features="sqrt", rng=np.random.default_rng(0))
    forests = {"rf": rf, "rf_depth10": deep}
    big = ds.take(np.arange(4096) % ds.n_flows)
    emit("data", flows=ds.n_flows, max_pkts=ds.max_pkts, classes=28,
         features=len(rep.features), conn_depth=conn_depth,
         forests={k: dict(trees=f.n_trees, depth=f.depth, classes=f.n_out)
                  for k, f in forests.items()},
         rf_validation_f1=val_f1, seconds=time.perf_counter() - t0)
    check(deep.n_out == 28 and deep.depth == 10 and deep.n_trees == 25,
          "deep forest shape")

    # the stream phase's deployment, and the aggregate rows B3 is checked on
    t0 = time.perf_counter()
    ds_s = make_scenario_dataset("app-class", "zipf", n_flows=STREAM_FLOWS,
                                 max_pkts=STREAM_PKTS, seed=3)
    stream = PacketStream.from_dataset(ds_s, seed=0)
    inc_names = tuple(f for f in FEATURE_NAMES if not f.endswith("_med"))
    rep_s = FeatureRep(inc_names, depth=conn_depth)
    x_s = extract_features(ds_s, inc_names, conn_depth, device="cuda")
    forest_s, f1_s = train_traffic_model(x_s, ds_s.label, model="rf", seed=0)
    agg_rows, agg_meta = table_rows(stream, conn_depth)
    emit("stream_data", flows=ds_s.n_flows, max_pkts=ds_s.max_pkts,
         events=stream.n_events, base_pps=stream.base_pps,
         features=len(inc_names), conn_depth=conn_depth,
         forest=dict(trees=forest_s.n_trees, depth=forest_s.depth,
                     classes=forest_s.n_out),
         rf_validation_f1=f1_s, table_rows=len(agg_rows),
         seconds=time.perf_counter() - t0)
    check(forest_s.n_trees == 25 and len(agg_rows) >= 64,
          "stream deployment shape")

    # the two multi-tenant deployments B4 is checked on: "wide", three
    # tenants over the iot-class set (the registry at depths 50 and 16, the
    # 59 incremental features at 50, one `rf` forest each), and "fleet",
    # the multitenant phase's four tenants with their tree-fast forests
    t0 = time.perf_counter()
    reps_w = [rep, FeatureRep(tuple(FEATURE_NAMES), depth=16),
              FeatureRep(inc_names, depth=conn_depth)]
    forests_w = [rf]
    for r in reps_w[1:]:
        x_r = extract_features(train, r.features, r.depth, device="cpu")
        forests_w.append(train_traffic_model(x_r, train.label, model="rf",
                                             seed=0)[0])
    ds_m = make_scenario_dataset("app-class", "zipf", n_flows=MT_FLOWS,
                                 max_pkts=MT_PKTS, seed=3)
    reps_m = [FeatureRep(f, depth=d) for f, d in MT_TENANTS]
    forests_m = [train_traffic_model(
        extract_features(ds_m, r.features, r.depth, device="cpu"), ds_m.label,
        model="tree-fast", seed=t)[0] for t, r in enumerate(reps_m)]
    _, merged_w, _ = merged_of(reps_w)
    _, merged_m, _ = merged_of(reps_m)
    emit("multitenant_data",
         wide=dict(flows=ds.n_flows, max_pkts=ds.max_pkts,
                   tenants=[dict(features=len(r.features), depth=r.depth,
                                 trees=f.n_trees, forest_depth=f.depth,
                                 classes=f.n_out)
                            for r, f in zip(reps_w, forests_w)],
                   merged_columns=len(merged_w),
                   k_sum=sum(f.n_out for f in forests_w)),
         fleet=dict(flows=ds_m.n_flows, max_pkts=ds_m.max_pkts,
                    tenants=[dict(features=len(r.features), depth=r.depth,
                                  trees=f.n_trees, forest_depth=f.depth,
                                  classes=f.n_out)
                             for r, f in zip(reps_m, forests_m)],
                    merged_columns=len(merged_m),
                    k_sum=sum(f.n_out for f in forests_m)),
         seconds=time.perf_counter() - t0)
    check(len(merged_w) == 131 and sum(f.n_out for f in forests_w) == 84,
          "the wide B4 configuration: 131 merged columns, 84 lanes")

    # 4. kernels vs plain, on the card ---------------------------------------
    t0 = time.perf_counter()
    plan67 = stats_plan(rep.features)
    bt = dataset_tensors(big, dev)
    packets = [bt[k] for k in ("ts", "size", "direction", "ttl", "winsize",
                               "flags", "flow_len", "proto", "s_port", "d_port")]
    x_main = extract_features(big, rep.features, conn_depth, device="cuda")
    x_main_t = torch.from_numpy(x_main).to(dev)

    # B1 on one and the same x: the plain version's bits
    b1_err = 0.0
    b1_cases = []
    for name, n, n_trees in (("main", 4096, 25), ("ragged", 257, 12)):
        tables = [t[:n_trees].contiguous() for t in forest_tables(deep, dev)]
        x = x_main_t[:n].contiguous()
        want = forest_infer_plain(x, *tables, deep.depth)
        got = forest_infer_kernel_call(x, *tables, deep.depth)
        err = float((got - want).abs().max())
        mism = int((got.argmax(1) != want.argmax(1)).sum())
        b1_cases.append(dict(case=name, N=n, F=67, T=n_trees, D=deep.depth,
                             K=deep.n_out, max_abs_err=err,
                             argmax_mismatches=mism,
                             bitwise=torch.equal(got, want)))
        check(b1_cases[-1]["bitwise"], f"B1 {name}: {b1_cases[-1]}")
        b1_err = max(b1_err, err)
    emit("kernel_check", kernel="forest_infer", cases=b1_cases)

    # B2: the kernel's own columns against the plain columns, probabilities
    # by the straddle rule, for plans covering every op family
    subsets = [
        ("dur", "proto", "s_port", "d_port"),
        ("s_load", "d_load", "s_pkt_cnt", "d_pkt_cnt"),
        ("tcp_rtt", "syn_ack", "ack_dat", "syn_cnt", "ack_cnt", "fin_cnt"),
        ("s_bytes_sum", "s_bytes_mean", "s_bytes_min", "s_bytes_max",
         "s_bytes_med", "s_bytes_std"),
        ("d_iat_mean", "d_iat_std", "d_iat_med", "s_iat_min", "s_iat_max"),
        ("s_winsize_mean", "d_winsize_std", "s_ttl_min", "d_ttl_max",
         "d_winsize_med"),
        tuple(FEATURE_NAMES),
    ]
    rng = np.random.default_rng(5)
    b2_err, b2_straddled, b2_mism, b2_col_err, b2_cases = 0.0, 0, 0, 0.0, []
    for names in subsets:
        plan = stats_plan(names)
        op_table = torch.from_numpy(encode_plan(plan)).to(dev)
        for d in (1, 8, 50):
            # a random depth-10 forest whose thresholds are quantile edges
            # of the plain columns, as the trainer's are: ties happen
            xp = extract_features(big, names, d, device="cpu")
            T, D, K, F = 25, 10, 28, len(plan)
            feature = rng.integers(0, F, (T, 2 ** D - 1))
            q = rng.random((T, 2 ** D - 1))
            threshold = np.quantile(xp, q.ravel(), axis=0, method="lower")[
                np.arange(q.size), feature.ravel()].reshape(T, -1)
            forest = forest_from_numpy(feature, threshold,
                                       rng.random((T, 2 ** D, K)), D, F)
            tables = forest_tables(forest, dev)
            outs = {}
            for side, fn in (("kernel", fused_pipeline_call),
                             ("plain", fused_forest_infer_plain)):
                cols = torch.empty((big.n_flows, F), device=dev)
                p = fn(*packets, *tables, op_table=op_table, depth=d,
                       forest_depth=D, columns=cols)
                outs[side] = (p, cols)
            torch.cuda.synchronize()
            (pk, xk), (pp, xq) = ((p.cpu().numpy(), c.cpu().numpy())
                                  for p, c in outs.values())
            col_err = float((np.abs(xk - xq) / np.maximum(np.abs(xq), 1e-6)).max())
            check(np.allclose(xk, xq, rtol=1e-5, atol=1e-6),
                  f"B2 columns {names[:2]} depth {d}: rel err {col_err}")
            r = straddle_compare(pp, pk, xq, xk, forest, f"B2 {names[:2]} d{d}")
            b2_cases.append(dict(plan=len(plan), first=names[0], depth=d,
                                 columns_bitwise=bool((xk == xq).all()),
                                 max_col_rel_err=col_err, **r))
            b2_err = max(b2_err, r["max_abs_err"])
            b2_straddled += r["straddled"]
            b2_mism += r["argmax_mismatches"]
            b2_col_err = max(b2_col_err, col_err)
    emit("kernel_check", kernel="fused_forest_infer", cases=b2_cases)

    # B3: the kernel's own columns against the plain columns on aggregate
    # rows of a real table, probabilities by the straddle rule
    b3_err, b3_straddled, b3_mism, b3_cols_differ, b3_cases = 0.0, 0, 0, 0, []
    for names in AGG_PLANS + (inc_names,):
        plan = stats_plan(names)
        op_table = agg_op_table(encode_plan(plan), dev)
        for n in (8, 777, 4096):
            idx = np.arange(n) % len(agg_rows)
            a = torch.from_numpy(agg_rows[idx].astype(np.float32)).to(dev)
            m = torch.from_numpy(agg_meta[idx]).to(dev)
            x_plain = torch.stack(emit_agg_features(
                plan, a, proto=m[:, 0], s_port=m[:, 1], d_port=m[:, 2]),
                dim=1).cpu().numpy()
            forest = quantile_forest(x_plain, rng)
            tables = forest_tables(forest, dev)
            outs = {}
            for side, fn in (("kernel", fused_agg_call),
                             ("plain", fused_agg_infer_plain)):
                cols = torch.empty((n, len(plan)), device=dev)
                p = fn(a, m, *tables, op_table=op_table,
                       forest_depth=forest.depth, columns=cols)
                outs[side] = (p, cols)
            torch.cuda.synchronize()
            (pk, xk), (pp, xq) = ((p.cpu().numpy(), c.cpu().numpy())
                                  for p, c in outs.values())
            check(np.isfinite(xk).all(), f"B3 columns {names[:2]} N={n}")
            bitwise = bool((xk == xq).all())
            # columns that differ must leave the forest's choices alone on
            # all but 1% of flows: the same straddle rule
            r = straddle_compare(pp, pk, xq, xk, forest, f"B3 {names[:2]} N={n}")
            b3_cases.append(dict(plan=len(plan), first=names[0], N=n,
                                 columns_bitwise=bitwise,
                                 probabilities_bitwise=bool((pk == pp).all()),
                                 max_col_abs_err=float(np.abs(xk - xq).max()),
                                 **r))
            b3_err = max(b3_err, r["max_abs_err"])
            b3_straddled += r["straddled"]
            b3_mism += r["argmax_mismatches"]
            b3_cols_differ += 0 if bitwise else 1
    emit("kernel_check", kernel="fused_agg_infer", cases=b3_cases)
    check(b3_cols_differ == 0 and b3_straddled == 0,
          "B3's columns bitwise the plain version's, no flow straddled")

    # times at the main-path shapes, with the deep forest
    deep_tables = forest_tables(deep, dev)
    op67 = torch.from_numpy(encode_plan(plan67)).to(dev)
    x_read, nodes, leaves = forest_touch(x_main, deep)
    N, K = big.n_flows, deep.n_out
    T, D = deep.n_trees, deep.depth
    b1_bytes = 4 * x_read + 8 * nodes + 4 * K * leaves + 4 * N * K
    b1_ops = N * T * (2 * D + K)
    # the fused kernel reads the packets instead of x; its columns equal x
    L = np.minimum(np.minimum(big.flow_len, conn_depth), big.max_pkts)
    b2_bytes = (int(L.sum()) * (4 * 4 + 1 + 8) + N * 16 + op67.numel() * 4
                + 8 * nodes + 4 * K * leaves + 4 * N * K)
    b2_ops = int(L.sum()) * len(plan67) + N * T * (2 * D + K)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    # the first 128 flows: one micro-batch, the size the main path serves
    x_128 = x_main_t[:128].contiguous()
    packets_128 = [t[:128].contiguous() for t in packets]
    # and a micro-batch of 8, the stream phase's size
    packets_8 = [t[:8].contiguous() for t in packets]
    # B1 at 4096 and 128 flows, with the wrapper's host time and without
    b1_calls = {sfx: (lambda x=x: forest_infer_kernel_call(
        x, *deep_tables, D)) for sfx, x in (("", x_main_t), ("_128", x_128))}
    timing = {
        "forest_infer": dict(
            plain_ms=time_ms(lambda: forest_infer_plain(
                x_main_t, *deep_tables, D), PLAIN_REPS, flush),
            **{f"ms{k}": time_ms(fn, KERNEL_REPS, flush)
               for k, fn in b1_calls.items()},
            **{f"device_ms{k}": time_ms(fn, KERNEL_REPS, flush, queued=True)
               for k, fn in b1_calls.items()},
            bytes=b1_bytes, ops=b1_ops),
        "fused_forest_infer": dict(
            ms=time_ms(lambda: fused_pipeline_call(
                *packets, *deep_tables, op_table=op67, depth=conn_depth,
                forest_depth=D), KERNEL_REPS, flush),
            plain_ms=time_ms(lambda: fused_forest_infer_plain(
                *packets, *deep_tables, op_table=op67, depth=conn_depth,
                forest_depth=D), PLAIN_REPS, flush),
            ms_128=time_ms(lambda: fused_pipeline_call(
                *packets_128, *deep_tables, op_table=op67, depth=conn_depth,
                forest_depth=D), KERNEL_REPS, flush),
            ms_8=time_ms(lambda: fused_pipeline_call(
                *packets_8, *deep_tables, op_table=op67, depth=conn_depth,
                forest_depth=D), KERNEL_REPS, flush),
            **{f"device_ms{sfx}": time_ms(lambda p=p: fused_pipeline_call(
                *p, *deep_tables, op_table=op67, depth=conn_depth,
                forest_depth=D), KERNEL_REPS, flush, queued=True)
               for sfx, p in (("", packets), ("_128", packets_128),
                              ("_8", packets_8))},
            bytes=b2_bytes, ops=b2_ops),
    }
    # B3 on the stream deployment: the 59-feature plan, its trained forest,
    # 4096 flows and one refresh micro-batch of 8
    s_tables = forest_tables(forest_s, dev)
    op59 = agg_op_table(encode_plan(stats_plan(inc_names)), dev)
    idx = np.arange(4096) % len(agg_rows)
    a_big = torch.from_numpy(agg_rows[idx].astype(np.float32)).to(dev)
    m_big = torch.from_numpy(agg_meta[idx]).to(dev)
    a_8, m_8 = a_big[:8].contiguous(), m_big[:8].contiguous()
    x_agg = torch.empty((4096, len(inc_names)), device=dev)
    fused_agg_call(a_big, m_big, *s_tables, op_table=op59,
                   forest_depth=forest_s.depth, columns=x_agg)
    x_read, nodes, leaves = forest_touch(x_agg.cpu().numpy(), forest_s)
    Ks, Ts, Ds = forest_s.n_out, forest_s.n_trees, forest_s.depth
    # each flow's 53 + 3 floats in, the op table, the visited node and leaf
    # entries, N x K floats out
    b3_bytes = (4096 * 56 * 4 + op59.numel() * 4 + 8 * nodes
                + 4 * Ks * leaves + 4 * 4096 * Ks)
    b3_ops = 4096 * (4 * len(inc_names) + Ts * (2 * Ds + Ks))
    timing["fused_agg_infer"] = dict(
        ms=time_ms(lambda: fused_agg_call(
            a_big, m_big, *s_tables, op_table=op59,
            forest_depth=Ds), KERNEL_REPS, flush),
        plain_ms=time_ms(lambda: fused_agg_infer_plain(
            a_big, m_big, *s_tables, op_table=op59,
            forest_depth=Ds), PLAIN_REPS, flush),
        ms_8=time_ms(lambda: fused_agg_call(
            a_8, m_8, *s_tables, op_table=op59,
            forest_depth=Ds), KERNEL_REPS, flush),
        plain_ms_8=time_ms(lambda: fused_agg_infer_plain(
            a_8, m_8, *s_tables, op_table=op59,
            forest_depth=Ds), PLAIN_REPS, flush),
        **{f"device_ms{sfx}": time_ms(lambda a=a, m=m: fused_agg_call(
            a, m, *s_tables, op_table=op59, forest_depth=Ds), KERNEL_REPS,
            flush, queued=True)
           for sfx, a, m in (("", a_big, m_big), ("_8", a_8, m_8))},
        shape=dict(N=4096, F=len(inc_names), T=Ts, D=Ds, K=Ks),
        bytes=b3_bytes, ops=b3_ops)
    for v in timing.values():
        v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["ops"])
    emit("kernel_times", shape=dict(N=N, F=67, T=T, D=D, K=K, P=big.max_pkts,
                                    conn_depth=conn_depth),
         reps=dict(kernel=KERNEL_REPS, plain=PLAIN_REPS), timing=timing,
         seconds=time.perf_counter() - t0)

    # B4: merged columns bitwise equal to the plain ones, probabilities by
    # the straddle rule with no flow straddled, every lane bitwise equal to
    # solo B2; then its times at 4096 and 32 flows
    t0 = time.perf_counter()
    b4 = {"wide": b4_check("wide", ds, reps_w, forests_w, dev, flush),
          "fleet": b4_check("fleet", ds_m, reps_m, forests_m, dev, flush)}
    emit("kernel_check", kernel="fused_multi_forest_infer",
         cases=b4["wide"]["cases"] + b4["fleet"]["cases"])
    emit("kernel_times_b4", timing={k: v["timing"] for k, v in b4.items()},
         reps=dict(kernel=KERNEL_REPS, plain=PLAIN_REPS),
         seconds=time.perf_counter() - t0)

    # B4 beyond the 256 columns one thread per flow held: four tenants over
    # the registry at four depths on the iot-class window, 259 merged columns
    t0 = time.perf_counter()
    reps_wm = [FeatureRep(tuple(FEATURE_NAMES), depth=d) for d in WM_DEPTHS]
    rng_wm = np.random.default_rng(259)
    wm = b4_check("wide_merge", ds, reps_wm, [quantile_forest(
        extract_features(ds, r.features, r.depth, device="cpu"), rng_wm)
        for r in reps_wm], dev, flush)
    check(all(c["merged_columns"] == 259 for c in wm["cases"]),
          f"the wide merge has {wm['cases'][0]['merged_columns']} columns")
    emit("kernel_check", kernel="fused_multi_forest_infer", config="wide_merge",
         cases=wm["cases"])
    emit("kernel_times_wide_merge", timing=wm["timing"],
         reps=dict(kernel=KERNEL_REPS, plain=PLAIN_REPS),
         seconds=time.perf_counter() - t0)

    # B2 and B4 at windows above their shared-memory chunk, and a
    # replayed profiler evaluation there
    lw = long_window_phase(ds_s, dev, flush, {
        "forest_infer": forest_infer_kernel_call,
        "fused_forest_infer": fused_pipeline_call})
    emit("long_window_seconds", seconds=lw["seconds"])

    # B5's path, the entry point on the main path's two windows, counted;
    # then B5 against its plain version on every case, then its times
    t0 = time.perf_counter()
    b5 = b5_check(b5_inputs(ds, ds_s), dev, flush)
    emit("flow_stats_path", launches=b5["launches"], cases=b5["path"])
    emit("kernel_check", kernel="flow_stats", cases=b5["cases"])
    emit("kernel_times_b5", timing=b5["timing"],
         reps=dict(kernel=KERNEL_REPS, plain=PLAIN_REPS),
         seconds=time.perf_counter() - t0)

    # B6-B8 against their plain versions, then their times
    t0 = time.perf_counter()
    lm = lm_kernel_phase(dev, flush)
    emit("lm_kernel_times", timing=lm["timing"],
         reps=dict(kernel=KERNEL_REPS, plain=PLAIN_REPS),
         seconds=time.perf_counter() - t0)

    # 5. main path, serving ---------------------------------------------------
    t0 = time.perf_counter()
    buckets = [2 ** i for i in range(8)]                    # 1 .. 128
    micro = [ds.take(np.arange(i * 128, (i + 1) * 128)) for i in range(16)]
    pipes = {}
    for fname, forest in forests.items():
        for fused in (True, False):
            p = build_pipeline(rep, forest, max_pkts=conn_depth, fused=fused)
            p.warm(buckets)
            pipes[fname, fused] = p
    torch.cuda.synchronize()

    forest_infer_kernel_call.launches = 0
    fused_pipeline_call.launches = 0
    served = {}
    for (fname, fused), p in pipes.items():
        ms, preds = [], []
        for b in micro:
            s = time.perf_counter()
            preds.append(p(b))
            ms.append((time.perf_counter() - s) * 1e3)
        s = time.perf_counter()
        probs_big = p.probabilities(big)
        ms_big = (time.perf_counter() - s) * 1e3
        pred_test = p(test)
        served[fname, fused] = dict(
            micro_preds=np.concatenate(preds), probs_big=probs_big,
            f1=macro_f1(test.label, pred_test),
            micro_ms_median=statistics.median(ms), micro_ms_max=max(ms),
            micro_flows_per_s=128 / (statistics.median(ms) / 1e3),
            big_ms=ms_big, big_flows_per_s=4096 / (ms_big / 1e3))
    torch.cuda.synchronize()
    launches = {"forest_infer": forest_infer_kernel_call.launches,
                "fused_forest_infer": fused_pipeline_call.launches}
    n_pipes = len(forests)
    per_pipe = len(micro) + 2
    check(launches["forest_infer"] == n_pipes * per_pipe,
          f"forest kernel launched {launches['forest_infer']} times on the "
          f"main path, expected {n_pipes * per_pipe}")
    check(launches["fused_forest_infer"] == n_pipes * per_pipe,
          f"fused kernel launched {launches['fused_forest_infer']} times on "
          f"the main path, expected {n_pipes * per_pipe}")

    # outside the counted run: the columns each path computed, and the
    # CPU plain pipeline, for the straddle comparisons on the 4096 batch
    x_cpu = extract_features(big, rep.features, conn_depth, device="cpu")
    x_gpu = x_main
    x_ker = torch.empty((big.n_flows, len(plan67)), device=dev)
    fused_pipeline_call(*packets, *deep_tables, op_table=op67, depth=conn_depth,
                        forest_depth=D, columns=x_ker)
    x_ker = x_ker.cpu().numpy()
    for fname, forest in forests.items():
        cpu = build_pipeline(rep, forest, max_pkts=conn_depth, fused=True,
                             device="cpu")
        p_cpu = cpu.probabilities(big)
        f, u = served[fname, True], served[fname, False]
        cmp = {
            "fused_vs_cpu": straddle_compare(p_cpu, f["probs_big"], x_cpu,
                                             x_ker, forest, f"{fname} fused"),
            "unfused_vs_cpu": straddle_compare(p_cpu, u["probs_big"], x_cpu,
                                               x_gpu, forest, f"{fname} unfused"),
            "fused_vs_unfused": straddle_compare(u["probs_big"], f["probs_big"],
                                                 x_gpu, x_ker, forest,
                                                 f"{fname} fused/unfused"),
        }
        # a micro-batch serves a flow as the 4096 batch does
        for fused in (True, False):
            s = served[fname, fused]
            big_pred = s["probs_big"][:2048].argmax(1)
            check(np.array_equal(s["micro_preds"],
                                 forest.classes[big_pred]),
                  f"{fname} fused={fused}: micro-batch and big-batch "
                  "predictions differ")
        check(abs(f["f1"] - u["f1"]) < 0.01, f"{fname}: macro-F1 fused "
              f"{f['f1']} vs unfused {u['f1']}")
        emit("main_path", forest=fname, trees=forest.n_trees,
             depth=forest.depth, classes=forest.n_out,
             macro_f1={"fused": f["f1"], "unfused": u["f1"]},
             micro_batch={"flows": 128, "count": len(micro),
                          "fused_ms": f["micro_ms_median"],
                          "unfused_ms": u["micro_ms_median"],
                          "fused_ms_max": f["micro_ms_max"],
                          "unfused_ms_max": u["micro_ms_max"],
                          "fused_flows_per_s": f["micro_flows_per_s"],
                          "unfused_flows_per_s": u["micro_flows_per_s"]},
             batch_4096={"fused_ms": f["big_ms"], "unfused_ms": u["big_ms"],
                         "fused_flows_per_s": f["big_flows_per_s"],
                         "unfused_flows_per_s": u["big_flows_per_s"]},
             compare=cmp)
    emit("main_path_launches", launches=launches, pipelines=n_pipes * 2,
         batches_per_pipeline=per_pipe, seconds=time.perf_counter() - t0)

    # where the card's time goes while one pipeline serves the 16
    # micro-batches (a separate, traced run: its times are not the above)
    t0 = time.perf_counter()
    share = {}
    for fused in (True, False):
        p = pipes["rf_depth10", fused]
        share["fused" if fused else "unfused"] = device_profile(
            lambda: [p(b) for b in micro], 1)
    emit("device_share", forest="rf_depth10", profile=share,
         seconds=time.perf_counter() - t0)

    # 6. stream: the runtime on the card ------------------------------------
    t0 = time.perf_counter()
    pipe_s = build_pipeline(rep_s, forest_s, max_pkts=conn_depth, fused=True)
    check(pipe_s.supports_agg, "the stream pipeline has no aggregate entry")
    ring = max(64, min(6144, stream.n_events // 6))

    def fleet(pipe, reuse):
        def make(execute):
            return ShardedRuntime(pipe, n_shards=4, capacity=2048, max_batch=8,
                                  flush_timeout_s=2e-4, execute=execute,
                                  reuse=reuse)
        return make

    counters = {"forest_infer": forest_infer_kernel_call,
                "fused_forest_infer": fused_pipeline_call,
                "fused_agg_infer": fused_agg_call}
    arms = {}
    for tag, reuse in (("off", None),
                       ("on", ReuseConfig(drift_threshold=0.1,
                                          refresh_every=256))):
        ta = time.perf_counter()
        make = fleet(pipe_s, reuse)
        svc = ServiceModel.measure(make(True), stream, n_pkt_sample=16000,
                                   reps=5, calibrate_warm=True)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        pps, st = find_zero_loss_rate(stream, make, svc, iters=BISECT_ITERS,
                                      ring_capacity=ring)
        torch.cuda.synchronize()
        n_launch = {k: fn.launches for k, fn in counters.items()}
        m = st.metrics
        arms[tag] = dict(
            zero_loss_pps=pps, zero_loss_gbps=st.offered_gbps, drops=st.drops,
            latency_p50_s=st.latency_p50_s, latency_p99_s=st.latency_p99_s,
            reuse_hits=m.reuse_hits, refreshes=m.refreshes,
            forced_reinfer=m.forced_reinfer, flows_predicted=m.flows_predicted,
            batches=m.batches, load_imbalance=st.load_imbalance,
            stage_seconds=st.stage_seconds,
            service=dict(pkt_accum_ns=svc.pkt_accum_ns,
                         pkt_track_ns=svc.pkt_track_ns,
                         pkt_frozen_ns=svc.pkt_frozen_ns,
                         bucket_ns=svc.bucket_ns,
                         gather_ns_per_flow=svc.gather_ns_per_flow,
                         reuse_check_ns=svc.reuse_check_ns),
            launches=n_launch, seconds=time.perf_counter() - ta)
        emit("stream", arm=tag, **arms[tag])
        check(st.drops == 0, f"reuse {tag}: {st.drops} drops at the "
              "reported zero-loss rate")
        check(len(st.predictions) == ds_s.n_flows,
              f"reuse {tag}: {len(st.predictions)} flows predicted")
        check(n_launch["fused_forest_infer"] > 0,
              f"reuse {tag}: the fused kernel was not launched")
    check(arms["on"]["launches"]["fused_agg_infer"] > 0,
          "the aggregate kernel was not launched on the reuse arm")
    check(arms["off"]["launches"]["fused_agg_infer"] == 0,
          "the aggregate kernel was launched with reuse off")

    # threshold 0: every refresh re-infers, and predictions stay bitwise
    # the reuse-off replay's (first prediction wins); the refreshed ones
    # agree with the two-launch pipeline's by the straddle rule's limit
    tp = time.perf_counter()
    syn = ServiceModel(pkt_accum_ns=800.0, pkt_track_ns=200.0,
                       bucket_ns={8: 3e4, 16: 4e4, 32: 6e4, 64: 1e5},
                       gather_ns_per_flow=200.0, pkt_frozen_ns=100.0,
                       source="synthetic")
    thr0 = ReuseConfig(drift_threshold=0.0, refresh_every=256)
    pipe_u = build_pipeline(rep_s, forest_s, max_pkts=conn_depth, fused=False)

    def run(pipe, reuse):
        made = []

        def make():
            made.append(fleet(pipe, reuse)(True))
            return made[-1]

        st = replay(stream, make, stream.base_pps, syn, ring_capacity=ring)
        live = {}
        for w in made[0].shards:
            live.update(w.dispatcher.live_predictions)
        return st, live

    base, _ = run(pipe_s, None)
    fused0, live_f = run(pipe_s, thr0)
    unfused0, live_u = run(pipe_u, thr0)
    same = (set(base.predictions) == set(fused0.predictions)
            and all(np.array_equal(base.predictions[k], fused0.predictions[k])
                    for k in base.predictions))
    check(same, "threshold-0 predictions differ from the reuse-off replay")
    check(set(live_f) == set(live_u) and len(live_f) > 0,
          "refreshed flows differ between fused and two-launch replays")
    live_differ = sum(int(live_f[k] != live_u[k]) for k in live_f)
    check(live_differ <= MAX_STRADDLED * len(live_f),
          f"{live_differ} of {len(live_f)} refreshed predictions differ "
          "between B3 and torch emission + B1")
    check(fused0.metrics.forced_reinfer > 0, "threshold 0 forced nothing")
    parity = dict(flows=len(base.predictions), threshold0_bitwise=same,
                  forced_reinfer=fused0.metrics.forced_reinfer,
                  refreshed_flows=len(live_f),
                  refreshed_differ_fused_vs_unfused=live_differ,
                  seconds=time.perf_counter() - tp)
    emit("stream_parity", **parity)
    ratio = arms["on"]["zero_loss_pps"] / arms["off"]["zero_loss_pps"]
    emit("stream_summary", flows=ds_s.n_flows, events=stream.n_events,
         shards=4, max_batch=8, ring_capacity=ring, bisect_iters=BISECT_ITERS,
         reuse_on_off_pps_ratio=ratio, seconds=time.perf_counter() - t0)

    # 7. multitenant: one shared fleet against independent fleets ----------
    t0 = time.perf_counter()
    counters["fused_multi_forest_infer"] = fused_multi_forest_call
    mt = multitenant_phase(ds_m, reps_m, forests_m, counters)
    emit("multitenant_seconds", seconds=time.perf_counter() - t0)

    # 8. cotune: CATO's joint loop on the port ------------------------------
    co = cotune_phase(counters)

    # 8b. fig5: CATO against its baselines, measured through B2 -------------
    fig5 = fig5_phase(counters)

    # 9. control: the adaptive fleet, deploy and observability --------------
    ctl = control_phase(counters)

    # 10. selftune: drift -> re-tune -> hot-swap -----------------------------
    tune = selftune_phase(counters)

    # 11. lm_serve: the LM serving path at full width ------------------------
    t0 = time.perf_counter()
    lm_serve = lm_serve_phase(dev, flush)
    emit("lm_serve_seconds", seconds=time.perf_counter() - t0)

    # 12. lm_reduced: every reduced config with attention, through B6/B7 --
    t0 = time.perf_counter()
    lm_red = lm_reduced_phase(dev)
    emit("lm_reduced_summary", launches=lm_red["launches"],
         configs=len(lm_red["cases"]), seconds=time.perf_counter() - t0)

    # 13. train_kernels: B6b and B8b against their plain versions, times --
    t0 = time.perf_counter()
    trk = train_kernel_phase(dev, flush)
    torch.cuda.empty_cache()
    trk_seconds = time.perf_counter() - t0

    # 14. train: zamba2-1.2b at full width, through launch.train ----------
    t0 = time.perf_counter()
    step0 = step0_vs_plain(dev)
    emit("train_step0_vs_plain", **step0)
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt_root:
        train = train_phase(dev, ckpt_root)
        emit("train", **train, seconds=time.perf_counter() - t0)
        # each launch's device ms, from the traced step
        for name, per in train["launch_ms"].items():
            trk["timing"][f"{name}/zamba2-1.2b-train"]["launches_timed"] = per
        emit("train_kernel_times", timing=trk["timing"], seconds=trk_seconds)

        # 14b. multicard: data- and expert-parallel training over NCCL,
        # then serving over the mesh; meanwhile, on the host, 14c. the
        # census of the train phase's cell, beside its measured peak ------
        mc_train, _, mc_moe, mc_serve, census = multicard_phase(
            ckpt_root, train, during=lambda: census_train_cell(train))
    emit("multicard_train", **mc_train)
    emit("multicard_moe", **mc_moe)
    mc_launches = {k: mc_train["launches"][k] + mc_moe["launches"][k]
                   + sum(r["launches"].get(k, 0) for r in mc_serve)
                   for k in mc_train["launches"]}
    mc_launches["decode_attention"] = sum(r["launches"]["decode_attention"]
                                          for r in mc_serve)

    emit("census_train", **census)

    # 15. train_reduced: every reduced config, kernels against plain -------
    t0 = time.perf_counter()
    tr_red = train_reduced_phase(dev)
    emit("train_reduced_summary", launches=tr_red["launches"],
         configs=len(tr_red["cases"]), example=tr_red["example"],
         seconds=time.perf_counter() - t0)

    def lm_entry(name, source, replaces, main_case, extra_cases=()):
        t = lm["timing"][f"{name}/{main_case}"]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(r["launches"][name] for r in lm_serve.values()),
            launches_by_model={a: r["launches"][name]
                               for a, r in lm_serve.items()},
            reduced_launches=lm_red["launches"][name],
            multicard_launches=mc_launches.get(name),
            max_abs_err=max(c["max_abs_err"] for c in lm["cases"]
                            if c["kernel"] == name),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            shape=t["shape"])
        # device-only times (B7, B8), B7's split count and B8's grid,
        # where measured
        extra = ("device_ms", "library_device_ms", "split", "blocks",
                 "scratch_bytes", "passes", "stats_ms", "stats_device_ms")
        entry.update({k: t[k] for k in extra if k in t})
        for case in extra_cases:
            e = lm["timing"][f"{name}/{case}"]
            entry[case] = {k: e[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms",
                                             "shape", "dtype", "causal",
                                             *extra)
                           if k in e}
        return entry

    def train_entry(name, source, forward_of, autodiff_of):
        t = trk["timing"][f"{name}/zamba2-1.2b-train"]
        return dict(
            name=name, route="cuda", source=source, replaces=forward_of,
            replaces_note=("the gradient of the kernel there: the reference "
                           "has no backward kernel and differentiates "
                           f"{autodiff_of} with XLA's autodiff"),
            launches=train["launches"][name],
            launches_per_step=train["launches_per_step"][name],
            step0_launches=step0["launches"][name],
            reduced_launches=tr_red["launches"][name],
            example_launches=tr_red["example"]["launches"][name],
            multicard_launches=mc_launches[name],
            max_abs_err=max(c["max_abs_err"] for c in trk["cases"]
                            if c["kernel"] == name),
            bitwise=all(c["bitwise"] for c in trk["cases"]
                        if c["kernel"] == name),
            ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"], dtype=t["dtype"],
            launches_timed=t["launches_timed"])

    from repro_torch.kernels.feature_extract import split_plan as b5_split

    kernels = [
        dict(name="forest_infer", route="cuda",
             source="src/repro_torch/csrc/forest_infer.cu",
             replaces="src/repro/kernels/tree_infer.py:87",
             launches=launches["forest_infer"], max_abs_err=b1_err,
             straddled=0, argmax_mismatches=0,
             ms=timing["forest_infer"]["ms"],
             plain_ms=timing["forest_infer"]["plain_ms"],
             ms_128_flows=timing["forest_infer"]["ms_128"],
             device_ms=timing["forest_infer"]["device_ms"],
             device_ms_128_flows=timing["forest_infer"]["device_ms_128"],
             bound_ms=timing["forest_infer"]["bound_ms"],
             bound_us=timing["forest_infer"]["bound_ms"] * 1e3,
             bound_by=timing["forest_infer"]["bound_by"],
             library_ms=None),
        dict(name="fused_forest_infer", route="cuda",
             source="src/repro_torch/csrc/fused_pipeline.cu",
             replaces="src/repro/kernels/fused_pipeline.py:209",
             launches=launches["fused_forest_infer"],
             max_abs_err=max(b2_err, *(c["max_abs_err"] for c in lw["cases"])),
             straddled=b2_straddled, argmax_mismatches=b2_mism,
             max_col_rel_err=b2_col_err,
             fig5_launches=fig5["launches"]["fused_forest_infer"],
             control_launches=ctl["launches"]["fused_forest_infer"],
             selftune_launches=tune["launches"]["fused_forest_infer"],
             ms=timing["fused_forest_infer"]["ms"],
             plain_ms=timing["fused_forest_infer"]["plain_ms"],
             ms_128_flows=timing["fused_forest_infer"]["ms_128"],
             ms_8_flows=timing["fused_forest_infer"]["ms_8"],
             device_ms=timing["fused_forest_infer"]["device_ms"],
             device_ms_128_flows=timing["fused_forest_infer"]["device_ms_128"],
             device_ms_8_flows=timing["fused_forest_infer"]["device_ms_8"],
             bound_ms=timing["fused_forest_infer"]["bound_ms"],
             bound_us=timing["fused_forest_infer"]["bound_ms"] * 1e3,
             bound_by=timing["fused_forest_infer"]["bound_by"],
             library_ms=None,
             long_window=dict(
                 {k: lw["timing"][k] for k in ("ms", "device_ms", "plain_ms",
                                               "bound_ms", "bound_by",
                                               "library_ms", "shape")},
                 bitwise_depths=[c["depth"] for c in lw["cases"]],
                 profiler_launches=lw["profiler"]["launches"][
                     "fused_forest_infer"])),
        dict(name="fused_agg_infer", route="cuda",
             source="src/repro_torch/csrc/fused_agg.cu",
             replaces="src/repro/kernels/fused_pipeline.py:467",
             launches=arms["on"]["launches"]["fused_agg_infer"],
             max_abs_err=b3_err,
             straddled=b3_straddled, argmax_mismatches=b3_mism,
             cases_columns_not_bitwise=b3_cols_differ,
             ms=timing["fused_agg_infer"]["ms"],
             plain_ms=timing["fused_agg_infer"]["plain_ms"],
             ms_8_flows=timing["fused_agg_infer"]["ms_8"],
             plain_ms_8_flows=timing["fused_agg_infer"]["plain_ms_8"],
             device_ms=timing["fused_agg_infer"]["device_ms"],
             device_ms_8_flows=timing["fused_agg_infer"]["device_ms_8"],
             bound_ms=timing["fused_agg_infer"]["bound_ms"],
             bound_us=timing["fused_agg_infer"]["bound_ms"] * 1e3,
             bound_by=timing["fused_agg_infer"]["bound_by"],
             library_ms=None),
        dict(name="fused_multi_forest_infer", route="cuda",
             source="src/repro_torch/csrc/fused_multi.cu",
             replaces="src/repro/kernels/fused_pipeline.py:383",
             launches=mt["arms"]["shared"]["launches"][
                 "fused_multi_forest_infer"],
             cotune_launches=co["knee"]["launches"]["fused_multi_forest_infer"],
             max_abs_err=max(v["max_abs_err"]
                             for v in (*b4.values(), wm, lw["b4"])),
             straddled=0,
             argmax_mismatches=sum(v["argmax_mismatches"]
                                   for v in (*b4.values(), wm, lw["b4"])),
             ms=b4["wide"]["timing"]["ms"],
             plain_ms=b4["wide"]["timing"]["plain_ms"],
             ms_32_flows=b4["wide"]["timing"]["ms_32"],
             plain_ms_32_flows=b4["wide"]["timing"]["plain_ms_32"],
             device_ms=b4["wide"]["timing"]["device_ms"],
             device_ms_32_flows=b4["wide"]["timing"]["device_ms_32"],
             bound_ms=b4["wide"]["timing"]["bound_ms"],
             bound_us=b4["wide"]["timing"]["bound_ms"] * 1e3,
             bound_by=b4["wide"]["timing"]["bound_by"],
             fleet_ms=b4["fleet"]["timing"]["ms"],
             fleet_plain_ms=b4["fleet"]["timing"]["plain_ms"],
             fleet_ms_32_flows=b4["fleet"]["timing"]["ms_32"],
             fleet_device_ms=b4["fleet"]["timing"]["device_ms"],
             fleet_device_ms_32_flows=b4["fleet"]["timing"]["device_ms_32"],
             fleet_bound_ms=b4["fleet"]["timing"]["bound_ms"],
             library_ms=None,
             wide_merge={k: wm["timing"][k] for k in (
                 "ms", "plain_ms", "ms_32", "device_ms", "device_ms_32",
                 "bound_ms", "bound_by", "shape")},
             long_window_windows=[c["union_window"]
                                  for c in lw["b4"]["cases"]]),
        dict(name="flow_stats", route="cuda",
             source="src/repro_torch/csrc/flow_stats.cu",
             replaces="src/repro/kernels/feature_extract.py:41",
             launches=b5["launches"], max_abs_err=b5["max_abs_err"],
             bitwise=all(c["bitwise"] for c in b5["cases"]),
             ms=b5["timing"]["iot_window"]["ms"],
             device_ms=b5["timing"]["iot_window"]["device_ms"],
             empty_launch_device_ms=b5["timing"]["iot_window"][
                 "empty_launch_device_ms"],
             plain_ms=b5["timing"]["iot_window"]["plain_ms"],
             bound_ms=b5["timing"]["iot_window"]["bound_ms"],
             bound_by=b5["timing"]["iot_window"]["bound_by"],
             library_ms=None,
             torch_ops_ms=b5["timing"]["iot_window"]["torch_ops_ms"],
             shape=b5["timing"]["iot_window"]["shape"],
             split=list(b5_split(b5["timing"]["iot_window"]["shape"][1])),
             stream_trace=dict(
                 {k: b5["timing"]["stream_trace"][k] for k in (
                     "ms", "device_ms", "empty_launch_device_ms",
                     "plain_ms", "bound_ms",
                     "bound_by", "torch_ops_ms", "shape")},
                 split=list(b5_split(
                     b5["timing"]["stream_trace"]["shape"][1])))),
        lm_entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:83", "qwen3-8b",
                 ("zamba2-1.2b", "qwen3-8b-reduced", "whisper-small-encoder",
                  "whisper-small-cross")),
        lm_entry("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention.py:70", "qwen3-8b",
                 ("zamba2-1.2b", "qwen3-8b-reduced", "whisper-small-cross",
                  "phi3-medium-14b-seq")),
        lm_entry("mamba_scan", "src/repro_torch/csrc/mamba_scan.cu",
                 "src/repro/kernels/mamba_scan.py:78", "zamba2-1.2b"),
        train_entry("flash_attention_bwd",
                    "src/repro_torch/csrc/flash_attention_bwd.cu",
                    "src/repro/kernels/flash_attention.py:83",
                    "src/repro/models/layers.py:attention"),
        train_entry("mamba_scan_bwd", "src/repro_torch/csrc/mamba_scan_bwd.cu",
                    "src/repro/kernels/mamba_scan.py:78",
                    "src/repro/models/ssm.py:chunked_ssd"),
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel was not launched")
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


def census_train_cell(train: dict) -> dict:
    """The census record (`repro_torch.launch.dryrun.measure`, on meta
    tensors) of the train phase's cell: TRAIN_ARCH on a (1, 1) mesh of
    torch's fake process group, T TRAIN_T, batch TRAIN_BATCH in TRAIN_MB
    microbatches; its arguments and temporaries beside the phase's
    measured peak."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import measure
    from repro_torch.launch.mesh import census_mesh
    from repro_torch.models.config import ShapeSpec

    t0 = time.perf_counter()
    with census_mesh((1, 1), ("data", "model")) as mesh:
        rec = measure(configs.get(TRAIN_ARCH), ShapeSpec(
            "train", TRAIN_T, TRAIN_BATCH, "train"), mesh, TRAIN_MB)
    mem = rec["memory"]
    return dict(arch=TRAIN_ARCH, memory=mem, flops=rec["flops"],
                collectives=rec["collectives"], kernels=rec["kernels"],
                census_gb=(mem["argument_size_in_bytes"]
                           + mem["temp_size_in_bytes"]) / 1e9,
                measured_peak_gb=train["peak_gb"],
                seconds=time.perf_counter() - t0)


def multicard_only(phases: str = "all") -> None:
    """``python3 chip_smoke.py --multicard-only [--serve-only]``: the
    build, then the multicard phases alone, for a machine with several
    cards: at W = 1 after the train phase they are held to; at W > 1 after
    a one-card run of the train phase's command for 2 steps
    (`one_card_tp_reference`), `multicard_train` on (W, 1), `multicard_tp`
    on the meshes `tp_meshes` picks, then MC_TP_ARCH on (1, W) from four
    cards up; then `multicard_serve` on the meshes `serve_cases` picks
    (with ``--serve-only`` that alone)."""
    from repro_torch.kernels import _build

    check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.build_library()
    _build.load_library()
    emit("build", seconds=time.perf_counter() - t0)
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    W = torch.cuda.device_count()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60).stdout
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    emit("multicard_meshes", world=W, serve=serve_cases(W),
         tp=tp_meshes(W) if W > 1 else [], cards=cards.strip().splitlines(),
         topology=topo.strip().splitlines())
    with tempfile.TemporaryDirectory(dir=build_dir) as d:
        if phases == "serve":
            train = None
        elif W == 1:
            train = train_phase(torch.device("cuda"), d)
        else:
            train = one_card_tp_reference(torch.device("cuda", 0))
            emit("multicard_tp_one_card", **train)
        mc_train, mc_tp, mc_moe, mc_serve, _ = multicard_phase(d, train,
                                                               phases)
    if mc_train is None:
        print(smi, flush=True)
        return
    emit("multicard_train", **mc_train)
    if mc_tp is not None:
        for run in mc_tp["zamba2"]:
            emit("multicard_tp", arch=TRAIN_ARCH, **run)
        if MC_TP_ARCH in mc_tp:
            emit("multicard_tp", arch=MC_TP_ARCH, **mc_tp[MC_TP_ARCH])
        emit("multicard_tp_summary", world=W,
             meshes=[r["mesh"] for r in mc_tp["zamba2"]],
             big=MC_TP_ARCH in mc_tp, seconds=mc_tp["seconds"])
    emit("multicard_moe", **mc_moe)
    print(smi, flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multicard-rank"]:
        multicard_rank(*sys.argv[2:])
    elif sys.argv[1:2] == ["--multicard-only"]:
        multicard_only("serve" if "--serve-only" in sys.argv else "all")
    else:
        main()
