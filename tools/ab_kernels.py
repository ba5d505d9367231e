"""Time B5, B6, B7, B6b and B8b, LM serving and zamba2-1.2b's training
step, of several checkouts of the port in one run on a card.

    python3 tools/ab_kernels.py NAME=DIR [NAME=DIR ...] [--out DIR]

Each DIR is the root of a checkout (for example one unpacked with
``git archive``). Each checkout builds its kernels from its own sources
(under its own ``build/``) and is timed in a process of its own, through
its public entry points on the same inputs: the checkouts in the order
given, then in reverse (A B C C B A), so that a drift of the card during
the run shows and cancels in the pooled medians. It prints one JSON line
per process, then a summary line, and writes them to ``--out`` (default
``build/ab_kernels``) with the SASS of B7's full-width kernels.

What is timed (device ms, each run queued behind a spin of the card after
a flush of its L2, the median of REPS runs; the chip_smoke.py method):
- B5 (`flow_stats_kernel_call`) at the main path's two windows: the
  iot-class window of 4000 flows x 128 packets and the stream phase's
  app-class zipf trace of 600 x 4000, with an empty launch (the floor
  under any kernel);
- B7 (`decode_attention_kernel_call`) at the served zamba2-1.2b cache
  (8 x 32 heads, 168 positions, 159 valid, D 64) and at qwen3-8b's
  (8 x 32 / 8 heads, 4096, D 128), bf16;
- B6 (`flash_attention_kernel_call`) at the reduced qwen3-8b's heads and
  head dim 16 (2 x 4 / 2 heads) at the lm_reduced prefill's 40 tokens and
  at 2048, float32 and bf16 (also its ms with the wrapper's host work),
  and the reduced qwen3-8b's prefill end to end (`make_prefill`, 2 x 40
  tokens, host ms to a synchronised result), where the checkout takes
  head dim 16 (an older one raises ValueError: not timed);
- B6b (`flash_attention_bwd_kernel_call`) and B8b
  (`mamba_scan_bwd_kernel_call`) at zamba2-1.2b's training shapes, bf16:
  (2, 32 / 32 heads, T 4096, D 64, causal) and (B 2, T 4096, 64 heads of
  P 64, S 64), through the calls a checkout with the scalar first
  versions takes too; and each kernel a call launches, in device ms, from
  a torch.profiler window of 5 calls (taken last in the process, since a
  profiler window slows every later host-bound step);
- zamba2-1.2b's training step as chip_smoke.py's `train` runs it
  (`repro_torch.launch.train`, full width and depth, bf16, seed 0, T
  4096, global batch 4 in 2 microbatches, 4 steps, no checkpoints): the
  median host ms of steps 1-3 to the loss read back, tokens/s, the losses
  and the peak device memory;
- serving at full width in bf16, seed-0 weights, as chip_smoke.py's
  `lm_serve` times it: qwen3-8b's and zamba2-1.2b's prefill of 2 x 2048
  tokens (host ms to a synchronised result, the median of the 2nd and
  3rd runs), a served batch of 8 (127 prompt tokens teacher-forced, then
  32 greedy steps: ms a step) and the peak device memory in GB.
The SASS of B7's bf16 kernels at D 64 and G 4 (the zamba2 instantiation)
is compared across the checkouts, with the listing's addresses and
encodings removed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPS = 50
QUEUE_CYCLES = 2_000_000
SERVE_ARCHS = ("qwen3-8b", "zamba2-1.2b")
SERVE_B, SERVE_PROMPT, SERVE_GEN, SERVE_CACHE = 8, 128, 32, 168
B5_WINDOWS = {"iot_window": (4000, 128), "stream_trace": (600, 4000)}
B7_CASES = {"zamba2-1.2b": (8, 32, 32, 168, 64, 159),
            "qwen3-8b": (8, 32, 8, 4096, 128, 4096)}
B6_CASES = {"reduced_t40": (2, 4, 2, 40, 16), "reduced_t2048": (2, 4, 2, 2048, 16)}
# zamba2-1.2b's training shapes: B6b (B, heads, T, D), causal, bf16; B8b
# (B, T, H, P, S), bf16; its training step as chip_smoke.py's `train` runs it
TRAIN_B6B = (2, 32, 4096, 64)
TRAIN_B8B = (2, 4096, 64, 64, 64)
TRAIN_ARGV = ["--arch", "zamba2-1.2b", "--steps", "4", "--batch", "4",
              "--seq", "4096", "--microbatches", "2", "--seed", "0",
              "--device", "cuda"]
# the split kernel at bf16, D 64, G 4 (unpadded, where the template has a
# padding flag) and the bf16 merge, as mangled names
B7_SASS = {"split_bf16_d64_g4": r"decode_split_kernelI13__nv_bfloat16Li64ELi4E(Lb0E)?E",
           "merge_bf16": r"decode_merge_kernelI13__nv_bfloat16EE"}


def child(root: Path) -> dict:
    """Time one checkout (run in a process of its own)."""
    sys.path.insert(0, str(root / "src"))
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention_kernel_call
    from repro_torch.kernels.feature_extract import flow_stats_kernel_call
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel_call,
        flash_attention_kernel_call,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd_kernel_call
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.traffic.synth import make_dataset, make_scenario_dataset

    assert Path(_build.__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lib = _build.build_library()
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def device_ms(fn, queued=True):
        for _ in range(3):
            fn()
        times = []
        for _ in range(REPS):
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

    def per_kernel(fn, n=5):
        """{kernel: device ms a call} over a profiled window of n calls
        (the card's activity only)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.self_device_time_total / 1e3 / n
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}

    out = {"root": str(root), "library": str(lib),
           "empty_launch_device_ms": device_ms(lambda: torch.cuda._sleep(0))}
    ds = {"iot_window": make_dataset("iot-class", n_flows=4000, max_pkts=128,
                                     seed=0),
          "stream_trace": make_scenario_dataset("app-class", "zipf",
                                                n_flows=600, max_pkts=4000,
                                                seed=3)}
    for name, d in ds.items():
        valid = np.arange(d.max_pkts)[None, :] < d.flow_len[:, None]
        v = torch.from_numpy(np.ascontiguousarray(d.size, np.float32)).to(dev)
        m = torch.from_numpy(valid).to(dev)
        assert tuple(v.shape) == B5_WINDOWS[name]
        out[f"b5_{name}_device_ms"] = device_ms(
            lambda: flow_stats_kernel_call(v, m))

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for name, (B, Hq, Hkv, S, D, L) in B7_CASES.items():
        q, kc, vc = randn(B, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        lens = torch.full((B,), L, dtype=torch.int32, device=dev)
        out[f"b7_{name}_device_ms"] = device_ms(
            lambda: decode_attention_kernel_call(q, kc, vc, lens))

    for name, (B, Hq, Hkv, T, D) in B6_CASES.items():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (randn(B, H, T, D, dtype=dt) for H in (Hq, Hkv, Hkv))

            def b6():
                return flash_attention_kernel_call(q, k, v, causal=True)

            key = f"b6_{name}_{str(dt)[6:]}"
            try:
                b6()
            except ValueError as e:      # a checkout without small head dims
                out[key] = f"not taken: {e}"
                continue
            out[f"{key}_device_ms"] = device_ms(b6)
            out[f"{key}_ms"] = device_ms(b6, queued=False)

    # B6b and B8b at zamba2-1.2b's training shape (the checkout's own
    # wrappers: a parent with the scalar kernels takes the same calls)
    B, H, T, D = TRAIN_B6B
    q, k, v, do = (randn(B, H, T, D) for _ in range(4))
    o = flash_attention_kernel_call(q, k, v, causal=True)
    b6b = lambda: flash_attention_bwd_kernel_call(q, k, v, o, do, causal=True)  # noqa: E731
    out["b6b_zamba2_train_device_ms"] = device_ms(b6b)
    B, T, H, P, S = TRAIN_B8B
    x = randn(B, T, H, P) * 0.5
    dt = randn(B, T, H, dtype=torch.float32).abs() * 0.1 + 0.01
    A = -randn(H, dtype=torch.float32).abs() - 0.1
    Bm, Cm = randn(B, T, S) * 0.3, randn(B, T, S) * 0.3
    dy = randn(B, T, H, P)
    b8b = lambda: mamba_scan_bwd_kernel_call(x, dt, A, Bm, Cm, dy)  # noqa: E731
    out["b8b_zamba2_train_device_ms"] = device_ms(b8b)
    # the training step, as chip_smoke.py's `train` runs it (no
    # checkpoints): the median of steps 1-3, the losses, the peak memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    report = {}
    with contextlib.redirect_stdout(sys.stderr):
        losses = launch_train.main(TRAIN_ARGV, report=report)
    torch.cuda.synchronize()
    out["train_zamba2_step_ms"] = statistics.median(
        report["step_seconds"][1:]) * 1e3
    out["train_zamba2_tokens_per_s"] = 4 * 4096 / (
        out["train_zamba2_step_ms"] / 1e3)
    out["train_zamba2_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["train_zamba2_losses"] = losses
    del report
    torch.cuda.empty_cache()

    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(configs.get_reduced("qwen3-8b"), dtype=dtype)
        params = init_params(cfg, seed=0)
        toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                             device=dev)
        prefill = make_prefill(cfg)
        key = f"prefill_qwen3-8b-reduced_{dtype}"
        try:
            prefill(params, {"tokens": toks})
        except ValueError as e:
            out[key] = f"not taken: {e}"
            continue
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"{key}_ms"] = statistics.median(times)

    for arch in SERVE_ARCHS:
        cfg = configs.get(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0)
        g = torch.Generator(device=dev).manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (2, 2048), generator=g,
                             device=dev)
        prefill = make_prefill(cfg)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"serve_{arch}_prefill_ms"] = statistics.median(times[1:])
        step = make_serve_step(cfg)
        cache = init_cache(cfg, SERVE_B, SERVE_CACHE)
        prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                               generator=g, device=dev, dtype=torch.int32)
        tok = prompt[:, 0]
        for i in range(1, SERVE_PROMPT):
            _, cache = step(params, cache, tok)
            tok = prompt[:, i]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_GEN):
            tok, cache = step(params, cache, tok)
        torch.cuda.synchronize()
        out[f"serve_{arch}_decode_ms_per_step"] = \
            (time.perf_counter() - t0) * 1e3 / SERVE_GEN
        out[f"serve_{arch}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, cache
    # each kernel B6b and B8b launch, last: a profiler window slows every
    # later host-bound step of the process
    out["b6b_zamba2_train_launches"] = per_kernel(b6b)
    out["b8b_zamba2_train_launches"] = per_kernel(b8b)
    return out


def sass_of(lib: str, pattern: str) -> str:
    """The SASS of the one function of `lib` whose name matches `pattern`,
    addresses and encodings removed."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)[1:]
    hits = [f for f in funcs if re.match(r"\S*" + pattern, f)]
    assert len(hits) == 1, (pattern, len(hits))
    body = hits[0].split("\n", 1)[1]
    lines = []
    for ln in body.splitlines():
        ln = re.sub(r"/\*[0-9a-fx ]*\*/", "", ln).strip()
        if ln and not ln.startswith(".") and ln != ";":
            lines.append(ln)
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=DIR")
    ap.add_argument("--out", default="build/ab_kernels")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child))), flush=True)
        return
    trees = dict(t.split("=", 1) for t in args.trees)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    runs = []
    env = dict(os.environ, PYTHONPATH="")
    for name in [*trees, *reversed(trees)]:
        r = subprocess.run([sys.executable, __file__, "--child",
                            str(Path(trees[name]).resolve())],
                           capture_output=True, text=True, env=env,
                           timeout=900)
        if r.returncode:
            raise SystemExit(f"{name}: rc {r.returncode}\n{r.stderr[-4000:]}")
        res = dict(tree=name, **json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(res), flush=True)
        runs.append(res)
    summary = {"card": smi, "order": [r["tree"] for r in runs], "median": {}}
    for name in trees:
        mine = [r for r in runs if r["tree"] == name]
        summary["median"][name] = {
            k: statistics.median(r[k] for r in mine)
            for k, v in mine[0].items() if isinstance(v, float)}
    libs = {r["tree"]: r["library"] for r in runs}
    sass = {}
    for kernel, pattern in B7_SASS.items():
        texts = {n: sass_of(lib, pattern) for n, lib in libs.items()}
        for n, t in texts.items():
            (out_dir / f"{n}_{kernel}.sass").write_text(t)
        first = next(iter(texts.values()))
        sass[kernel] = dict(instructions={n: t.count("\n") + 1
                                           for n, t in texts.items()},
                             identical=all(t == first for t in texts.values()))
    summary["b7_sass"] = sass
    print(json.dumps(summary), flush=True)
    (out_dir / "ab_kernels.jsonl").write_text(
        "\n".join(json.dumps(r) for r in [*runs, summary]) + "\n")


if __name__ == "__main__":
    main()
