"""Time full-width LM decode before and after the training kernels, in one
process on a card.

    python3 tools/serve_after_train.py [--arch qwen3-8b] [--out DIR]

It serves a batch of 8 as chip_smoke.py's `lm_serve` phase does (bf16,
seed-0 weights, full width; 127 prompt tokens teacher-forced, then 32
greedy steps), three times after each of these stages, in this order:

1. ``fresh``: the model, its prefill of 2 x 2048 tokens, nothing else;
2. ``kernels``: B6b and B8b, 10 launches each, at zamba2-1.2b's training
   shapes (chip_smoke.py's ``TRAIN_B6B_CASES``/``TRAIN_B8B_CASES`` first
   rows);
3. ``plain``: their plain versions once each at the same shapes (B8b's
   runs hundreds of thousands of small ops);
4. ``library``: autograd's backward of `scaled_dot_product_attention` at
   B6b's shape, 10 times (the first backward of a CUDA graph starts
   autograd's device thread);
5. ``train_kernels``: chip_smoke.py's whole `train_kernel_phase`, as its
   runs that put that phase before `lm_serve` did;
6. ``released``: `gc.collect()` and `torch.cuda.empty_cache()`;
7. ``profiled``: one `torch.profiler` window (chip_smoke.py's
   `device_profile`, host and card activity) over the prefill, as
   `chip_smoke.py` traces before `lm_serve` and between its models;
8. ``objects``: OBJECTS small tuples kept alive, which the collector
   then walks in every full collection.

Each serve records the host ms a step of the 32 greedy steps to a
synchronised result, the host ms a step spent issuing them (before the
synchronisation: where this equals the former, the host sets the pace),
the prompt's ms a step, the caching allocator's state (reserved bytes,
segments, cudaMalloc and cudaFree calls and allocation retries since the
stage began), the process's thread count, the Python objects the
collector tracks, and the card's SM clock, power and temperature. One JSON
line per serve goes to stdout and to ``DIR/serve_after_train.jsonl``
(default ``build/serve_after_train``), then a summary line of the greedy
ms a step by stage.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SERVE_B, SERVE_PROMPT, SERVE_GEN, SERVE_CACHE = 8, 128, 32, 168
SERVES_PER_STAGE = 3
OBJECTS = 5_000_000
ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_state() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    sm, power, temp = (v.strip() for v in out.stdout.strip().split(","))
    return dict(sm_mhz=float(sm), power_w=float(power), temp_c=float(temp))


def threads() -> int:
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("Threads:"):
            return int(line.split()[1])
    return -1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--out", default=str(ROOT / "build" / "serve_after_train"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    cs = load_chip_smoke()
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel_call,
        flash_attention_bwd_plain,
        flash_attention_kernel_call,
    )
    from repro_torch.kernels.mamba_scan import (
        mamba_scan_bwd_kernel_call,
        mamba_scan_bwd_plain,
    )
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve import make_prefill, make_serve_step

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    sink = (out_dir / "serve_after_train.jsonl").open("w")
    dev = torch.device("cuda")
    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(name.strip(), flush=True)

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        sink.write(line + "\n")

    cfg = configs.get(args.arch)
    params = init_params(cfg, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen,
                         device=dev)
    prefill = make_prefill(cfg)
    prefill(params, {"tokens": toks})
    step = make_serve_step(cfg)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)

    def serve() -> dict:
        cache = init_cache(cfg, SERVE_B, SERVE_CACHE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = prompt[:, 0]
        for i in range(1, SERVE_PROMPT):
            _, cache = step(params, cache, tok)
            tok = prompt[:, i]
        torch.cuda.synchronize()
        prompt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(SERVE_GEN):
            tok, cache = step(params, cache, tok)
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        return dict(prompt_ms_per_step=prompt_s * 1e3 / (SERVE_PROMPT - 1),
                    decode_ms_per_step=gen_s * 1e3 / SERVE_GEN,
                    issue_ms_per_step=issue_s * 1e3 / SERVE_GEN)

    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    b6b_name, (B, Hq, Hkv, Tq, Tk, D), b6b_dtype, causal = \
        cs.TRAIN_B6B_CASES[0]
    b8b_name, (Bs, T, H, P, S), b8b_dtype, _ = cs.TRAIN_B8B_CASES[0]
    g2 = torch.Generator(device=dev).manual_seed(15)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g2, device=dev) * scale).to(dtype)

    q = randn((B, Hq, Tq, D), b6b_dtype)
    k, v = randn((B, Hkv, Tk, D), b6b_dtype), randn((B, Hkv, Tk, D), b6b_dtype)
    o = flash_attention_kernel_call(q, k, v, causal=causal)
    do = randn((B, Hq, Tq, D), b6b_dtype)
    x = randn((Bs, T, H, P), b8b_dtype, 0.5)
    dt = randn((Bs, T, H), scale=0.1).abs() + 0.01
    A = -randn((H,)).abs() - 0.1
    Bm, Cm = randn((Bs, T, S), b8b_dtype, 0.3), randn((Bs, T, S), b8b_dtype, 0.3)
    dy = randn((Bs, T, H, P), b8b_dtype)
    b8b_args = (x, dt, A, Bm, Cm, dy, None)

    def kernels():
        for _ in range(10):
            flash_attention_bwd_kernel_call(q, k, v, o, do, causal=causal)
            mamba_scan_bwd_kernel_call(*b8b_args)

    def plain():
        flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
        mamba_scan_bwd_plain(*b8b_args)

    def library():
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        for _ in range(10):
            torch.autograd.grad(lib_out, (qs, ks, vs), do, retain_graph=True)

    def released():
        gc.collect()
        torch.cuda.empty_cache()

    held = []

    def objects():
        held.extend((i, float(i)) for i in range(OBJECTS))

    stages = (("fresh", lambda: None), ("kernels", kernels), ("plain", plain),
              ("library", library),
              ("train_kernels", lambda: cs.train_kernel_phase(dev, flush)),
              ("released", released),
              ("profiled", lambda: cs.device_profile(
                  lambda: prefill(params, {"tokens": toks}), 1)),
              ("objects", objects))
    by_stage = {}
    for stage, fn in stages:
        before = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        for i in range(SERVES_PER_STAGE):
            rec = serve()
            stats = torch.cuda.memory_stats()
            rec.update(
                stage=stage, serve=i, stage_s=stage_s,
                reserved_gb=stats.get("reserved_bytes.all.current", 0) / 1e9,
                segments=stats.get("segment.all.current", 0),
                **{k: stats.get(k, 0) - before.get(k, 0) for k in ALLOC_KEYS},
                threads=threads(), gc_objects=len(gc.get_objects()),
                **card_state())
            emit(**rec)
            by_stage.setdefault(stage, []).append(rec["decode_ms_per_step"])
    emit(summary={s: statistics.median(v) for s, v in by_stage.items()},
         arch=args.arch, card=name.strip())


if __name__ == "__main__":
    main()
