#!/usr/bin/env python3
"""Time the flash-attention kernel (B6) as built with a launch bound of one
block per SM and of two, in one process on one NVIDIA GPU.

    python3 tools/b6_launch_bounds.py [--reps 30]     # from the repo root

Builds ``src/repro_torch/csrc/flash_attention.cu`` twice with nvcc and the
port's flags, with the second argument of its ``__launch_bounds__(kThreads,
N)`` set to 1 (up to 255 registers a thread) and to 2 (at most 128, so that
two blocks of 256 threads fit the register file). Both libraries go under
``build/b6_launch_bounds/`` (git ignores ``build/``). At qwen3-8b's and
zamba2-1.2b's prefill shapes (bf16, causal, inputs from seed 14) both
builds are held bitwise equal to each other and within 2e-2 of the plain
version, then timed in the order 2, 1, 1, 2 blocks, each a median of
CUDA-event-timed launches with the 50 MB L2 overwritten before every one.
Prints ptxas's register and spill lines for each build, one JSON line per
shape, and the card's name and power limit. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import nvidia_smi, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402

BOUND = re.compile(r"__launch_bounds__\(kThreads, \d+\)")
SHAPES = {"qwen3-8b": (2, 32, 8, 2048, 128), "zamba2-1.2b": (2, 32, 32, 2048, 64)}
TOL = 2e-2


def build(min_blocks: int) -> tuple[ctypes.CDLL, list[str]]:
    """Compile the B6 source with `min_blocks` in its launch bound; returns
    the loaded library and ptxas's lines for the kernel."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    if len(BOUND.findall(src)) != 1:
        raise RuntimeError("flash_attention.cu: expected one "
                           "__launch_bounds__(kThreads, N)")
    out = ROOT / "build" / "b6_launch_bounds" / str(min_blocks)
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "flash_attention.cu"
    cu.write_text(BOUND.sub(f"__launch_bounds__(kThreads, {min_blocks})", src))
    lib = out / "libb6.so"
    r = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
         str(cu), "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed ({min_blocks} blocks):\n{r.stdout}")
    so = ctypes.CDLL(str(lib))
    so.flash_attention_launch.argtypes = _build._SIGNATURES["flash_attention_launch"]
    so.flash_attention_launch.restype = ctypes.c_int
    report = [ln.strip() for ln in r.stdout.splitlines()
              if "registers" in ln or "spill" in ln]
    return so, report


def run(so: ctypes.CDLL, q, k, v) -> torch.Tensor:
    B, Hq, T, D = q.shape
    out = torch.empty_like(q)
    err = so.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
        k.shape[1], T, T, D, 1, 1, float(D ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_launch: CUDA error {err}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs, reports = {}, {}
    for n in (1, 2):
        libs[n], reports[n] = build(n)
        print(json.dumps({"build": n, "ptxas": reports[n]}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
    for name, (B, Hq, Hkv, T, D) in SHAPES.items():
        q = torch.randn((B, Hq, T, D), generator=gen, device=dev).bfloat16()
        k = torch.randn((B, Hkv, T, D), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, Hkv, T, D), generator=gen, device=dev).bfloat16()
        outs = {n: run(libs[n], q, k, v) for n in (1, 2)}
        plain = flash_attention_plain(q, k, v)
        err = {n: float((outs[n].float() - plain.float()).abs().max())
               for n in (1, 2)}
        same = bool(torch.equal(outs[1], outs[2]))
        if not same or max(err.values()) > TOL:
            sys.exit(f"{name}: builds differ ({same}) or exceed {TOL}: {err}")
        ms = {1: [], 2: []}
        for n in (2, 1, 1, 2):
            ms[n].append(time_ms(lambda n=n: run(libs[n], q, k, v), args.reps,
                                 flush))
        print(json.dumps({"shape": name, "dims": [B, Hq, Hkv, T, D],
                          "ms_1_block": ms[1], "ms_2_blocks": ms[2],
                          "max_abs_err_vs_plain": err, "builds_bitwise": same,
                          "reps": args.reps}), flush=True)
    print(nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
