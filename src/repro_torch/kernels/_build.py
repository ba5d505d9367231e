"""Build the port's CUDA kernels with nvcc at first use, load and launch them.

The sources in ``src/repro_torch/csrc/`` are compiled for Hopper
(``sm_90a``) into one shared library with a plain C interface, which
`ctypes` loads: no PyTorch headers are compiled, so a build takes seconds.
Each ``.cu`` file is compiled by its own nvcc process, all started
together, and then linked. The library goes under ``build/kernels/<key>/``
at the root of the checkout (git ignores it), keyed by a hash of the
sources and flags, so a checkout builds once and a changed source rebuilds.

Importing this module builds nothing; `load_library` does, on the first
launch. A missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_ROOT", "NVCC_FLAGS", "build_library", "check_tensor",
           "launch", "load_library"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("forest_infer.cu", "fused_pipeline.cu", "fused_agg.cu",
           "fused_multi.cu", "flash_attention.cu", "decode_attention.cu",
           "mamba_scan.cu", "flow_stats.cu", "flash_attention_bwd.cu",
           "mamba_scan_bwd.cu")
HEADERS = ("forest_common.cuh", "plan_warp.cuh", "lm_common.cuh",
           "tma_wgmma.cuh")
# --fmad=false: no multiply and add is contracted into one rounding, so
# the forest kernels round as their plain versions do (the one fused
# multiply-add they use, std's, is an explicit fmaf that the plain version
# mirrors); the LM kernels' dot products are explicit fmaf chains
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")
LIB_NAME = "libcato_kernels.so"

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# argument types of each C entry point, in order (see the .cu files)
_SIGNATURES = {
    "forest_infer_launch": (
        [_VOID] * 5 + [_INT] * 7 + [_FLOAT, _VOID]),
    "fused_forest_infer_launch": (
        [_VOID] * 17 + [_INT] * 9 + [_FLOAT, _VOID]),
    "fused_agg_infer_launch": (
        [_VOID] * 8 + [_INT] * 7 + [_FLOAT, _VOID]),
    "fused_multi_forest_launch": (
        [_VOID] * 19 + [_INT] * 9 + [_VOID]),
    "flash_attention_launch": (
        [_VOID] * 4 + [_INT] * 8 + [_FLOAT, _VOID]),
    "decode_attention_launch": (
        [_VOID] * 7 + [_INT] * 8 + [_FLOAT, _VOID]),
    "mamba_scan_launch": (
        [_VOID] * 12 + [_INT] * 7 + [_VOID]),
    "mamba_scan_states_launch": (
        [_VOID] * 11 + [_INT] * 7 + [_VOID]),
    "flow_stats_launch": (
        [_VOID] * 3 + [_INT] * 4 + [_VOID]),
    "flash_attention_bwd_launch": (
        [_VOID] * 9 + [_INT] * 8 + [_FLOAT, _VOID]),
    "mamba_scan_bwd_launch": (
        [_VOID] * 20 + [_INT] * 7 + [_VOID]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the kernels unless this checkout already holds the library
    for the current sources; returns its path. Writes nvcc's output,
    including ptxas's register and spill report, to ``build.log`` beside
    the library."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    # objects go to a directory of this process's own, so that processes
    # building the same sources at once never write into each other's files
    work = out_dir / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = work / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== nvcc {src} (rc {p.returncode})\n{out}")
        if p.returncode:
            failed.append(src)
    if not failed:
        tmp = work / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode:
            failed.append("link")
        else:
            (out_dir / "build.log").write_text("\n".join(log))
            os.replace(tmp, lib)
            shutil.rmtree(work)
    if failed:
        (work / "build.log").write_text("\n".join(log))
        raise RuntimeError(
            f"building the CUDA kernels failed ({', '.join(failed)}):\n"
            + "\n".join(log))
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load the library once per process and declare the
    argument types of its entry points."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cato_error_string.argtypes = [_INT]
    lib.cato_error_string.restype = ctypes.c_char_p
    return lib


def launch(entry: str, device: torch.device, *args) -> None:
    """Call a C entry point with `args` on `device`'s current stream; raise
    if the launch reports an error. Does not synchronise.

    The tensors behind the pointers may be freed once this returns: the
    caching allocator gives their memory only to work queued after the
    launch on the same stream, which is where the wrappers allocate."""
    lib = load_library()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(
            f"{entry}: CUDA error {err} "
            f"({lib.cato_error_string(err).decode()})")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` and `shape` on
    `device` (a CUDA device). Checked before any pointer reaches a kernel."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: on {t.device}, expected {device} (CUDA)")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
