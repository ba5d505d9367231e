"""The published peaks of one NVIDIA H100 SXM (data sheet, dense rates
without sparsity, at its full power limit of 700 W)."""
from __future__ import annotations

__all__ = ["BF16_FLOPS", "F32_FLOPS", "HBM_BYTES", "bound_s", "describe"]

BF16_FLOPS = 989e12    # bf16 on the tensor cores
F32_FLOPS = 67e12      # float32 outside the tensor cores
HBM_BYTES = 3.35e12    # HBM3, bytes a second


def bound_s(flops: float, nbytes: float, flops_per_s: float = BF16_FLOPS):
    """(seconds, "operations" or "bytes"): the least time the chip could
    take, the larger of the two bounds."""
    t_ops, t_bytes = flops / flops_per_s, nbytes / HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def describe() -> str:
    return (f"bf16 {BF16_FLOPS / 1e12:g} TFLOP/s, float32 {F32_FLOPS / 1e12:g}"
            f" TFLOP/s, HBM {HBM_BYTES / 1e12:g} TB/s (H100 SXM, 700 W)")
