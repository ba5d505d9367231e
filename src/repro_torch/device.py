"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the port
runs on the card unless the caller asks for the CPU, and it never falls
back to the CPU on its own. ``"meta"`` makes tensors with a shape and a
type and no storage (the abstract inputs of `repro_torch.launch.specs`).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device to run on; raises when a CUDA device is asked for
    and none is present (pass ``device="cpu"`` to run the plain version)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch version")
    return dev
