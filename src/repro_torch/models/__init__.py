"""Model zoo of the port: the dense and hybrid families in PyTorch, over the
kernels B6 (prefill attention), B7 (decode attention) and B8 (Mamba scan).

Port of `repro.models`, with the same exports; the other families and
`loss_fn` raise `NotImplementedError` naming their ROADMAP item.
"""
from .config import SHAPES, ModelConfig, ShapeSpec
from .zoo import decode_step, forward, init_cache, init_params, loss_fn

__all__ = [
    "ModelConfig",
    "SHAPES",
    "ShapeSpec",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
]
