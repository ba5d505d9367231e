"""Model zoo of the port: every family (dense, moe, vlm, audio, ssm and
hybrid) in PyTorch, over the kernels B6 (prefill attention, causal or not,
cross attention), B7 (decode attention, self and cross) and B8 (Mamba
scan).

Port of `repro.models`, with the same exports; `loss_fn` is the training
objective, differentiated through B6b and B8b (`repro_torch.train`).
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
