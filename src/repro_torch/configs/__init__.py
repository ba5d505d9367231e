"""Architecture registry: one module per assigned architecture.

`get(name)` returns the full published config; `get_reduced(name)` the
smoke-test scale-down of the same family (small layers/width, few experts,
tiny vocab) used by per-arch CPU tests.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "qwen3_8b",
    "starcoder2_7b",
    "phi3_medium_14b",
    "yi_34b",
    "kimi_k2_1t_a32b",
    "qwen2_moe_a2_7b",
    "xlstm_350m",
    "whisper_small",
    "internvl2_26b",
    "zamba2_1_2b",
)

# canonical ids (as given in the assignment) -> module names
ALIASES = {
    "qwen3-8b": "qwen3_8b",
    "starcoder2-7b": "starcoder2_7b",
    "phi3-medium-14b": "phi3_medium_14b",
    "yi-34b": "yi_34b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "xlstm-350m": "xlstm_350m",
    "whisper-small": "whisper_small",
    "internvl2-26b": "internvl2_26b",
    "zamba2-1.2b": "zamba2_1_2b",
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str) -> ModelConfig:
    return _module(name).config()


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def all_arch_ids() -> tuple[str, ...]:
    return tuple(ALIASES.keys())
