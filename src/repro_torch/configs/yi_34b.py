"""yi-34b: dense llama-arch, 60L d7168 56H (GQA kv=8) ff20480 vocab 64000.
[arXiv:2403.04652; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab_size=64000, head_dim=128,
        act="swiglu", rope_theta=5e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-reduced", family="dense",
        n_layers=3, d_model=56, n_heads=7, n_kv_heads=1,
        d_ff=112, vocab_size=256, head_dim=8,
        act="swiglu", dtype="float32", attn_chunk=0,
    )
