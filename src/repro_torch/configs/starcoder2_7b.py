"""starcoder2-7b: dense, 32L d4608 36H (GQA kv=4) ff18432 vocab 49152.
GQA + RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
        d_ff=18432, vocab_size=49152, head_dim=128,
        act="gelu", rope_theta=1e5,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-reduced", family="dense",
        n_layers=2, d_model=72, n_heads=6, n_kv_heads=2,
        d_ff=144, vocab_size=256, head_dim=12,
        act="gelu", dtype="float32", attn_chunk=0,
    )
