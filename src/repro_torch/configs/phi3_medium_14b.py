"""phi3-medium-14b: dense, 40L d5120 40H (GQA kv=10) ff17920 vocab 100352.
RoPE + SwiGLU + GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
        d_ff=17920, vocab_size=100352, head_dim=128,
        act="swiglu", rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b-reduced", family="dense",
        n_layers=2, d_model=80, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab_size=256, head_dim=20,
        act="swiglu", dtype="float32", attn_chunk=0,
    )
