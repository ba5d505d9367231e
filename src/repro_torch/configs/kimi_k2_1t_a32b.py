"""kimi-k2-1t-a32b: MoE, 61L d7168 64H (GQA kv=8) expert-ff 2048
vocab 163840, 384 experts top-8 + 1 shared. Trillion-parameter MoE.
[arXiv:2501.kimi2; unverified]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=0, vocab_size=163840, head_dim=128,
        n_experts=384, experts_per_tok=8, n_shared_experts=1, moe_d_ff=2048,
        act="swiglu", rope_theta=5e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=0, vocab_size=256, head_dim=16,
        n_experts=8, experts_per_tok=2, n_shared_experts=1, moe_d_ff=32,
        act="swiglu", dtype="float32", attn_chunk=0,
    )
