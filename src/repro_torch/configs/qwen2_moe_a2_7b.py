"""qwen2-moe-a2.7b: MoE, 24L d2048 16H (GQA kv=16) expert-ff 1408
vocab 151936, 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=0, vocab_size=151936, head_dim=128,
        n_experts=60, experts_per_tok=4, n_shared_experts=4, moe_d_ff=1408,
        n_expert_slots=64,  # padded so EP divides 16- and 32-wide meshes
        act="swiglu", rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=256, head_dim=16,
        n_experts=6, experts_per_tok=2, n_shared_experts=2, moe_d_ff=32,
        act="swiglu", dtype="float32", attn_chunk=0,
    )
