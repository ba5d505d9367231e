"""zamba2-1.2b: hybrid, 38 Mamba2 layers d2048 + shared attention block
(32H kv=32, applied every 6 layers, concat skip), ssm_state=64,
vocab 32000, d_ff 8192 unused by mamba blocks (attn block only).
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000, head_dim=64,
        ssm_state=64, ssm_expand=2, shared_attn_every=6,
        rope_theta=1e4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-reduced", family="hybrid",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=256, head_dim=32,
        ssm_state=16, ssm_expand=2, shared_attn_every=2,
        dtype="float32", attn_chunk=0,
    )
