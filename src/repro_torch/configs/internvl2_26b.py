"""internvl2-26b: VLM, LM backbone 48L d6144 48H (GQA kv=8) ff16384
vocab 92553. InternViT frontend is a STUB: input_specs() provides patch
embeddings. [arXiv:2404.16821; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=92553, head_dim=128,
        act="swiglu", rope_theta=5e6, num_patches=1024,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-reduced", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        act="swiglu", dtype="float32", num_patches=16, attn_chunk=0,
    )
