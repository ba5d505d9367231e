"""whisper-small: enc-dec audio, 12L(+12 enc) d768 12H ff3072 vocab 51865.
Conv frontend is a STUB: input_specs() provides precomputed frame
embeddings. [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        n_layers=12, encoder_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=51865,
        act="gelu", rope_theta=1e4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-reduced", family="audio",
        n_layers=2, encoder_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        act="gelu", dtype="float32", attn_chunk=0,
    )
