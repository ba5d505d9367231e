"""xlstm-350m: sLSTM + mLSTM blocks, 24L d1024 4H, vocab 50304, no FFN.
[arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        slstm_every=2,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-reduced", family="ssm",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab_size=256,
        slstm_every=2, dtype="float32",
    )
