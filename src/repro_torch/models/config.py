"""Model configuration schema covering all 10 assigned architectures.

A copy of `repro.models.config` (which the port may not import).

One frozen dataclass describes every family (dense / moe / ssm / audio /
vlm / hybrid); `repro_torch/configs/<arch>.py` instantiates the exact
published dimensions plus a `reduced()` variant for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "count_params"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | audio | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    act: str = "swiglu"         # swiglu | gelu
    rope_theta: float = 1e6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim (d_ff column in table)
    capacity_factor: float = 1.25
    n_expert_slots: int = 0     # weight-storage slots (>= n_experts, padded
                                # so expert parallelism divides the mesh;
                                # slots beyond n_experts are never routed to)

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    shared_attn_every: int = 0  # zamba2: shared attention block period
    slstm_every: int = 0        # xlstm: sLSTM block period (else mLSTM)

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    # vlm
    num_patches: int = 1024     # stub ViT patch count per image

    # numerics / serving
    dtype: str = "bfloat16"
    max_seq: int = 524_288
    attn_chunk: int = 2048      # q-chunked attention block (XLA path)
    remat: str = "block"        # none | block | dots
    n_heads_padded: int = 0     # pad query heads to this count (0 = off) so
                                # head counts that don't divide the model
                                # axis (36, 40) still shard instead of
                                # replicating attention; padded heads have
                                # zeroed output rows
    residual: str = "tp"        # residual-stream layout: "tp" shards d_model
                                # over the model axis (lower memory, extra
                                # norm collectives); "replicated" keeps the
                                # residual full (classic Megatron: collectives
                                # only after row-parallel projections)
    ssd_chunk: int = 128        # SSD chunk length (mamba2 / mLSTM)
    # probe mode: unroll every scan so compiled.cost_analysis() counts true
    # FLOPs/bytes/collectives (used by the dry-run's per-layer cost probes;
    # the real artifact keeps scans rolled)
    probe: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def heads_eff(self) -> int:
        return max(self.n_heads_padded, self.n_heads)

    @property
    def expert_slots(self) -> int:
        return self.n_expert_slots or self.n_experts

    @property
    def active_params(self) -> int:
        """Approximate active parameter count (MoE counts top-k experts)."""
        return count_params(self, active_only=True)

    @property
    def total_params(self) -> int:
        return count_params(self, active_only=False)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    d, hd = cfg.d_model, cfg.hd
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) + (cfg.n_heads * hd) * d
    if cfg.family == "moe":
        e = cfg.experts_per_tok if active_only else cfg.n_experts
        ffn = (e + cfg.n_shared_experts) * 3 * d * cfg.moe_d_ff
        router = d * cfg.n_experts
        block = attn + ffn + router + 2 * d
    elif cfg.family in ("ssm",):
        di = cfg.ssm_expand * d
        # mLSTM-ish block: in/out proj + qkv + gates
        block = 2 * d * di + 3 * di * di // 4 + 2 * d
    elif cfg.family == "hybrid":
        di = cfg.ssm_expand * d
        block = 2 * d * di + di * (2 * cfg.ssm_state) + 2 * d
    else:
        mult = 3 if cfg.act == "swiglu" else 2
        ffn = mult * d * cfg.d_ff
        block = attn + ffn + 2 * d
    layers = cfg.n_layers + cfg.encoder_layers
    return emb + layers * block + d


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
