"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version:

  tree_infer      dense level-order random-forest inference (B1,
                  csrc/forest_infer.cu)
  fused_pipeline  one-launch feature extraction + forest inference (B2,
                  csrc/fused_pipeline.cu), its aggregate entry for the
                  reuse path's refresh batches (B3, csrc/fused_agg.cu), and
                  its multi-tenant entry, a merged plan and every tenant's
                  forest in one launch (B4, csrc/fused_multi.cu)
  feature_extract masked per-flow count / sum / sum of squares / min / max
                  (B5, csrc/flow_stats.cu)
  flash_attention GQA prefill attention with an online softmax (B6,
                  csrc/flash_attention.cu)
  decode_attention
                  one-token GQA attention against a KV cache (B7,
                  csrc/decode_attention.cu)
  mamba_scan      the chunked Mamba-2 / SSD scan, y and the final state
                  (B8, csrc/mamba_scan.cu)

`ops.py` holds the entry points that dispatch CUDA tensors to a kernel and
CPU tensors to its plain version; `ref.py` the oracles and the straddle
rule; `_build.py` compiles the sources with nvcc at first launch.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
