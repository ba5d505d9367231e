// Dense level-order forest traversal by one warp per flow, shared by
// forest_infer.cu (B1), fused_pipeline.cu (B2), fused_agg.cu (B3) and
// fused_multi.cu (B4): the counterpart of `_traverse` in
// src/repro/kernels/fused_pipeline.py and of `_tree_kernel` in
// src/repro/kernels/tree_infer.py.
//
// Order of the arithmetic, kept from the reference so that the kernels are
// bitwise their plain versions:
//   for each block of `block_t` trees, in tree order:
//     votes = sum over the block's trees of the leaf payload reached
//     acc  += votes / n_trees_padded
//   out = acc * rescale        (rescale = (T + rem) / T, or 1)
// The reference pads the tree axis with pass-through trees whose leaves are
// zero; here the padding trees are skipped, which adds the same +0.0.
// No atomics: each warp owns its flow's output row, so the result does not
// depend on the order in which blocks run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cato {

constexpr int kMaxClasses = 64;   // K; the wrappers raise above it

// Lane t walks trees t, t + 32, ... on the flow's values `xs` (shared or
// global memory) and puts its leaf in `leaf_idx` (32 ints of shared
// memory); then lane k adds the payloads of classes k and k + 32 tree by
// tree, in tree order, block by block as above, and writes them (coalesced
// across the lanes). The node tables and the leaf table stay in global
// memory and are read through the read-only cache: at T=25, D=10, K=28 the
// leaves alone are 2.9 MB, far above the 227 KB of shared memory a block
// may use and far below the 50 MB of L2.
//
// Strides: tree t's internal nodes start at t * node_stride in `feature`
// and `threshold`; its leaf j's K payloads start at
// t * leaf_tree_stride + j * class_stride in `leaf`. A forest on its own
// (B1, B2, B3) is dense: `traverse_forest_warp` below, whose strides
// kDense writes as expressions of depth and K (passed as values, they cost
// B3 25 registers and a spill). B4's tenant-stacked tables pad every
// tenant to the fleet's widest node, leaf and class axes:
// `traverse_forest_warp_strided`.
template <bool kDense>
__device__ __forceinline__ void traverse_forest_warp_impl(
    const float* xs,
    const int* __restrict__ feature,
    const float* __restrict__ threshold,
    const float* __restrict__ leaf,
    int T, int depth, int K, int block_t, int n_trees_padded, float rescale,
    float* __restrict__ out_row, int* leaf_idx, int lane,
    int node_stride, int leaf_tree_stride, int class_stride) {
  const int n_internal = (1 << depth) - 1;
  const float n_pad = static_cast<float>(n_trees_padded);
  const int k0 = lane, k1 = lane + 32;
  float acc0 = 0.0f, acc1 = 0.0f, votes0 = 0.0f, votes1 = 0.0f;
  int in_block = 0;   // the next tree's place in its block of block_t
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    if (t < T) {
      const int stride = kDense ? n_internal : node_stride;
      const int* ft = feature + static_cast<size_t>(t) * stride;
      const float* tt = threshold + static_cast<size_t>(t) * stride;
      int node = 0;
      for (int d = 0; d < depth; ++d) {
        const int f = __ldg(ft + node);
        const float th = __ldg(tt + node);
        node = 2 * node + 1 + (xs[f] > th ? 1 : 0);
      }
      leaf_idx[lane] = node - n_internal;
    }
    __syncwarp();
    const int t1 = min(t0 + 32, T);
    for (int u0 = t0; u0 < t1; u0 += 8) {
      // 8 trees' payloads loaded at once, then added one by one in order
      float v0[8], v1[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int u = u0 + e;
        v0[e] = v1[e] = 0.0f;
        if (u < t1) {
          const float* lt =
              kDense ? leaf + static_cast<size_t>(u) * (n_internal + 1) * K +
                           static_cast<size_t>(leaf_idx[u - t0]) * K
                     : leaf + static_cast<size_t>(u) * leaf_tree_stride +
                           static_cast<size_t>(leaf_idx[u - t0]) * class_stride;
          if (k0 < K) v0[e] = __ldg(lt + k0);
          if (k1 < K) v1[e] = __ldg(lt + k1);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int u = u0 + e;
        if (u >= t1) break;
        if (in_block == 0) {
          votes0 = 0.0f;
          votes1 = 0.0f;
        }
        votes0 += v0[e];
        votes1 += v1[e];
        if (++in_block == block_t || u + 1 == T) {
          acc0 += votes0 / n_pad;
          acc1 += votes1 / n_pad;
          in_block = 0;
        }
      }
    }
    __syncwarp();   // leaf_idx is refilled for the next 32 trees
  }
  if (k0 < K) out_row[k0] = acc0 * rescale;
  if (k1 < K) out_row[k1] = acc1 * rescale;
}

// One dense forest: feature/threshold (T, 2^D - 1), leaf (T, 2^D, K).
__device__ __forceinline__ void traverse_forest_warp(
    const float* xs,
    const int* __restrict__ feature,
    const float* __restrict__ threshold,
    const float* __restrict__ leaf,
    int T, int depth, int K, int block_t, int n_trees_padded, float rescale,
    float* __restrict__ out_row, int* leaf_idx, int lane) {
  traverse_forest_warp_impl<true>(xs, feature, threshold, leaf, T, depth, K,
                                  block_t, n_trees_padded, rescale, out_row,
                                  leaf_idx, lane, 0, 0, 0);
}

// One tenant of B4's stacked tables, with the strides above.
__device__ __forceinline__ void traverse_forest_warp_strided(
    const float* xs,
    const int* __restrict__ feature,
    const float* __restrict__ threshold,
    const float* __restrict__ leaf,
    int T, int depth, int K, int block_t, int n_trees_padded, float rescale,
    float* __restrict__ out_row, int* leaf_idx, int lane,
    int node_stride, int leaf_tree_stride, int class_stride) {
  traverse_forest_warp_impl<false>(xs, feature, threshold, leaf, T, depth, K,
                                   block_t, n_trees_padded, rescale, out_row,
                                   leaf_idx, lane, node_stride,
                                   leaf_tree_stride, class_stride);
}

}  // namespace cato
