// B1: dense level-order random-forest inference over a feature matrix.
//
// Replaces the Pallas kernel src/repro/kernels/tree_infer.py
// `forest_infer_kernel_call` (body `_tree_kernel`), reached through
// src/repro/kernels/ops.py `forest_infer`. It computes, for each flow n,
//   node <- 2*node + 1 + (x[n, feature[t, node]] > threshold[t, node])
// over `depth` levels of every tree t, and the mean over trees of the leaf
// payload reached, accumulated per block of `block_t` trees in the order of
// forest_common.cuh.
//
// Layout. The TPU grid walks tree blocks in order and accumulates into an
// output tile that stays resident; Hopper runs blocks in no order, so the
// tree axis is a loop inside the warp that owns a flow. One warp per flow,
// kFlowsPerBlock (4) flows a block, nothing shared between the warps of a
// block, as B2 and B3: the warp walks the forest with
// `traverse_forest_warp` (lane t on trees t, t + 32, ...; lane k on classes
// k and k + 32, in tree order, block by block), reading its flow's row of x
// from device memory, and writes the flow's output row coalesced. (A
// copy of the row into shared memory first was measured on the H100 and
// was no faster; PERF.md.) The tree sums keep their block order, so the
// output is bitwise the plain version's. The ragged flow edge is masked
// here, not padded; padding trees are skipped (see forest_common.cuh).
//
// Bound on the H100. Memory: each flow's row of x is read once, the output
// row written once, and the node and leaf entries on the visited paths read
// (mostly from L2, since every flow walks the same tables). Operations are a
// compare and an index update per level and K adds per tree, far below the
// card's float32 rate. What bounds it in practice are the node loads:
// each level of each tree is a dependent load of 8 useful bytes from a
// 32-byte L2 sector, scattered across the trees (at T=25, D=10 about 16 KB
// of L2 traffic a flow). One thread per flow put one warp on each SM for a
// 4096-flow batch and walked every tree of a flow in series, so those
// loads' latency bound it; a warp per flow walks 32 of a flow's trees at
// once and puts 32 warps on each SM, which hides the latency and leaves
// the L2 traffic.
#include "forest_common.cuh"

namespace {

constexpr int kFlowsPerBlock = 4;  // one warp each

__global__ void __launch_bounds__(kFlowsPerBlock * 32) forest_infer_kernel(
    const float* __restrict__ x,          // (N, F)
    const int* __restrict__ feature,      // (T, 2^D - 1)
    const float* __restrict__ threshold,  // (T, 2^D - 1)
    const float* __restrict__ leaf,       // (T, 2^D, K)
    float* __restrict__ out,              // (N, K)
    int N, int F, int T, int depth, int K, int block_t, int n_trees_padded,
    float rescale) {
  __shared__ int leaf_idx[kFlowsPerBlock][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * kFlowsPerBlock + warp;
  if (n >= N) return;   // the whole warp: no barrier spans the block
  cato::traverse_forest_warp(x + static_cast<size_t>(n) * F, feature,
                             threshold, leaf, T, depth, K, block_t,
                             n_trees_padded, rescale,
                             out + static_cast<size_t>(n) * K,
                             leaf_idx[warp], lane);
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int forest_infer_launch(
    const float* x, const int* feature, const float* threshold,
    const float* leaf, float* out, int N, int F, int T, int depth, int K,
    int block_t, int n_trees_padded, float rescale, void* stream) {
  const int blocks = (N + kFlowsPerBlock - 1) / kFlowsPerBlock;
  forest_infer_kernel<<<blocks, kFlowsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, feature, threshold, leaf, out, N, F, T, depth, K, block_t,
      n_trees_padded, rescale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cato_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
