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
// tree axis is a loop inside the thread that owns a flow. One thread per
// flow, kThreads (32) flows per block: a 4096-flow batch spreads over 128 of
// the 132 SMs. The ragged flow edge is masked here, not padded; padding
// trees are skipped (see forest_common.cuh).
//
// Bound on the H100. Memory: each flow's row of x is read once, the output
// row written once, and the node and leaf entries on the visited paths read
// (mostly from L2, since every flow walks the same tables). Operations are a
// compare and an index update per level and K adds per tree, far below the
// card's float32 rate. In practice the kernel is bound by the latency of the
// depth-long chain of dependent loads per tree, which the warps in flight
// hide only partly at serving batch sizes.
#include "forest_common.cuh"

namespace {

__global__ void __launch_bounds__(cato::kThreads) forest_infer_kernel(
    const float* __restrict__ x,          // (N, F)
    const int* __restrict__ feature,      // (T, 2^D - 1)
    const float* __restrict__ threshold,  // (T, 2^D - 1)
    const float* __restrict__ leaf,       // (T, 2^D, K)
    float* __restrict__ out,              // (N, K)
    int N, int F, int T, int depth, int K, int block_t, int n_trees_padded,
    float rescale) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  cato::traverse_forest(x + static_cast<size_t>(n) * F, feature, threshold,
                        leaf, T, depth, K, block_t, n_trees_padded, rescale,
                        out + static_cast<size_t>(n) * K);
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int forest_infer_launch(
    const float* x, const int* feature, const float* threshold,
    const float* leaf, float* out, int N, int F, int T, int depth, int K,
    int block_t, int n_trees_padded, float rescale, void* stream) {
  const int blocks = (N + cato::kThreads - 1) / cato::kThreads;
  forest_infer_kernel<<<blocks, cato::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, feature, threshold, leaf, out, N, F, T, depth, K, block_t,
      n_trees_padded, rescale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cato_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
