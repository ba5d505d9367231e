// B2: fused feature extraction + forest inference, one launch per batch.
//
// Replaces the Pallas kernel src/repro/kernels/fused_pipeline.py
// `fused_forest_infer` -> `fused_pipeline_call` (body `_fused_kernel` +
// `_traverse`). For each flow it computes the columns of a feature plan
// (src/repro/traffic/extraction.py `emit_feature_columns`) from the flow's
// packets and runs the forest traversal (forest_common.cuh) on them. The (N, F)
// feature matrix is never written on the serving path.
//
// The plan. The JAX kernel is specialised per static plan by jit. Compiling
// one kernel per plan would put nvcc on the serving path and break the
// hot-swap contract (DESIGN.md §9.3), so the plan is encoded once per
// pipeline as an int32 op table (F rows of kind, direction, field, stat;
// repro_torch/kernels/fused_pipeline.py `encode_plan`) and this one kernel
// interprets it. Each lane of a warp holds other rows; per packet the
// column code selects by op instead of branching, so the lanes stay in
// step.
//
// Layout: one warp per flow, kFlowsPerBlock (4) flows a block, nothing
// shared between the warps of a block. The warp computes its flow's F
// columns with plan_warp.cuh (the window staged in shared memory with
// coalesced loads, lane c on op-table rows c, c + 32, ...; medians by the
// whole warp), keeps them in a shared-memory x[F], then walks the forest
// with `traverse_forest_warp` (forest_common.cuh: lane t on tree t, t + 32,
// ...; lane k on classes k and k + 32, in tree order) and writes the
// flow's output row coalesced. Sums keep packet order and std its fmaf,
// the tree sums their block order: columns and probabilities are bitwise
// the plain version's, and B4's lanes of a tenant with the same plan and
// forest are bitwise these. A window W = min(P, depth) above 128 packets
// is staged 128 at a time, and a median's samples go to the flow's row of
// the wrapper's (N, W) scratch (contiguous per flow, so the warp's
// accesses coalesce).
//
// Bound on the H100. Memory: the valid packets of each flow (4 float32
// fields, 1 direction byte, 8 flag bytes: 25 bytes a packet), 16 bytes of
// per-flow metadata, the visited forest entries and the (N, K) output.
// Operations: a few per packet for each plan column, plus the traversal,
// far below the card's float32 rate. What bounds it in practice is each
// warp's serial walk over its window (once per pass, and once per median)
// and the traversal's chain of dependent loads; 4096 flows put 31 warps on
// each SM to hide that latency, where one thread per flow put one.
#include "forest_common.cuh"
#include "plan_warp.cuh"

namespace {

constexpr int kMaxFeatures = 128;  // F; the wrapper raises above it
constexpr int kFlowsPerBlock = 4;  // one warp each

struct FlowShared {  // one warp's shared memory
  cato::WarpWindow win;
  float x[kMaxFeatures];
  int leaf_idx[32];
};

__global__ void __launch_bounds__(kFlowsPerBlock * 32) fused_forest_infer_kernel(
    const float* __restrict__ ts, const float* __restrict__ size,
    const uint8_t* __restrict__ direction, const float* __restrict__ ttl,
    const float* __restrict__ winsize, const uint8_t* __restrict__ flags,
    const int* __restrict__ flow_len, const float* __restrict__ proto,
    const float* __restrict__ s_port, const float* __restrict__ d_port,
    const int* __restrict__ op_table,     // (F, 4)
    const int* __restrict__ feature,      // (T, 2^D - 1)
    const float* __restrict__ threshold,  // (T, 2^D - 1)
    const float* __restrict__ leaf,       // (T, 2^D, K)
    float* __restrict__ out,              // (N, K)
    float* __restrict__ columns,          // (N, F) or null
    float* __restrict__ scratch,          // (N, W) when W > kChunk, or null
    int N, int P, int F, int depth, int forest_depth, int T, int K,
    int block_t, int n_trees_padded, float rescale) {
  __shared__ FlowShared shared[kFlowsPerBlock];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * kFlowsPerBlock + warp;
  if (n >= N) return;   // the whole warp: no barrier spans the block
  FlowShared& sh = shared[warp];
  const size_t base = static_cast<size_t>(n) * P;
  const int window = min(P, depth);
  const cato::Row r{ts + base, size + base, direction + base, ttl + base,
                    winsize + base, flags + base * 8,
                    max(0, min(min(flow_len[n], depth), P))};
  cato::warp_columns(
      r, op_table, nullptr, F, proto[n], s_port[n], d_port[n], sh.win,
      scratch != nullptr ? scratch + static_cast<size_t>(n) * window : nullptr,
      sh.x, columns != nullptr ? columns + static_cast<size_t>(n) * F : nullptr,
      lane);
  __syncwarp();
  cato::traverse_forest_warp(sh.x, feature, threshold, leaf, T, forest_depth,
                             K, block_t, n_trees_padded, rescale,
                             out + static_cast<size_t>(n) * K, sh.leaf_idx,
                             lane);
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise. `columns`
// is null when serving; a check passes an (N, F) buffer to read the
// kernel's own feature columns. `scratch` is null when min(P, depth) <=
// 128, else an (N, min(P, depth)) float32 buffer. Returns
// cudaGetLastError() after the launch.
extern "C" int fused_forest_infer_launch(
    const float* ts, const float* size, const uint8_t* direction,
    const float* ttl, const float* winsize, const uint8_t* flags,
    const int* flow_len, const float* proto, const float* s_port,
    const float* d_port, const int* op_table, const int* feature,
    const float* threshold, const float* leaf, float* out, float* columns,
    float* scratch, int N, int P, int F, int depth, int forest_depth, int T,
    int K, int block_t, int n_trees_padded, float rescale, void* stream) {
  const int blocks = (N + kFlowsPerBlock - 1) / kFlowsPerBlock;
  fused_forest_infer_kernel<<<blocks, kFlowsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port,
      d_port, op_table, feature, threshold, leaf, out, columns, scratch, N, P,
      F, depth, forest_depth, T, K, block_t, n_trees_padded, rescale);
  return static_cast<int>(cudaGetLastError());
}
