// B2: fused feature extraction + forest inference, one launch per batch.
//
// Replaces the Pallas kernel src/repro/kernels/fused_pipeline.py
// `fused_forest_infer` -> `fused_pipeline_call` (body `_fused_kernel` +
// `_traverse`). For each flow it computes the columns of a feature plan
// (src/repro/traffic/extraction.py `emit_feature_columns`) from the flow's
// packets and runs the B1 traversal (forest_common.cuh) on them. The (N, F)
// feature matrix is never written on the serving path.
//
// The plan. The JAX kernel is specialised per static plan by jit. Compiling
// one kernel per plan would put nvcc on the serving path and break the
// hot-swap contract (DESIGN.md §9.3), so the plan is encoded once per
// pipeline as an int32 op table (F rows of kind, direction, field, stat;
// repro_torch/kernels/fused_pipeline.py `encode_plan`) and this one kernel
// interprets it. Every thread reads the same row at the same time, so the
// branch on the op is uniform across the warp.
//
// Layout. One thread per flow, kThreads (32) flows per block. A thread
// reads the first L = min(flow_len, depth, P) packets of its own rows:
// ts, size, ttl, winsize (float32), direction and flags (uint8, 8 flags
// per packet). Its F columns live in a per-thread array (kMaxFeatures).
// A statistic's samples go to a per-thread buffer when the window
// W = min(P, depth) is at most kMaxWindow, else to the thread's column of
// the wrapper's [W][N] scratch: one kernel instantiation each, chosen by
// whether the scratch pointer is null. The column code, and the parity
// notes that go with it, are in plan_columns.cuh, which B4
// (fused_multi.cu) shares.
//
// Bound on the H100. Memory: the valid packets of each flow (4 float32
// fields, 1 direction byte, 8 flag bytes: 25 bytes a packet), 16 bytes of
// per-flow metadata, the visited forest entries and the (N, K) output.
// Operations: a few per packet for each plan column, plus the traversal,
// far below the card's float32 rate. In practice each thread's serial walk
// over its rows (uncoalesced across the warp) and the traversal's chain of
// dependent loads bound it.
#include "forest_common.cuh"
#include "plan_columns.cuh"

namespace {

constexpr int kMaxFeatures = 128;  // F; the wrapper raises above it

template <bool kScratch>
__global__ void __launch_bounds__(cato::kThreads) fused_forest_infer_kernel(
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
    float* __restrict__ scratch,          // (W, N) when kScratch
    int N, int P, int F, int depth, int forest_depth, int T, int K,
    int block_t, int n_trees_padded, float rescale) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t base = static_cast<size_t>(n) * P;
  cato::Row r{ts + base, size + base, direction + base, ttl + base,
              winsize + base, flags + base * 8,
              max(0, min(min(flow_len[n], depth), P))};

  const cato::WindowTerms w = cato::window_terms(r);
  const float meta[3] = {proto[n], s_port[n], d_port[n]};
  float x[kMaxFeatures];
  float local[kScratch ? 1 : cato::kMaxWindow];
  const cato::Samples buf = kScratch ? cato::Samples{scratch + n, N}
                                     : cato::Samples{local, 1};
  for (int f = 0; f < F; ++f) {
    const float v = cato::column_value(r, w, op_table + 4 * f, meta, buf);
    x[f] = v;
    if (columns != nullptr) columns[static_cast<size_t>(n) * F + f] = v;
  }
  cato::traverse_forest(x, feature, threshold, leaf, T, forest_depth, K,
                        block_t, n_trees_padded, rescale,
                        out + static_cast<size_t>(n) * K);
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise. `columns`
// is null when serving; a check passes an (N, F) buffer to read the
// kernel's own feature columns. `scratch` is null when min(P, depth) <=
// kMaxWindow, else a (min(P, depth), N) float32 buffer. Returns
// cudaGetLastError() after the launch.
extern "C" int fused_forest_infer_launch(
    const float* ts, const float* size, const uint8_t* direction,
    const float* ttl, const float* winsize, const uint8_t* flags,
    const int* flow_len, const float* proto, const float* s_port,
    const float* d_port, const int* op_table, const int* feature,
    const float* threshold, const float* leaf, float* out, float* columns,
    float* scratch, int N, int P, int F, int depth, int forest_depth, int T,
    int K, int block_t, int n_trees_padded, float rescale, void* stream) {
  const int blocks = (N + cato::kThreads - 1) / cato::kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = scratch != nullptr ? fused_forest_infer_kernel<true>
                                   : fused_forest_infer_kernel<false>;
  kernel<<<blocks, cato::kThreads, 0, s>>>(
      ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port,
      d_port, op_table, feature, threshold, leaf, out, columns, scratch, N, P,
      F, depth, forest_depth, T, K, block_t, n_trees_padded, rescale);
  return static_cast<int>(cudaGetLastError());
}
