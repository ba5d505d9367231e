// B4: one launch serves every tenant of a multi-tenant fleet: the merged
// plan's feature columns, then each tenant's forest into its own lanes.
//
// Replaces the Pallas kernel src/repro/kernels/fused_pipeline.py
// `fused_multi_forest_infer` -> `fused_multi_forest_call` (body
// `_multi_kernel`, host side `stack_multi_forests`). A fleet of N tenants
// shares one flow table at the union connection depth; each tenant reads a
// subset of one merged feature plan (src/repro/traffic/extraction.py
// `merge_stats_plans`), in which a column is an (op, connection depth) pair
// and ops that several tenants share at one depth are computed once.
//
// The merged plan is an (F, 5) int32 op table: B2's four fields (kind,
// direction, field, stat) and the column's connection depth
// (repro_torch/kernels/fused_pipeline.py `encode_merged_plan`). Each
// column is computed over the first L = min(flow_len, d, P) packets of its
// own depth group d (1 packet for the depth-0 meta group), with the
// duration and handshake times of that window, exactly as the reference
// emits each group over its own window slice. The kernel walks the groups
// in ascending depth: one pass over a group's window for its shared terms,
// then its columns, with the per-thread column code of plan_columns.cuh
// (B2's warp code in plan_warp.cuh computes the same columns).
//
// The forests. Each tenant's forest is padded with pass-through trees to a
// multiple of its own block (min(8, T)), its node feature ids remapped into
// merged-column ids, and stacked on the tree axis; node, leaf and class
// axes are padded to the fleet's maxima (NI, NL, K_max). A small int32
// spec table, made once per pipeline, gives each tenant's (tree offset,
// trees, padded trees, depth, block, classes, lane offset), and a float32
// array its rescale. The traversal is B1's (forest_common.cuh) with the
// stacked strides; the padding trees are skipped, which adds the same +0.0
// their zero leaves would.
//
// Parity by construction: tenant t's lanes are bitwise those of B2 run on
// t's own plan and forest with the packets clipped to its depth: its
// columns are the same IEEE operations in the same order over the same
// window, and its trees are walked in the same order with the same block
// sums, divisor and rescale.
//
// Layout. One thread per flow, kThreads (32) flows per block; each thread
// owns its flow's output row (N, sum K), so there are no atomics. The
// merged columns live in a per-thread array of kMaxMergedColumns floats
// (1 KB, in local memory: two tenants over the 67-feature registry at two
// depths already need 131 columns); a plan of more columns keeps them in
// the flow's row of the (N, F) `columns` buffer, which the wrapper then
// always passes (four tenants over the registry at four depths merge to
// 259). A statistic's samples go to a per-thread buffer when the window
// min(P, largest depth) is at most kMaxWindow, else to the flow's column of
// the wrapper's [W][N] scratch (plan_columns.cuh). Each of the four cases
// is its own instantiation, chosen on the host from the null pointers.
//
// Bound on the H100. Memory: each flow's valid packets up to the union
// depth (25 bytes a packet), 16 bytes of per-flow metadata, the op table
// and the spec, the forest entries each tenant visits, and the (N, sum K)
// output. Operations: a few per packet for each column, plus the
// traversals, far below the card's float32 rate. As for B2, each thread's
// serial walk over its rows and the traversals' chains of dependent loads
// bound it in practice.
#include <climits>

#include "forest_common.cuh"
#include "plan_columns.cuh"

namespace {

// the per-thread column array's size; a wider plan uses `columns`
constexpr int kMaxMergedColumns = 256;
constexpr int kOpFields = 5;            // kind, direction, field, stat, depth
constexpr int kSpecFields = 7;
// spec row fields (repro_torch/convert.py `multi_forest_tables`)
enum Spec { kOffset = 0, kTrees = 1, kTreesPadded = 2, kDepth = 3,
            kBlock = 4, kClasses = 5, kLane = 6 };

template <bool kScratch, bool kWide>
__global__ void __launch_bounds__(cato::kThreads) fused_multi_forest_kernel(
    const float* __restrict__ ts, const float* __restrict__ size,
    const uint8_t* __restrict__ direction, const float* __restrict__ ttl,
    const float* __restrict__ winsize, const uint8_t* __restrict__ flags,
    const int* __restrict__ flow_len, const float* __restrict__ proto,
    const float* __restrict__ s_port, const float* __restrict__ d_port,
    const int* __restrict__ op_table,     // (F, 5)
    const int* __restrict__ spec,         // (n_tenants, 7)
    const float* __restrict__ rescale,    // (n_tenants,)
    const int* __restrict__ feature,      // (sum T_pad, NI)
    const float* __restrict__ threshold,  // (sum T_pad, NI)
    const float* __restrict__ leaf,       // (sum T_pad, NL, K_max)
    float* __restrict__ out,              // (N, k_sum)
    float* __restrict__ columns,          // (N, F), or null unless kWide
    float* __restrict__ scratch,          // (W, N) when kScratch
    int N, int P, int F, int max_depth, int n_tenants, int NI, int NL,
    int K_max, int k_sum) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t base = static_cast<size_t>(n) * P;
  const int fl = flow_len[n];
  const float meta[3] = {proto[n], s_port[n], d_port[n]};
  float local_x[kWide ? 1 : kMaxMergedColumns];
  float* x = kWide ? columns + static_cast<size_t>(n) * F : local_x;
  float local[kScratch ? 1 : cato::kMaxWindow];
  const cato::Samples buf = kScratch ? cato::Samples{scratch + n, N}
                                     : cato::Samples{local, 1};

  // depth groups in ascending order; every thread walks the same table
  for (int prev = -1;;) {
    int d = INT_MAX;
    for (int f = 0; f < F; ++f) {
      const int df = __ldg(op_table + kOpFields * f + 4);
      if (df > prev && df < d) d = df;
    }
    if (d == INT_MAX) break;
    // max_depth (the plan's largest depth, from which the wrapper sizes
    // the window) only guards the buffer against a table that lies
    const int dd = d ? min(min(d, max_depth), P) : 1;
    const cato::Row r{ts + base, size + base, direction + base, ttl + base,
                      winsize + base, flags + base * 8, max(0, min(fl, dd))};
    const cato::WindowTerms w = cato::window_terms(r);
    for (int f = 0; f < F; ++f) {
      const int* op = op_table + kOpFields * f;
      if (__ldg(op + 4) == d) x[f] = cato::column_value(r, w, op, meta, buf);
    }
    prev = d;
  }
  if (!kWide && columns != nullptr)
    for (int f = 0; f < F; ++f) columns[static_cast<size_t>(n) * F + f] = x[f];

  float* row = out + static_cast<size_t>(n) * k_sum;
  for (int t = 0; t < n_tenants; ++t) {
    const int* s = spec + kSpecFields * t;
    const size_t off = static_cast<size_t>(__ldg(s + kOffset));
    cato::traverse_forest_strided(
        x, feature + off * NI, threshold + off * NI,
        leaf + off * NL * K_max, __ldg(s + kTrees), __ldg(s + kDepth),
        __ldg(s + kClasses), __ldg(s + kBlock), __ldg(s + kTreesPadded),
        __ldg(rescale + t), row + __ldg(s + kLane), NI, NL * K_max, K_max);
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise. `columns`
// is null when serving a plan of at most kMaxMergedColumns columns; a
// check passes an (N, F) buffer to read the kernel's own merged columns,
// and a wider plan always has one. `scratch` is null when min(P,
// max_depth) <= kMaxWindow, else a (min(P, max_depth), N) float32 buffer.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a wide plan without `columns`.
extern "C" int fused_multi_forest_launch(
    const float* ts, const float* size, const uint8_t* direction,
    const float* ttl, const float* winsize, const uint8_t* flags,
    const int* flow_len, const float* proto, const float* s_port,
    const float* d_port, const int* op_table, const int* spec,
    const float* rescale, const int* feature, const float* threshold,
    const float* leaf, float* out, float* columns, float* scratch, int N,
    int P, int F, int max_depth, int n_tenants, int NI, int NL, int K_max,
    int k_sum, void* stream) {
  const bool wide = F > kMaxMergedColumns;
  if (wide && columns == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (N + cato::kThreads - 1) / cato::kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = scratch != nullptr
                    ? (wide ? fused_multi_forest_kernel<true, true>
                            : fused_multi_forest_kernel<true, false>)
                    : (wide ? fused_multi_forest_kernel<false, true>
                            : fused_multi_forest_kernel<false, false>);
  kernel<<<blocks, cato::kThreads, 0, s>>>(
      ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port,
      d_port, op_table, spec, rescale, feature, threshold, leaf, out, columns,
      scratch, N, P, F, max_depth, n_tenants, NI, NL, K_max, k_sum);
  return static_cast<int>(cudaGetLastError());
}
