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
// (repro_torch/kernels/fused_pipeline.py `encode_merged_plan`), in
// first-seen order, not sorted by depth. Each column is computed over the
// first L = min(flow_len, d, P) packets of its own depth group d (1 packet
// for the depth-0 meta group), with the duration and handshake times of
// that window, exactly as the reference emits each group over its own
// window slice.
//
// Layout: one warp per flow, kFlowsPerBlock (4) flows a block, as B1, B2 and
// B3 (8 measured on the H100 up to 3% faster at 4096 flows and up to 4%
// slower at a micro-batch's 32; PERF.md), nothing shared between the warps
// of a block. The warp walks the depth groups in ascending order: it finds
// the next depth by a warp min over the table's depth field, compacts the
// rows of that depth (ballot and popcount, in table order) into a shared
// list of up to kChunk rows, and computes them with B2's `warp_columns`
// (plan_warp.cuh: the group's window staged in shared memory, lane c on the
// list's rows c, c + 32, ...; medians by the whole warp), which writes each
// column to its merged position; a group of more than kChunk rows goes slice
// by slice. The merged columns live in a per-warp x[F] of dynamic shared
// memory; a plan of more than kMaxMergedColumns columns keeps them in the
// flow's row of the (N, F) `columns` buffer, which the wrapper then always
// passes. A median's samples above kChunk packets go to the flow's
// contiguous row of the wrapper's (N, W) scratch, as B2's. Then the warp
// walks each tenant's forest with `traverse_forest_warp_strided`
// (forest_common.cuh: lane t on trees t, t + 32, ...; lane k on classes k
// and k + 32, in tree order, block by block) and writes the tenant's lanes
// of the flow's output row coalesced.
//
// The forests. Each tenant's forest is padded with pass-through trees to a
// multiple of its own block (min(8, T)), its node feature ids remapped into
// merged-column ids, and stacked on the tree axis; node, leaf and class
// axes are padded to the fleet's maxima (NI, NL, K_max). A small int32
// spec table, made once per pipeline, gives each tenant's (tree offset,
// trees, padded trees, depth, block, classes, lane offset), read once per
// warp, and a float32 array its rescale. The padding trees are skipped,
// which adds the same +0.0 their zero leaves would.
//
// Parity by construction: tenant t's lanes are bitwise those of B2 run on
// t's own plan and forest with the packets clipped to its depth: its
// columns are the same IEEE operations in the same order over the same
// window (the same `warp_columns`; a column's arithmetic does not depend on
// the other columns of its call), and its trees are walked in the same
// order with the same block sums, divisor and rescale.
//
// Bound on the H100. Memory: each flow's valid packets up to the union
// depth (25 bytes a packet), 16 bytes of per-flow metadata, the op table
// and the spec, the forest entries each tenant visits, and the (N, sum K)
// output. Operations: a few per packet for each column, plus the
// traversals, far below the card's float32 rate. What bounds it in
// practice is each warp's serial walk over each depth group's window (once
// per pass, and once per median) and the traversals' chains of dependent
// loads; a warp per flow puts up to 32 flows in flight on each SM where
// one thread per flow put one warp, and a micro-batch of 32 flows 32 warps
// on the card where it put one.
#include <climits>

#include "forest_common.cuh"
#include "plan_warp.cuh"

namespace {

constexpr int kFlowsPerBlock = 4;       // one warp each
// x[F] in shared memory up to this many merged columns; above, `columns`.
// The largest power of two at which two blocks still share an SM.
constexpr int kMaxMergedColumns = 4096;
constexpr int kOpFields = 5;            // kind, direction, field, stat, depth
constexpr int kSpecFields = 7;
// spec row fields (repro_torch/convert.py `multi_forest_tables`)
enum Spec { kOffset = 0, kTrees = 1, kTreesPadded = 2, kDepth = 3,
            kBlock = 4, kClasses = 5, kLane = 6 };

struct WarpShared {  // one warp's shared memory, before the block's x[F]s
  cato::WarpWindow win;
  int rows[cato::kChunk];   // a slice of one depth group's op-table rows
  int leaf_idx[32];
};
constexpr int kSmLimit = 233472;       // 228 KB, an SM's shared memory
constexpr size_t kBlockBytes =
    kFlowsPerBlock * (sizeof(WarpShared) + sizeof(float) * kMaxMergedColumns);
static_assert(2 * (kBlockBytes + 1024) <= kSmLimit &&
                  2 * (kBlockBytes + kFlowsPerBlock * sizeof(float) *
                                         kMaxMergedColumns + 1024) > kSmLimit,
              "kMaxMergedColumns: the most, a power of two, at which two "
              "blocks share an SM (1 KB of each block is the system's)");

template <bool kWide>
__global__ void __launch_bounds__(kFlowsPerBlock * 32)
fused_multi_forest_kernel(
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
    float* __restrict__ scratch,          // (N, W) when W > kChunk, or null
    int N, int P, int F, int max_depth, int n_tenants, int NI, int NL,
    int K_max, int k_sum) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * kFlowsPerBlock + warp;
  if (n >= N) return;   // the whole warp: no barrier spans the block
  WarpShared& sh = reinterpret_cast<WarpShared*>(smem)[warp];
  float* const xs = reinterpret_cast<float*>(smem + kFlowsPerBlock *
                                                        sizeof(WarpShared));
  float* x = kWide ? columns + static_cast<size_t>(n) * F
                   : xs + static_cast<size_t>(warp) * F;
  float* col_out = !kWide && columns != nullptr
                       ? columns + static_cast<size_t>(n) * F
                       : nullptr;
  const size_t base = static_cast<size_t>(n) * P;
  const int fl = flow_len[n];
  const float pr = proto[n], sp = s_port[n], dp = d_port[n];
  // max_depth, the plan's largest depth, sizes the scratch's rows; it also
  // guards them against a table that lies
  float* samples_g = scratch != nullptr
                         ? scratch + static_cast<size_t>(n) * min(P, max_depth)
                         : nullptr;
  const unsigned lt_mask = (1u << lane) - 1u;

  // depth groups in ascending order; every warp walks the same table
  for (int prev = -1;;) {
    int d = INT_MAX;
    for (int f = lane; f < F; f += 32) {
      const int df = __ldg(op_table + kOpFields * f + 4);
      if (df > prev && df < d) d = df;
    }
    d = __reduce_min_sync(cato::kFullMask, d);
    if (d == INT_MAX) break;
    const int dd = d ? min(min(d, max_depth), P) : 1;
    const cato::Row r{ts + base, size + base, direction + base, ttl + base,
                      winsize + base, flags + base * 8, max(0, min(fl, dd))};
    // the group's rows in table order, up to kChunk a call
    for (int next = 0; next < F;) {
      int m = 0;
      while (next < F && m < cato::kChunk) {
        const int f = next + lane;
        const bool in = f < F && __ldg(op_table + kOpFields * f + 4) == d;
        const unsigned b = __ballot_sync(cato::kFullMask, in);
        const int rank = __popc(b & lt_mask), room = cato::kChunk - m;
        if (in && rank < room) sh.rows[m + rank] = f;
        if (__popc(b) > room) {   // the list fills inside these 32 rows
          const unsigned kept =
              __ballot_sync(cato::kFullMask, in && rank < room);
          next += 32 - __clz(kept);
          m = cato::kChunk;
        } else {
          next += 32;
          m += __popc(b);
        }
      }
      if (m == 0) break;
      __syncwarp();
      cato::warp_columns<kOpFields, true>(r, op_table, sh.rows, m, pr, sp, dp,
                                          sh.win, samples_g, x, col_out, lane);
      __syncwarp();   // rows is refilled for the next slice
    }
    prev = d;
  }
  __syncwarp();   // x is complete before any lane walks a tree

  float* row = out + static_cast<size_t>(n) * k_sum;
  for (int t = 0; t < n_tenants; ++t) {
    // the tenant's spec row, read once by the warp
    const int mine = lane < kSpecFields ? __ldg(spec + kSpecFields * t + lane)
                                        : 0;
    const int off = __shfl_sync(cato::kFullMask, mine, kOffset);
    const int trees = __shfl_sync(cato::kFullMask, mine, kTrees);
    const int padded = __shfl_sync(cato::kFullMask, mine, kTreesPadded);
    const int depth = __shfl_sync(cato::kFullMask, mine, kDepth);
    const int block = __shfl_sync(cato::kFullMask, mine, kBlock);
    const int K = __shfl_sync(cato::kFullMask, mine, kClasses);
    const int lane_off = __shfl_sync(cato::kFullMask, mine, kLane);
    const size_t o = static_cast<size_t>(off);
    cato::traverse_forest_warp_strided(
        x, feature + o * NI, threshold + o * NI, leaf + o * NL * K_max, trees,
        depth, K, block, padded, __ldg(rescale + t), row + lane_off,
        sh.leaf_idx, lane, NI, NL * K_max, K_max);
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise, reads
// nothing back. `columns` is null when serving a plan of at most
// kMaxMergedColumns columns; a check passes an (N, F) buffer to read the
// kernel's own merged columns, and a wider plan always has one. `scratch`
// is null when min(P, max_depth) <= 128, else an (N, min(P, max_depth))
// float32 buffer. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a wide plan without `columns`.
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
  auto kernel = wide ? fused_multi_forest_kernel<true>
                     : fused_multi_forest_kernel<false>;
  const size_t bytes =
      kFlowsPerBlock * (sizeof(WarpShared) + (wide ? 0 : sizeof(float) * F));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (N + kFlowsPerBlock - 1) / kFlowsPerBlock;
  kernel<<<blocks, kFlowsPerBlock * 32, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port,
      d_port, op_table, spec, rescale, feature, threshold, leaf, out, columns,
      scratch, N, P, F, max_depth, n_tenants, NI, NL, K_max, k_sum);
  return static_cast<int>(cudaGetLastError());
}
