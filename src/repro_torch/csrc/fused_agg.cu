// B3: feature columns from the per-flow aggregate row + forest inference,
// one launch per refresh batch.
//
// Replaces the Pallas kernel src/repro/kernels/fused_pipeline.py
// `fused_agg_infer` -> `fused_agg_call` (body `_agg_kernel` + `_traverse`).
// For each flow it reads the flow table's running statistics, an
// AGG_WIDTH (53) float32 row, and its (proto, s_port, d_port) meta, computes
// the columns of an incremental feature plan exactly as
// src/repro/traffic/extraction.py `emit_agg_features` does, and runs the B1
// traversal (forest_common.cuh) on them. The (N, F) feature matrix is never
// written on the serving path.
//
// The plan is the same (F, 4) int32 op table B2 interprets (kind,
// direction, field, stat; repro_torch/kernels/fused_pipeline.py
// `encode_plan`), so one compiled kernel serves every plan and a hot-swap
// never compiles (DESIGN.md §9.3). A median has no incremental form: the
// wrapper refuses a table with one.
//
// Layout: one warp per flow, kFlowsPerBlock (4) flows a block, as B2
// (fused_pipeline.cu), nothing shared between the warps of a block. The
// warp loads its flow's 53 aggregate floats and 3 meta floats into shared
// memory, coalesced; lane c computes op-table rows c, c + 32, c + 64 and
// c + 96 (F <= 128) with the column code below, into a shared x[F] and,
// when it is given, into `columns` (coalesced). Then the warp walks the
// forest with `traverse_forest_warp` (forest_common.cuh: lane t on trees
// t, t + 32, ...; lane k on classes k and k + 32, in tree order) and
// writes the flow's output row coalesced. Each column is one lane's, by
// the same operations as before, and the tree sums keep their block
// order: columns and probabilities are bitwise the one-thread-per-flow
// design's and the plain version's.
//
// Parity with the reference's float32 path, where it is most likely to
// break:
// - the table keeps aggregates in float64; the caller rounds them to
//   float32 on the host, as the reference's `agg.astype(float32)` does;
// - the +-3.4e38 sentinels survive that cast, so TS_MAX - TS_MIN of a flow
//   with no packet is -inf: every masked value is chosen by a select
//   (`c > 0 ? ... : 0.0f`), never by a multiply with a mask;
// - the order of IEEE operations is the reference's:
//   byt * 8.0f / fmaxf(dur, 1e-9f), m2 / fmaxf(c, 1.0f), then
//   sqrtf(fmaxf(var, 0.0f)). nvcc runs with --fmad=false and without
//   --use_fast_math, so no product is contracted and `/` and sqrtf stay
//   correctly rounded;
// - an all-zero padding row has every count at 0 and yields an all-zero
//   feature row.
//
// Bound on the H100. Memory: each flow's 56 floats in, the visited forest
// entries and the (N, K) output. Operations: a handful per column plus the
// traversal, far below the card's float32 rate. In practice a flow's
// latency bounds it: its lanes' columns, then one tree walk per lane, a
// chain of dependent loads as deep as the forest. A refresh batch is 8..256
// flows, so warps per flow put 8..256 warps on the card where one thread
// per flow put 1..8.
#include "forest_common.cuh"

namespace {

constexpr int kMaxFeatures = 128;  // F; the wrapper raises above it
constexpr int kFlowsPerBlock = 4;  // one warp each
constexpr int kAggWidth = 53;      // AGG_WIDTH
constexpr float kHalfBig = 3.4e38f / 2;

// aggregate-row layout (repro_torch/traffic/extraction.py AGG_*)
constexpr int kDirStride = 20;  // direction d's cells start at 20 * d
constexpr int kCnt = 0;
constexpr int kIatCnt = 13, kIatSum = 14, kIatMin = 15, kIatMax = 16,
              kIatM2 = 17;
constexpr int kTsMin = 40, kTsMax = 41;
constexpr int kHsSyn = 42, kHsSynAck = 43, kHsAck = 44;
constexpr int kFlags = 45;

// op table: kind, direction (0 = src, 1 = dst), field, stat
enum Kind { kDur = 0, kMeta = 1, kLoad = 2, kPktCnt = 3, kHandshake = 4,
            kFlagCnt = 5, kStat = 6 };
enum Field { kBytes = 0, kIat = 1, kWinsize = 2, kTtl = 3 };  // kind kStat
enum Shake { kTcpRtt = 0, kSynAck = 1, kAckDat = 2 };         // kHandshake
enum Stat { kSum = 0, kMean = 1, kMin = 2, kMax = 3, kMed = 4, kStd = 5 };

// first cell (the sum) of a window family's SUM/MIN/MAX/M2 run
__device__ __forceinline__ int family_base(int field) {
  return field == kBytes ? 1 : field == kWinsize ? 5 : 9;  // kTtl
}

// a handshake time, 0 where the flag combination was never seen
__device__ __forceinline__ float shake(const float* a, int i) {
  const float v = a[i];
  return v < kHalfBig ? v : 0.0f;
}

__device__ float stat_of(const float* a, int d, int field, int stat) {
  const float* ad = a + kDirStride * d;
  float c, m2;
  int sum_i, min_i, max_i;
  if (field == kIat) {
    c = ad[kIatCnt];
    sum_i = kIatSum, min_i = kIatMin, max_i = kIatMax;
    m2 = ad[kIatM2];
  } else {
    const int fb = family_base(field);
    c = ad[kCnt];
    sum_i = fb, min_i = fb + 1, max_i = fb + 2;
    m2 = ad[fb + 3];
  }
  switch (stat) {
    case kSum:
      return ad[sum_i];
    case kMean:
      return c > 0.0f ? ad[sum_i] / fmaxf(c, 1.0f) : 0.0f;
    case kMin:
      return c > 0.0f ? ad[min_i] : 0.0f;
    case kMax:
      return c > 0.0f ? ad[max_i] : 0.0f;
    default: {  // kStd; kMed never reaches the kernel
      const float var = m2 / fmaxf(c, 1.0f);
      return c > 0.0f ? sqrtf(fmaxf(var, 0.0f)) : 0.0f;
    }
  }
}

// The column of op-table row `op` for the flow's aggregate row `a`, meta
// `m` (proto, s_port, d_port) and duration `dur`.
__device__ float agg_column(const float* a, const float* m, float dur,
                            const int* __restrict__ op) {
  const int kind = __ldg(op);
  const int d = __ldg(op + 1);
  const int field = __ldg(op + 2);
  const int stat = __ldg(op + 3);
  switch (kind) {
    case kDur:
      return dur;
    case kMeta:
      return m[field];  // proto, s_port, d_port
    case kLoad: {
      const float byt = a[kDirStride * d + family_base(kBytes)];
      return dur > 0.0f ? byt * 8.0f / fmaxf(dur, 1e-9f) : 0.0f;
    }
    case kPktCnt:
      return a[kDirStride * d + kCnt];
    case kHandshake: {
      const float t_syn = shake(a, kHsSyn);
      const float t_synack = shake(a, kHsSynAck);
      const float t_ack = shake(a, kHsAck);
      return field == kTcpRtt   ? fmaxf(t_ack - t_syn, 0.0f)
             : field == kSynAck ? fmaxf(t_synack - t_syn, 0.0f)
                                : fmaxf(t_ack - t_synack, 0.0f);
    }
    case kFlagCnt:
      return a[kFlags + field];
    default:  // kStat
      return stat_of(a, d, field, stat);
  }
}

struct FlowShared {  // one warp's shared memory
  float a[kAggWidth];
  float meta[3];
  float x[kMaxFeatures];
  int leaf_idx[32];
};

__global__ void __launch_bounds__(kFlowsPerBlock * 32) fused_agg_infer_kernel(
    const float* __restrict__ agg,        // (N, 53)
    const float* __restrict__ meta,       // (N, 3): proto, s_port, d_port
    const int* __restrict__ op_table,     // (F, 4)
    const int* __restrict__ feature,      // (T, 2^D - 1)
    const float* __restrict__ threshold,  // (T, 2^D - 1)
    const float* __restrict__ leaf,       // (T, 2^D, K)
    float* __restrict__ out,              // (N, K)
    float* __restrict__ columns,          // (N, F) or null
    int N, int F, int forest_depth, int T, int K, int block_t,
    int n_trees_padded, float rescale) {
  __shared__ FlowShared shared[kFlowsPerBlock];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * kFlowsPerBlock + warp;
  if (n >= N) return;   // the whole warp: no barrier spans the block
  FlowShared& sh = shared[warp];
  const float* row = agg + static_cast<size_t>(n) * kAggWidth;
  for (int i = lane; i < kAggWidth; i += 32) sh.a[i] = row[i];
  if (lane < 3) sh.meta[lane] = meta[static_cast<size_t>(n) * 3 + lane];
  __syncwarp();

  const float n_any = sh.a[kCnt] + sh.a[kDirStride + kCnt];
  const float dur = n_any > 0.0f ? sh.a[kTsMax] - sh.a[kTsMin] : 0.0f;
  float* col = columns != nullptr ? columns + static_cast<size_t>(n) * F
                                  : nullptr;
  for (int f = lane; f < F; f += 32) {
    const float v = agg_column(sh.a, sh.meta, dur, op_table + 4 * f);
    sh.x[f] = v;
    if (col != nullptr) col[f] = v;
  }
  __syncwarp();
  cato::traverse_forest_warp(sh.x, feature, threshold, leaf, T, forest_depth,
                             K, block_t, n_trees_padded, rescale,
                             out + static_cast<size_t>(n) * K, sh.leaf_idx,
                             lane);
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise. `columns`
// is null when serving; a check passes an (N, F) buffer to read the
// kernel's own feature columns. Returns cudaGetLastError() after the launch.
extern "C" int fused_agg_infer_launch(
    const float* agg, const float* meta, const int* op_table,
    const int* feature, const float* threshold, const float* leaf,
    float* out, float* columns, int N, int F, int forest_depth, int T, int K,
    int block_t, int n_trees_padded, float rescale, void* stream) {
  const int blocks = (N + kFlowsPerBlock - 1) / kFlowsPerBlock;
  fused_agg_infer_kernel<<<blocks, kFlowsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      agg, meta, op_table, feature, threshold, leaf, out, columns, N, F,
      forest_depth, T, K, block_t, n_trees_padded, rescale);
  return static_cast<int>(cudaGetLastError());
}
