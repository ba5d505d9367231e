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
// Layout. One thread per flow, kThreads (32) flows per block; rows past N
// are masked. A thread reads its flow's 53 + 3 floats and keeps its F
// columns in a per-thread array (kMaxFeatures).
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
// traversal, far below the card's float32 rate. In practice the
// traversal's chain of dependent loads bounds it, as for B1: a refresh
// batch is 8..256 flows, a few warps on a card of 132 SMs.
#include "forest_common.cuh"

namespace {

constexpr int kMaxFeatures = 128;  // F; the wrapper raises above it
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

__global__ void __launch_bounds__(cato::kThreads) fused_agg_infer_kernel(
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
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float a[kAggWidth];
  for (int i = 0; i < kAggWidth; ++i)
    a[i] = agg[static_cast<size_t>(n) * kAggWidth + i];
  const float* m = meta + static_cast<size_t>(n) * 3;

  const float n_any = a[kCnt] + a[kDirStride + kCnt];
  const float dur = n_any > 0.0f ? a[kTsMax] - a[kTsMin] : 0.0f;

  float x[kMaxFeatures];
  for (int f = 0; f < F; ++f) {
    const int kind = __ldg(op_table + 4 * f);
    const int d = __ldg(op_table + 4 * f + 1);
    const int field = __ldg(op_table + 4 * f + 2);
    const int stat = __ldg(op_table + 4 * f + 3);
    float v;
    switch (kind) {
      case kDur:
        v = dur;
        break;
      case kMeta:
        v = m[field];  // proto, s_port, d_port
        break;
      case kLoad: {
        const float byt = a[kDirStride * d + family_base(kBytes)];
        v = dur > 0.0f ? byt * 8.0f / fmaxf(dur, 1e-9f) : 0.0f;
        break;
      }
      case kPktCnt:
        v = a[kDirStride * d + kCnt];
        break;
      case kHandshake: {
        const float t_syn = shake(a, kHsSyn);
        const float t_synack = shake(a, kHsSynAck);
        const float t_ack = shake(a, kHsAck);
        v = field == kTcpRtt   ? fmaxf(t_ack - t_syn, 0.0f)
            : field == kSynAck ? fmaxf(t_synack - t_syn, 0.0f)
                               : fmaxf(t_ack - t_synack, 0.0f);
        break;
      }
      case kFlagCnt:
        v = a[kFlags + field];
        break;
      default:  // kStat
        v = stat_of(a, d, field, stat);
        break;
    }
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
// kernel's own feature columns. Returns cudaGetLastError() after the launch.
extern "C" int fused_agg_infer_launch(
    const float* agg, const float* meta, const int* op_table,
    const int* feature, const float* threshold, const float* leaf,
    float* out, float* columns, int N, int F, int forest_depth, int T, int K,
    int block_t, int n_trees_padded, float rescale, void* stream) {
  const int blocks = (N + cato::kThreads - 1) / cato::kThreads;
  fused_agg_infer_kernel<<<blocks, cato::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      agg, meta, op_table, feature, threshold, leaf, out, columns, N, F,
      forest_depth, T, K, block_t, n_trees_padded, rescale);
  return static_cast<int>(cudaGetLastError());
}
