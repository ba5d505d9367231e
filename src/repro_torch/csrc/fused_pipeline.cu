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
// per packet). Its F columns live in a per-thread array (kMaxFeatures); the
// samples of one statistic are gathered into a per-thread buffer of
// kMaxWindow floats, where the median sorts them by insertion (O(L^2), L is
// at most the connection depth). Sums run in packet order.
//
// Parity with the reference, where it is most likely to break:
// - directional inter-arrival times use the *exclusive* running max of the
//   same-direction timestamps, with the -3.4e38 sentinel and
//   has_prev = prev > -3.4e38 / 2 (extraction.py `dir_iat`);
// - handshake times take the first matching packet in packet order;
// - the median averages the sorted samples at (c-1)/2 and c/2, 0 when c=0;
// - std is two-pass (mean first), load divides by max(dur, 1e-9);
// - sums run left to right in packet order, as the plain version's
//   `_seq_sum` and the reference's XLA reduction on the CPU (for windows up
//   to 32 packets) add them; std's squares accumulate by an explicit fmaf,
//   as both of those do. nvcc runs with --fmad=false, so no other product
//   is contracted into a multiply-add.
//
// Bound on the H100. Memory: the valid packets of each flow (4 float32
// fields, 1 direction byte, 8 flag bytes: 25 bytes a packet), 16 bytes of
// per-flow metadata, the visited forest entries and the (N, K) output.
// Operations: a few per packet for each plan column, plus the traversal,
// far below the card's float32 rate. In practice each thread's serial walk
// over its rows (uncoalesced across the warp) and the traversal's chain of
// dependent loads bound it.
#include "forest_common.cuh"

namespace {

constexpr int kMaxFeatures = 128;  // F; the wrapper raises above it
constexpr int kMaxWindow = 128;    // min(P, depth); the wrapper raises above
constexpr float kBig = 3.4e38f;

// op table: kind, direction (0 = src, 1 = dst), field, stat
enum Kind { kDur = 0, kMeta = 1, kLoad = 2, kPktCnt = 3, kHandshake = 4,
            kFlagCnt = 5, kStat = 6 };
enum Field { kBytes = 0, kIat = 1, kWinsize = 2, kTtl = 3 };  // kind kStat
enum Meta { kProto = 0, kSPort = 1, kDPort = 2 };             // kind kMeta
enum Shake { kTcpRtt = 0, kSynAck = 1, kAckDat = 2 };         // kHandshake
enum Stat { kSum = 0, kMean = 1, kMin = 2, kMax = 3, kMed = 4, kStd = 5 };
constexpr int kAckFlag = 3;  // FLAG_NAMES: cwr ece urg ack psh rst syn fin
constexpr int kSynFlag = 6;

struct Row {  // one flow's packets
  const float* ts;
  const float* size;
  const uint8_t* dir;
  const float* ttl;
  const float* win;
  const uint8_t* flags;  // 8 per packet
  int L;                 // valid packets
};

// The samples of (direction d, field) in packet order; returns their count.
__device__ int gather(const Row& r, int d, int field, float* buf) {
  int c = 0;
  if (field == kIat) {
    float prev = -kBig;  // exclusive running max of same-direction ts
    for (int i = 0; i < r.L; ++i) {
      if (r.dir[i] != d) continue;
      const float t = r.ts[i];
      if (prev > -kBig / 2) buf[c++] = t - prev;
      prev = fmaxf(prev, t);
    }
    return c;
  }
  const float* v = field == kBytes ? r.size : field == kWinsize ? r.win : r.ttl;
  for (int i = 0; i < r.L; ++i)
    if (r.dir[i] == d) buf[c++] = v[i];
  return c;
}

__device__ float stat_of(float* buf, int c, int stat) {
  if (c == 0) return 0.0f;
  float s = 0.0f;
  for (int i = 0; i < c; ++i) s += buf[i];
  const float fc = static_cast<float>(c);
  switch (stat) {
    case kSum:
      return s;
    case kMean:
      return s / fc;
    case kMin: {
      float m = buf[0];
      for (int i = 1; i < c; ++i) m = fminf(m, buf[i]);
      return m;
    }
    case kMax: {
      float m = buf[0];
      for (int i = 1; i < c; ++i) m = fmaxf(m, buf[i]);
      return m;
    }
    case kMed: {
      for (int i = 1; i < c; ++i) {  // insertion sort, ascending
        const float v = buf[i];
        int j = i - 1;
        while (j >= 0 && buf[j] > v) {
          buf[j + 1] = buf[j];
          --j;
        }
        buf[j + 1] = v;
      }
      return 0.5f * (buf[(c - 1) / 2] + buf[c / 2]);
    }
    default: {  // kStd, two-pass; the squares accumulate by fused
                // multiply-add, as the plain version's `_seq_sum` does
      const float mean = s / fc;
      float q = 0.0f;
      for (int i = 0; i < c; ++i) {
        const float dv = buf[i] - mean;
        q = fmaf(dv, dv, q);
      }
      return sqrtf(q / fc);
    }
  }
}

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
    int N, int P, int F, int depth, int forest_depth, int T, int K,
    int block_t, int n_trees_padded, float rescale) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t base = static_cast<size_t>(n) * P;
  Row r{ts + base, size + base, direction + base, ttl + base, winsize + base,
        flags + base * 8, max(0, min(min(flow_len[n], depth), P))};

  // per-flow terms several ops share: duration and handshake times
  float t_lo = kBig, t_hi = -kBig;
  float t_syn = 0.0f, t_synack = 0.0f, t_ack = 0.0f;
  bool seen_syn = false, seen_synack = false, seen_ack = false;
  for (int i = 0; i < r.L; ++i) {
    const float t = r.ts[i];
    t_lo = fminf(t_lo, t);
    t_hi = fmaxf(t_hi, t);
    const bool syn = r.flags[i * 8 + kSynFlag] > 0;
    const bool ack = r.flags[i * 8 + kAckFlag] > 0;
    if (syn && !ack && !seen_syn) { t_syn = t; seen_syn = true; }
    if (syn && ack && !seen_synack) { t_synack = t; seen_synack = true; }
    if (ack && !syn && !seen_ack) { t_ack = t; seen_ack = true; }
  }
  const float dur = r.L > 0 ? t_hi - t_lo : 0.0f;

  float x[kMaxFeatures];
  float buf[kMaxWindow];
  for (int f = 0; f < F; ++f) {
    const int kind = __ldg(op_table + 4 * f);
    const int d = __ldg(op_table + 4 * f + 1);
    const int field = __ldg(op_table + 4 * f + 2);
    const int stat = __ldg(op_table + 4 * f + 3);
    float v = 0.0f;
    switch (kind) {
      case kDur:
        v = dur;
        break;
      case kMeta:
        v = field == kProto ? proto[n] : field == kSPort ? s_port[n] : d_port[n];
        break;
      case kLoad: {
        float byt = 0.0f;
        for (int i = 0; i < r.L; ++i)
          if (r.dir[i] == d) byt += r.size[i];
        v = dur > 0.0f ? byt * 8.0f / fmaxf(dur, 1e-9f) : 0.0f;
        break;
      }
      case kPktCnt: {
        int c = 0;
        for (int i = 0; i < r.L; ++i) c += r.dir[i] == d;
        v = static_cast<float>(c);
        break;
      }
      case kHandshake:
        v = field == kTcpRtt   ? fmaxf(t_ack - t_syn, 0.0f)
            : field == kSynAck ? fmaxf(t_synack - t_syn, 0.0f)
                               : fmaxf(t_ack - t_synack, 0.0f);
        break;
      case kFlagCnt:
        for (int i = 0; i < r.L; ++i) v += static_cast<float>(r.flags[i * 8 + field]);
        break;
      default:  // kStat
        v = stat_of(buf, gather(r, d, field, buf), stat);
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
extern "C" int fused_forest_infer_launch(
    const float* ts, const float* size, const uint8_t* direction,
    const float* ttl, const float* winsize, const uint8_t* flags,
    const int* flow_len, const float* proto, const float* s_port,
    const float* d_port, const int* op_table, const int* feature,
    const float* threshold, const float* leaf, float* out, float* columns,
    int N, int P, int F, int depth, int forest_depth, int T, int K,
    int block_t, int n_trees_padded, float rescale, void* stream) {
  const int blocks = (N + cato::kThreads - 1) / cato::kThreads;
  fused_forest_infer_kernel<<<blocks, cato::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      ts, size, direction, ttl, winsize, flags, flow_len, proto, s_port,
      d_port, op_table, feature, threshold, leaf, out, columns, N, P, F,
      depth, forest_depth, T, K, block_t, n_trees_padded, rescale);
  return static_cast<int>(cudaGetLastError());
}
