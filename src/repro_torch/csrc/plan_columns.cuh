// Feature columns of a stats plan over one flow's packet window, for one
// flow per thread, used by fused_multi.cu (B4): the counterpart of
// src/repro/traffic/extraction.py `emit_feature_columns`. Its op codes and
// `Row` are also plan_warp.cuh's, whose warp per flow (B2) computes the
// same columns to the last bit.
//
// A plan is an int32 op table, one row per column (kind, direction, field,
// stat; repro_torch/kernels/fused_pipeline.py `encode_plan`), which the
// kernels interpret: one compiled kernel serves every plan. Every thread
// reads the same row at the same time, so the branch on the op is uniform
// across the warp.
//
// A thread reads the first L = min(flow_len, depth, P) packets of its own
// rows. The samples of one statistic are gathered into a buffer (`Samples`):
// a per-thread array of kMaxWindow floats when the window W = min(P, depth)
// fits it, else the thread's column of a [W][N] scratch in device memory
// that the wrapper allocates (sample i of flow n at i * N + n, so that a
// warp's accesses coalesce). Both go through the same code. The median
// selects its two ranks with a heap sort in place (O(L log L)); any exact
// selection gives the same two samples, so the same bits. Sums run in
// packet order.
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
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cato {

// the per-thread sample buffer's size; a larger window uses the scratch
constexpr int kMaxWindow = 128;
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

// One flow's sample buffer: a per-thread array (stride 1) or the flow's
// column of the [W][N] scratch (stride N).
struct Samples {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int i) const {
    return p[static_cast<size_t>(i) * stride];
  }
};

// Terms several ops of one window share: duration and handshake times.
struct WindowTerms {
  float dur;
  float t_syn, t_synack, t_ack;
};

// The samples of (direction d, field) in packet order; returns their count.
__device__ inline int gather(const Row& r, int d, int field,
                              const Samples& buf) {
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

// Restore the max-heap a[root..end) below `root`.
__device__ inline void sift_down(const Samples& a, int root, int end) {
  const float v = a[root];
  int i = root;
  for (;;) {
    int child = 2 * i + 1;
    if (child >= end) break;
    float cv = a[child];
    if (child + 1 < end) {
      const float rv = a[child + 1];
      if (rv > cv) {
        ++child;
        cv = rv;
      }
    }
    if (!(cv > v)) break;
    a[i] = cv;
    i = child;
  }
  a[i] = v;
}

// The median of a[0..c), c >= 1, by heap sort in place until ranks
// (c-1)/2 and c/2 are known: a[lo + 1..c) then holds the largest samples in
// order and a[0], the top of the heap of the rest, is the sample of rank lo.
__device__ inline float median_of(const Samples& a, int c) {
  const int lo = (c - 1) / 2;
  for (int i = c / 2 - 1; i >= 0; --i) sift_down(a, i, c);
  for (int end = c - 1; end > lo; --end) {
    const float top = a[0];
    a[0] = a[end];
    a[end] = top;
    sift_down(a, 0, end);
  }
  return 0.5f * (a[0] + (c / 2 == lo ? a[0] : a[lo + 1]));
}

__device__ inline float stat_of(const Samples& buf, int c, int stat) {
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
    case kMed:
      return median_of(buf, c);
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

// One pass over the window for the terms its ops share.
__device__ inline WindowTerms window_terms(const Row& r) {
  float t_lo = kBig, t_hi = -kBig;
  WindowTerms w{0.0f, 0.0f, 0.0f, 0.0f};
  bool seen_syn = false, seen_synack = false, seen_ack = false;
  for (int i = 0; i < r.L; ++i) {
    const float t = r.ts[i];
    t_lo = fminf(t_lo, t);
    t_hi = fmaxf(t_hi, t);
    const bool syn = r.flags[i * 8 + kSynFlag] > 0;
    const bool ack = r.flags[i * 8 + kAckFlag] > 0;
    if (syn && !ack && !seen_syn) { w.t_syn = t; seen_syn = true; }
    if (syn && ack && !seen_synack) { w.t_synack = t; seen_synack = true; }
    if (ack && !syn && !seen_ack) { w.t_ack = t; seen_ack = true; }
  }
  w.dur = r.L > 0 ? t_hi - t_lo : 0.0f;
  return w;
}

// The column of op-table row `op` (kind, direction, field, stat) for the
// window `r`; `meta` holds the flow's proto, s_port and d_port.
__device__ inline float column_value(const Row& r, const WindowTerms& w,
                                     const int* __restrict__ op,
                                     const float meta[3],
                                     const Samples& buf) {
  const int kind = __ldg(op);
  const int d = __ldg(op + 1);
  const int field = __ldg(op + 2);
  const int stat = __ldg(op + 3);
  float v = 0.0f;
  switch (kind) {
    case kDur:
      v = w.dur;
      break;
    case kMeta:
      v = meta[field];
      break;
    case kLoad: {
      float byt = 0.0f;
      for (int i = 0; i < r.L; ++i)
        if (r.dir[i] == d) byt += r.size[i];
      v = w.dur > 0.0f ? byt * 8.0f / fmaxf(w.dur, 1e-9f) : 0.0f;
      break;
    }
    case kPktCnt: {
      int c = 0;
      for (int i = 0; i < r.L; ++i) c += r.dir[i] == d;
      v = static_cast<float>(c);
      break;
    }
    case kHandshake:
      v = field == kTcpRtt   ? fmaxf(w.t_ack - w.t_syn, 0.0f)
          : field == kSynAck ? fmaxf(w.t_synack - w.t_syn, 0.0f)
                             : fmaxf(w.t_ack - w.t_synack, 0.0f);
      break;
    case kFlagCnt:
      for (int i = 0; i < r.L; ++i) v += static_cast<float>(r.flags[i * 8 + field]);
      break;
    default:  // kStat
      v = stat_of(buf, gather(r, d, field, buf), stat);
      break;
  }
  return v;
}

}  // namespace cato
