// Feature columns of a stats plan over one flow's packet window, one warp
// per flow: the counterpart of src/repro/traffic/extraction.py
// `emit_feature_columns`, used by fused_pipeline.cu (B2) for a plan and by
// fused_multi.cu (B4) for each depth group of a merged plan. Every column
// is the same IEEE operations in the same order as the plain version's.
//
// A plan is an int32 op table, one row per column (kind, direction, field,
// stat; repro_torch/kernels/fused_pipeline.py `encode_plan`; B4's merged
// table adds a fifth field, the column's connection depth), which the
// kernels interpret: one compiled kernel serves every plan.
//
// The warp stages its flow's packets in shared memory, kChunk (128) at a
// time, with coalesced loads: size, winsize, ttl (float32), direction, the
// 8 flag bytes, and each packet's inter-arrival time, computed there from
// the exclusive running max of the earlier same-direction timestamps (a
// warp max-scan; max is exact, so the order of the scan does not matter).
// A window of at most kChunk packets is staged once; a longer one again
// for each pass below, chunk by chunk in packet order.
//
// Lane c owns the op-table rows at places c, c + 32, c + 64, c + 96 of
// its list (at most 128 rows a call: B2's whole plan, or a slice of one of
// B4's depth groups). One pass over the window, every lane at the same
// packet, adds each of its columns' samples (selected by direction and
// field, or a flag byte) in packet order: sum, count, min, max, by selects
// rather than branches, so the lanes' different columns do not split the
// warp. A second pass, taken when some lane has a std column, adds std's
// squares by fmaf around the mean. So sums, means, loads, counts and std
// round exactly as the plain version's `_seq_sum` does. The medians are
// the warp's together, one at a time: the column's samples are compacted
// (ballot and popcount) into a buffer, shared memory when the window fits
// a chunk, else the flow's row of a (N, W) scratch in device memory, and
// the samples of ranks (c-1)/2 and c/2 are selected: up to kChunk samples
// by counting each one's rank against all (one sweep for both ranks), more
// by a radix select over the samples' order-preserving keys (4 passes of
// 8 bits, a 256-bin histogram in shared memory). A median is an exact
// sample pair, so any exact selection gives the plain version's bits.
// Duration and the handshake's first matches (ballot, first set lane) are
// taken while the first pass stages the window.
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

constexpr int kChunk = 128;          // packets a warp stages at a time
constexpr int kChunkPad = kChunk + 1;  // lanes reading different fields of
                                       // one packet hit different banks
constexpr int kWarpSlots = 4;        // op-table rows a lane owns: <= 128 a call
constexpr unsigned kFullMask = 0xffffffffu;

// One warp's shared memory for its flow's window.
struct WarpWindow {
  float val[4][kChunkPad];   // by Field: size, iat, winsize, ttl
  uint8_t dir[kChunk];
  uint8_t iat_ok[kChunk];    // 1 where an earlier same-direction packet is
  uint8_t flags[kChunk][8];
  float samples[kChunk];     // one median's samples, windows <= kChunk
  unsigned hist[256];        // the radix select's histogram
};

__device__ __forceinline__ float warp_fmax(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}
__device__ __forceinline__ float warp_fmin(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Window terms the first pass gathers: each lane's min and max timestamp,
// and the handshake's first matches (the same in every lane).
struct WindowScan {
  float t_lo = kBig, t_hi = -kBig;
  float t_syn = 0.0f, t_synack = 0.0f, t_ack = 0.0f;
  bool seen_syn = false, seen_synack = false, seen_ack = false;
};

// Stage packets [i0, i0 + kChunk) of `r` into `s`; `prev` carries the
// running max of each direction's timestamps from the chunks before. With
// `scan`, also gather the window terms.
__device__ inline void stage_chunk(const Row& r, int i0, WarpWindow& s,
                                   float (&prev)[2], WindowScan* scan,
                                   int lane) {
  const int n = min(kChunk, r.L - i0);
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < n;
    const size_t i = static_cast<size_t>(i0 + j);
    float t = 0.0f, sz = 0.0f, tl = 0.0f, wn = 0.0f;
    int d = 2;
    uint8_t fl[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (in) {
      t = r.ts[i];
      sz = r.size[i];
      tl = r.ttl[i];
      wn = r.win[i];
      d = r.dir[i];
#pragma unroll
      for (int k = 0; k < 8; ++k) fl[k] = r.flags[i * 8 + k];
    }
    // the exclusive running max of this packet's direction's timestamps,
    // from -kBig (extraction.py `dir_iat`)
    float pv = -kBig;
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      float x = in && d == dd ? t : -kBig;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x = fmaxf(x, y);
      }
      float ex = __shfl_up_sync(kFullMask, x, 1);
      ex = fmaxf(prev[dd], lane == 0 ? -kBig : ex);
      if (d == dd) pv = ex;
      prev[dd] = fmaxf(prev[dd], __shfl_sync(kFullMask, x, 31));
    }
    if (in) {
      s.val[kBytes][j] = sz;
      s.val[kIat][j] = t - pv;
      s.val[kWinsize][j] = wn;
      s.val[kTtl][j] = tl;
      s.dir[j] = static_cast<uint8_t>(d);
      s.iat_ok[j] = pv > -kBig / 2;
#pragma unroll
      for (int k = 0; k < 8; ++k) s.flags[j][k] = fl[k];
    }
    if (scan != nullptr) {
      if (in) {
        scan->t_lo = fminf(scan->t_lo, t);
        scan->t_hi = fmaxf(scan->t_hi, t);
      }
      const bool syn = in && fl[kSynFlag] > 0, ack = in && fl[kAckFlag] > 0;
      const unsigned b_syn = __ballot_sync(kFullMask, syn && !ack);
      const unsigned b_synack = __ballot_sync(kFullMask, syn && ack);
      const unsigned b_ack = __ballot_sync(kFullMask, ack && !syn);
      // the first set lane's timestamp (lane 0's when none is set)
      const float t_syn = __shfl_sync(kFullMask, t, max(__ffs(b_syn) - 1, 0));
      const float t_synack =
          __shfl_sync(kFullMask, t, max(__ffs(b_synack) - 1, 0));
      const float t_ack = __shfl_sync(kFullMask, t, max(__ffs(b_ack) - 1, 0));
      if (!scan->seen_syn && b_syn) { scan->t_syn = t_syn; scan->seen_syn = true; }
      if (!scan->seen_synack && b_synack) {
        scan->t_synack = t_synack;
        scan->seen_synack = true;
      }
      if (!scan->seen_ack && b_ack) { scan->t_ack = t_ack; scan->seen_ack = true; }
    }
  }
}

// An order-preserving unsigned key of a float, and back.
__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The sample of rank `rank` (0-based, < c) of buf[0..c), by the warp:
// a radix select over float_key, 8 bits a pass from the top.
__device__ inline float warp_select(const float* buf, int c, int rank,
                                    unsigned* hist, int lane) {
  unsigned prefix = 0, mask = 0;
  unsigned want = static_cast<unsigned>(rank);
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = lane; b < 256; b += 32) hist[b] = 0;
    __syncwarp();
    for (int i = lane; i < c; i += 32) {
      const unsigned k = float_key(buf[i]);
      if ((k & mask) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1u);
    }
    __syncwarp();
    unsigned h[8], local = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      h[e] = hist[lane * 8 + e];
      local += h[e];
    }
    unsigned incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned excl = incl - local;
    const bool mine = excl <= want && want < incl;
    const int src = __ffs(__ballot_sync(kFullMask, mine)) - 1;
    unsigned digit = 0, below = excl;
    if (mine) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (want < below + h[e]) {
          digit = lane * 8 + e;
          break;
        }
        below += h[e];
      }
    }
    digit = __shfl_sync(kFullMask, digit, src);
    below = __shfl_sync(kFullMask, below, src);
    want -= below;
    prefix |= digit << shift;
    mask |= 255u << shift;
    __syncwarp();   // every lane has read the histogram before it is cleared
  }
  return key_float(prefix);
}

// The samples of ranks lo and hi (lo <= hi < c) of buf[0..c), by the warp,
// for a short buffer: lane l ranks samples l, l + 32, ... against all c
// (ties broken by index, so the ranks are a permutation) in one sweep.
__device__ inline void warp_rank_pair(const float* buf, int c, int lo, int hi,
                                      float& a_lo, float& a_hi, int lane) {
  for (int i0 = 0; i0 < c; i0 += 32) {
    const int i = i0 + lane;
    const float v = i < c ? buf[i] : 0.0f;
    int rank = 0;
#pragma unroll 4
    for (int j = 0; j < c; ++j) {
      const float u = buf[j];
      rank += (u < v) | ((u == v) & (j < i));
    }
    const unsigned b_lo = __ballot_sync(kFullMask, i < c && rank == lo);
    const unsigned b_hi = __ballot_sync(kFullMask, i < c && rank == hi);
    if (b_lo) a_lo = __shfl_sync(kFullMask, v, __ffs(b_lo) - 1);
    if (b_hi) a_hi = __shfl_sync(kFullMask, v, __ffs(b_hi) - 1);
  }
}

// The median of the c samples of (direction md, field mf) in the window,
// by the warp: the samples compacted into `buf` in packet order (the
// window restaged when it is longer than a chunk), then ranks (c-1)/2 and
// c/2 selected. Not inlined: each column slot calls it, and one copy of
// its code keeps the kernel small enough for the instruction cache. Static:
// B2's and B4's objects each hold a copy.
static __device__ __noinline__ float warp_median(const Row r, WarpWindow* sp,
                                                 float* buf, int md, int mf,
                                                 int c, int lane) {
  WarpWindow& s = *sp;
  const bool one_chunk = r.L <= kChunk;
  const unsigned lt_mask = (1u << lane) - 1u;
  float prev[2] = {-kBig, -kBig};
  int filled = 0;
  for (int i0 = 0; i0 < r.L; i0 += kChunk) {
    if (!one_chunk) stage_chunk(r, i0, s, prev, nullptr, lane);
    __syncwarp();
    const int n = min(kChunk, r.L - i0);
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool use = j < n && s.dir[j] == md && (mf != kIat || s.iat_ok[j]);
      const unsigned b = __ballot_sync(kFullMask, use);
      if (use) buf[filled + __popc(b & lt_mask)] = s.val[mf][j];
      filled += __popc(b);
    }
    __syncwarp();
  }
  const int lo = (c - 1) / 2, hi = c / 2;
  float a_lo = 0.0f, a_hi = 0.0f;
  if (c <= kChunk) {
    warp_rank_pair(buf, c, lo, hi, a_lo, a_hi, lane);
  } else {
    a_lo = warp_select(buf, c, lo, s.hist, lane);
    a_hi = hi == lo ? a_lo : warp_select(buf, c, hi, s.hist, lane);
  }
  __syncwarp();
  return 0.5f * (a_lo + a_hi);
}

// The columns of F rows (F <= kWarpSlots * 32) of op table `op_table`
// over the window `r`, by the warp. Without kIndexed the rows are 0..F-1
// (B2's plan); with it, rows[0..F) (shared memory) lists them (a slice of
// one of B4's depth groups). A row is kOpStride ints, of which the first
// four are read. Row f's column goes to x[f] (shared or global memory) and,
// when `col_out` is not null, to col_out[f]. proto, s_port and d_port are
// the flow's meta columns. `samples_g` is the flow's row of W floats of the
// scratch, null when the window W fits a chunk.
template <int kOpStride = 4, bool kIndexed = false>
__device__ inline void warp_columns(const Row& r,
                                    const int* __restrict__ op_table,
                                    const int* rows, int F,
                                    float proto, float s_port, float d_port,
                                    WarpWindow& s, float* samples_g, float* x,
                                    float* col_out, int lane) {
  const int nslots = (F + 31) / 32;
  const bool one_chunk = r.L <= kChunk;
  int kind[kWarpSlots], dd[kWarpSlots], fld[kWarpSlots], st[kWarpSlots];
  int row[kWarpSlots];    // the op-table row of each slot
  int mode[kWarpSlots];   // 0 none, 1 by direction, 2 iat, 3 flag byte
  float sum[kWarpSlots], mn[kWarpSlots], mx[kWarpSlots], sq[kWarpSlots];
  int cnt[kWarpSlots];
#pragma unroll
  for (int sl = 0; sl < kWarpSlots; ++sl) {
    const int f = lane + 32 * sl;
    kind[sl] = -1;
    dd[sl] = fld[sl] = st[sl] = 0;
    row[sl] = f;
    if (sl < nslots && f < F) {
      if (kIndexed) row[sl] = rows[f];
      const int* op = op_table + kOpStride * row[sl];
      kind[sl] = __ldg(op);
      dd[sl] = __ldg(op + 1);
      fld[sl] = __ldg(op + 2);
      st[sl] = __ldg(op + 3);
    }
    mode[sl] = kind[sl] == kLoad || kind[sl] == kPktCnt ? 1
               : kind[sl] == kFlagCnt                   ? 3
               : kind[sl] == kStat                      ? (fld[sl] == kIat ? 2 : 1)
                                                        : 0;
    if (kind[sl] == kLoad || kind[sl] == kPktCnt) fld[sl] = kBytes;
    sum[sl] = 0.0f;
    sq[sl] = 0.0f;
    mn[sl] = __int_as_float(0x7f800000);    // +inf
    mx[sl] = -__int_as_float(0x7f800000);
    cnt[sl] = 0;
  }

  // each column's source row in the staged window
  const float* val_p[kWarpSlots];
  const uint8_t* flag_p[kWarpSlots];
#pragma unroll
  for (int sl = 0; sl < kWarpSlots; ++sl) {
    val_p[sl] = s.val[fld[sl] & 3];
    flag_p[sl] = &s.flags[0][fld[sl] & 7];
  }

  // pass 1: every column's sum, count, min and max; the window terms
  WindowScan scan;
  float prev[2] = {-kBig, -kBig};
  for (int i0 = 0; i0 < r.L; i0 += kChunk) {
    stage_chunk(r, i0, s, prev, &scan, lane);
    __syncwarp();
    const int n = min(kChunk, r.L - i0);
    // branch-free: the lanes' columns differ, so every lane loads both
    // sources and selects; a branch per column would split the warp
    for (int j = 0; j < n; ++j) {
      const int dj = s.dir[j];
      const bool okj = s.iat_ok[j];
#pragma unroll
      for (int sl = 0; sl < kWarpSlots; ++sl) {
        if (sl >= nslots) break;
        const float vf = static_cast<float>(flag_p[sl][8 * j]);
        const float vv = val_p[sl][j];
        const float v = mode[sl] == 3 ? vf : vv;
        const bool use = mode[sl] == 3 ||
                         (mode[sl] != 0 && dj == dd[sl] && (mode[sl] != 2 || okj));
        const float added = sum[sl] + v;
        const float lo = fminf(mn[sl], v), hi = fmaxf(mx[sl], v);
        sum[sl] = use ? added : sum[sl];
        cnt[sl] += use ? 1 : 0;
        mn[sl] = use ? lo : mn[sl];
        mx[sl] = use ? hi : mx[sl];
      }
    }
    __syncwarp();
  }
  const float t_lo = warp_fmin(scan.t_lo), t_hi = warp_fmax(scan.t_hi);
  const float dur = r.L > 0 ? t_hi - t_lo : 0.0f;

  // pass 2: std's squares around the mean, by fmaf in packet order
  bool has_std = false;
#pragma unroll
  for (int sl = 0; sl < kWarpSlots; ++sl)
    has_std |= kind[sl] == kStat && st[sl] == kStd && cnt[sl] > 0;
  if (__any_sync(kFullMask, has_std)) {
    float mean[kWarpSlots];
#pragma unroll
    for (int sl = 0; sl < kWarpSlots; ++sl)
      mean[sl] = cnt[sl] > 0 ? sum[sl] / static_cast<float>(cnt[sl]) : 0.0f;
    prev[0] = prev[1] = -kBig;
    for (int i0 = 0; i0 < r.L; i0 += kChunk) {
      if (!one_chunk) stage_chunk(r, i0, s, prev, nullptr, lane);
      __syncwarp();
      const int n = min(kChunk, r.L - i0);
      for (int j = 0; j < n; ++j) {
        const int dj = s.dir[j];
        const bool okj = s.iat_ok[j];
#pragma unroll
        for (int sl = 0; sl < kWarpSlots; ++sl) {
          if (sl >= nslots) break;
          const bool use = kind[sl] == kStat && st[sl] == kStd &&
                           dj == dd[sl] && (mode[sl] != 2 || okj);
          const float dv = val_p[sl][j] - mean[sl];
          const float q = fmaf(dv, dv, sq[sl]);
          sq[sl] = use ? q : sq[sl];
        }
      }
      __syncwarp();
    }
  }

  // the finished columns, medians still open
  float col[kWarpSlots];
#pragma unroll
  for (int sl = 0; sl < kWarpSlots; ++sl) {
    const float fc = static_cast<float>(cnt[sl]);
    float v = 0.0f;
    switch (kind[sl]) {
      case kDur:
        v = dur;
        break;
      case kMeta:
        v = fld[sl] == kProto ? proto : fld[sl] == kSPort ? s_port : d_port;
        break;
      case kLoad:
        v = dur > 0.0f ? sum[sl] * 8.0f / fmaxf(dur, 1e-9f) : 0.0f;
        break;
      case kPktCnt:
        v = fc;
        break;
      case kHandshake:
        v = fld[sl] == kTcpRtt   ? fmaxf(scan.t_ack - scan.t_syn, 0.0f)
            : fld[sl] == kSynAck ? fmaxf(scan.t_synack - scan.t_syn, 0.0f)
                                 : fmaxf(scan.t_ack - scan.t_synack, 0.0f);
        break;
      case kFlagCnt:
        v = sum[sl];
        break;
      case kStat:
        if (cnt[sl] == 0) break;
        v = st[sl] == kSum    ? sum[sl]
            : st[sl] == kMean ? sum[sl] / fc
            : st[sl] == kMin  ? mn[sl]
            : st[sl] == kMax  ? mx[sl]
            : st[sl] == kStd  ? sqrtf(sq[sl] / fc)
                              : 0.0f;   // kMed: below
        break;
      default:
        break;
    }
    col[sl] = v;
  }

  // the medians, one column at a time by the whole warp
  float* buf = one_chunk ? s.samples : samples_g;
#pragma unroll
  for (int sl = 0; sl < kWarpSlots; ++sl) {
    if (sl >= nslots) break;
    unsigned todo = __ballot_sync(
        kFullMask, kind[sl] == kStat && st[sl] == kMed && cnt[sl] > 0);
    while (todo) {
      const int owner = __ffs(todo) - 1;
      todo &= todo - 1;
      const float med = warp_median(
          r, &s, buf, __shfl_sync(kFullMask, dd[sl], owner),
          __shfl_sync(kFullMask, fld[sl], owner) & 3,
          __shfl_sync(kFullMask, cnt[sl], owner), lane);
      if (lane == owner) col[sl] = med;
    }
  }

  // the columns out
#pragma unroll
  for (int sl = 0; sl < kWarpSlots; ++sl) {
    const int f = lane + 32 * sl;
    if (sl < nslots && f < F) {
      x[row[sl]] = col[sl];
      if (col_out != nullptr) col_out[row[sl]] = col[sl];
    }
  }
}

}  // namespace cato
