// B5: masked per-flow statistics over a (flows x packets) matrix.
//
// Replaces the Pallas kernel src/repro/kernels/feature_extract.py
// `flow_stats_kernel_call` (body `_stats_kernel`), reached through
// src/repro/kernels/ops.py `flow_stats`. For each flow row n it computes,
// over the packets p whose mask is non-zero,
//   count = sum m,  sum = sum v*m,  sumsq = sum (v*v)*m,
//   min = min v,    max = max v,
// with min and max 0 for a row that has no valid packet (never the
// +-3.4e38 sentinels). A masked packet's value still enters the sums as
// v*0, as in the JAX body, so a non-finite masked value makes them NaN.
//
// Bound on the H100. Bytes: each value read once (4 B), each mask byte
// once (1 B), five floats written per row: N*P*5 + N*20 bytes, 12 MB at
// the stream trace's (600, 4000), 3.6 us at 3.35 TB/s; 2.6 MB and 0.8 us
// at the iot window's (4000, 128). The operations (eight per element) are
// far below the float32 rate. Reaching the byte rate needs about 2 MB in
// flight (3.35 TB/s over ~0.6 us of latency).
//
// Layout. The TPU grid walks blocks of 512 rows, each reduced whole in
// VMEM. Here a row's packet axis is cut into `parts` contiguous parts of
// `part_len` packets (a multiple of 128), both from P alone (`split_plan`
// in kernels/feature_extract.py: as few parts as keep a warp at no more
// than 4 steps of 128 packets, at most 8), and one warp reduces each part.
// A block of 8 warps holds 8 / parts rows, so a long row's parts run side
// by side and a short row still has a warp to itself. In a part, lane l
// takes the groups of 4 consecutive packets at 128 i + 4 l (i = 0, 1,
// ...): one 16-byte load of values and one 4-byte load of mask a group
// when P is a multiple of 4 and the pointers are aligned (both arrays are
// indexed by the same n * P + p), else four scalar loads of each, in the
// same order. A lane issues all of a round's loads (4 groups, 80 bytes)
// before it adds, so at the stream trace each of the 600 x 256 threads
// has its whole share in flight at once (12 MB in one wave). A part of
// one step (P <= 128, the iot window) takes a round of one group: the
// three empty slots of a round of 4 cost it time on the card (PERF.md).
// What is left is the launch: on an H100 the kernel takes about an empty
// launch's time plus the bytes' (PERF.md has the times).
//
// Order of arithmetic (`flow_stats_plain` repeats it, so that the two are
// bitwise equal on the card): a lane adds its groups in order, each
// group's packets in order, into five float32 accumulators (count, v*m,
// (v*v)*m; min and max as selects, so the sentinels of masked packets
// never reach a result); the 32 lanes of a part merge in a fixed
// __shfl_xor_sync butterfly (offsets 16, 8, 4, 2, 1); then a row's parts
// merge in part order, ((p0 + p1) + p2) + ..., through shared memory.
// Packets past the row's end are not added (the plain version adds them
// as 0 with mask 0, which leaves every accumulator as it was). The build
// passes --fmad=false, so no multiply and add is contracted.
#include <cstdint>

namespace {

constexpr int kWarps = 8;          // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 4;          // packets a lane takes at a time
constexpr int kSpan = 32 * kGroup; // packets a warp takes a step
constexpr int kRound = 4;          // groups a lane loads before it adds
constexpr float kBig = 3.4e38f;    // the JAX body's sentinel

struct Stats {
  float cnt = 0.0f, s = 0.0f, sq = 0.0f, mn = kBig, mx = -kBig;
  __device__ __forceinline__ void add(float v, bool valid) {
    const float mf = valid ? 1.0f : 0.0f;
    cnt = cnt + mf;
    s = s + v * mf;
    sq = sq + (v * v) * mf;
    mn = valid ? fminf(mn, v) : mn;
    mx = valid ? fmaxf(mx, v) : mx;
  }
};

// kLoads groups a lane loads before it adds: kRound, or 1 where a part
// has one step (see the layout note)
template <bool kVector, int kLoads>
__global__ void __launch_bounds__(kThreads) flow_stats_kernel(
    const float* __restrict__ values,          // (N, P)
    const unsigned char* __restrict__ mask,    // (N, P), non-zero = valid
    float* __restrict__ out,                   // (N, 5)
    int N, int P, int part_shift, int part_len) {
  __shared__ float part_stats[kWarps][5];
  const int parts = 1 << part_shift;           // warps a row
  const int rows = kWarps >> part_shift;       // rows a block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * rows + (warp >> part_shift);
  const int part = warp & (parts - 1);
  Stats st;
  if (n < N) {
    const size_t row = static_cast<size_t>(n) * P;
    const int begin = part * part_len;
    const int end = min(begin + part_len, P);
    for (int p0 = begin + lane * kGroup; p0 < end; p0 += kLoads * kSpan) {
      float v[kLoads][kGroup];
      unsigned char m[kLoads][kGroup];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int p = p0 + u * kSpan;
        if constexpr (kVector) {
          // P % 4 == 0: a group lies wholly below `end` or wholly past it
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
          uint32_t b = 0u;
          if (p < end) {
            a = *reinterpret_cast<const float4*>(values + row + p);
            b = *reinterpret_cast<const uint32_t*>(mask + row + p);
          }
          v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
#pragma unroll
          for (int e = 0; e < kGroup; ++e) m[u][e] = (b >> (8 * e)) & 0xffu;
        } else {
#pragma unroll
          for (int e = 0; e < kGroup; ++e) {
            const bool in = p + e < end;
            v[u][e] = in ? values[row + p + e] : 0.0f;
            m[u][e] = in ? mask[row + p + e] : 0;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int p = p0 + u * kSpan;
#pragma unroll
        for (int e = 0; e < kGroup; ++e)
          if (p + e < end) st.add(v[u][e], m[u][e] != 0);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    st.cnt = st.cnt + __shfl_xor_sync(0xffffffffu, st.cnt, off);
    st.s = st.s + __shfl_xor_sync(0xffffffffu, st.s, off);
    st.sq = st.sq + __shfl_xor_sync(0xffffffffu, st.sq, off);
    st.mn = fminf(st.mn, __shfl_xor_sync(0xffffffffu, st.mn, off));
    st.mx = fmaxf(st.mx, __shfl_xor_sync(0xffffffffu, st.mx, off));
  }
  if (lane == 0) {
    part_stats[warp][0] = st.cnt;
    part_stats[warp][1] = st.s;
    part_stats[warp][2] = st.sq;
    part_stats[warp][3] = st.mn;
    part_stats[warp][4] = st.mx;
  }
  __syncthreads();
  // one thread a (row, statistic): the row's parts in part order
  if (threadIdx.x < rows * 5) {
    const int r = threadIdx.x / 5, k = threadIdx.x % 5;
    const int nr = blockIdx.x * rows + r;
    if (nr < N) {
      const float* ps = &part_stats[r << part_shift][0];
      float cnt = ps[0], acc = ps[k];
      for (int w = 1; w < parts; ++w) {
        const float x = ps[w * 5 + k];
        cnt = cnt + ps[w * 5];
        acc = k < 3 ? acc + x : k == 3 ? fminf(acc, x) : fmaxf(acc, x);
      }
      out[static_cast<size_t>(nr) * 5 + k] = k < 3 || cnt > 0.0f ? acc : 0.0f;
    }
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise. `parts`
// (1, 2, 4 or 8) and `part_len` (a multiple of 128, parts * part_len >= P)
// split each row, as `split_plan` gives them. Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a split
// the kernel does not take.
extern "C" int flow_stats_launch(const float* values,
                                 const unsigned char* mask, float* out, int N,
                                 int P, int parts, int part_len,
                                 void* stream) {
  if (parts < 1 || parts > kWarps || kWarps % parts || part_len % kSpan ||
      static_cast<long long>(parts) * part_len < P)
    return static_cast<int>(cudaErrorInvalidValue);
  const int shift = __builtin_ctz(parts);
  const int rows = kWarps >> shift;
  const int blocks = (N + rows - 1) / rows;
  const bool vector = P % kGroup == 0 &&
                      reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CATO_STATS_LAUNCH(VEC, LOADS)                                      \
  flow_stats_kernel<VEC, LOADS><<<blocks, kThreads, 0, s>>>(               \
      values, mask, out, N, P, shift, part_len)
  if (part_len == kSpan) {   // a part of one step
    if (vector) CATO_STATS_LAUNCH(true, 1);
    else CATO_STATS_LAUNCH(false, 1);
  } else {
    if (vector) CATO_STATS_LAUNCH(true, kRound);
    else CATO_STATS_LAUNCH(false, kRound);
  }
#undef CATO_STATS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
