// B5: masked per-flow statistics over a (flows x packets) matrix.
//
// Replaces the Pallas kernel src/repro/kernels/feature_extract.py
// `flow_stats_kernel_call` (body `_stats_kernel`), reached through
// src/repro/kernels/ops.py `flow_stats`. For each flow row n it computes,
// over the packets p whose mask is non-zero,
//   count = sum m,  sum = sum v*m,  sumsq = sum (v*v)*m,
//   min = min v,    max = max v,
// with min and max 0 for a row that has no valid packet (never the
// +-3.4e38 sentinels).
//
// Layout. The TPU grid walks blocks of 512 rows, each reduced whole in
// VMEM, and pads the row axis to the block multiple. Here one warp owns one
// row, 8 rows a block, and the ragged edge is masked, not padded: a warp
// whose row lies past N returns. Lane l walks packets l, l+32, ... in
// order (a warp reads 128 contiguous bytes of values and 32 of mask a
// step) and keeps five float32 accumulators; min and max are selects, so
// the sentinels of masked packets never reach a result. The 32 lanes then
// merge in a fixed __shfl_xor_sync butterfly (offsets 16, 8, 4, 2, 1): the
// order `flow_stats_plain` repeats, so that the two are bitwise equal. The
// squares are v*v, then *m, as the JAX body writes them; the build passes
// --fmad=false, so no multiply and add is contracted.
//
// Bound on the H100. Bytes: each value read once (4 B), each mask byte
// once (1 B), five floats written per row: N*P*5 + N*20 bytes, 13 MB at
// the stream trace's (600, 4000), 4 us at 3.35 TB/s. The operations (five
// per element) are far below the float32 rate. At these sizes the launch
// and the one wave of blocks set the time, not the bytes.

namespace {

constexpr int kWarps = 8;          // rows per block
constexpr float kBig = 3.4e38f;    // the JAX body's sentinel

__global__ void __launch_bounds__(kWarps * 32) flow_stats_kernel(
    const float* __restrict__ values,          // (N, P)
    const unsigned char* __restrict__ mask,    // (N, P), non-zero = valid
    float* __restrict__ out,                   // (N, 5)
    int N, int P) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;                          // the ragged edge: whole warp
  const float* v_row = values + static_cast<size_t>(n) * P;
  const unsigned char* m_row = mask + static_cast<size_t>(n) * P;
  float cnt = 0.0f, s = 0.0f, sq = 0.0f, mn = kBig, mx = -kBig;
  for (int p = lane; p < P; p += 32) {
    const float v = v_row[p];
    const bool valid = m_row[p] != 0;
    const float mf = valid ? 1.0f : 0.0f;
    cnt = cnt + mf;
    s = s + v * mf;
    sq = sq + (v * v) * mf;
    mn = valid ? fminf(mn, v) : mn;
    mx = valid ? fmaxf(mx, v) : mx;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt = cnt + __shfl_xor_sync(0xffffffffu, cnt, off);
    s = s + __shfl_xor_sync(0xffffffffu, s, off);
    sq = sq + __shfl_xor_sync(0xffffffffu, sq, off);
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if (lane < 5) {
    const bool has = cnt > 0.0f;
    const float r = lane == 0 ? cnt
                    : lane == 1 ? s
                    : lane == 2 ? sq
                    : lane == 3 ? (has ? mn : 0.0f)
                                : (has ? mx : 0.0f);
    out[static_cast<size_t>(n) * 5 + lane] = r;
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flow_stats_launch(const float* values,
                                 const unsigned char* mask, float* out, int N,
                                 int P, void* stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  flow_stats_kernel<<<blocks, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(values, mask, out,
                                                           N, P);
  return static_cast<int>(cudaGetLastError());
}
