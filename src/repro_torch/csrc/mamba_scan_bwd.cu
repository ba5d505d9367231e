// B8b: the gradient of B8 (the Mamba-2 / SSD scan): dx, ddt, dA, dBm and
// dCm from dy and the final state's gradient dh_last.
//
// Replaces no Pallas kernel: the reference has no backward kernel (no
// `custom_vjp` around src/repro/kernels/mamba_scan.py), and trains through
// XLA's autodiff of `chunked_ssd` (src/repro/models/ssm.py). B8 computes,
// per (batch, head) and chunk of c steps with L the in-order cumsum of
// dt * A, u = dt o x, the decay mask E (exp(L_t - L_tau) where tau <= t,
// else 0), M = E o C B^T, W = exp(L_c - L) and h the state entering the
// chunk:
//   y = M u + exp(L) o (C h^T),   h' = exp(L_c) h + (W o u)^T B.
// Its gradient, with G the gradient of h' (dh_last after the last chunk):
//   G_prev = exp(L_c) G + (exp(L) o dy)^T C
//   N  = E o (dy u^T)
//   du = M^T dy + W o (B G^T),          dx = dt o du
//   dC = N B + exp(L) o (dy h)          dB = N^T C + W o (u G)
//   dL_t = (sum_tau (N o C B^T)[t, tau] + exp(L_t) C_t . (dy h)_t)
//          - u_t . du_t,   plus G . h' at the chunk's last step
//   da = the reverse cumsum of dL,  ddt = x . du + da A,  dA += da . dt
// and dBm, dCm add the heads, dA the batch and the chunks.
//
// Design: B8's chunked form run backwards, each pass parallel over chunks.
//   a. B8's passes 0-2 (mamba_scan.cu `mamba_scan_states_launch`, the
//      same launches): C B^T per chunk and the state entering each chunk,
//      the same bits as the forward; autograd saves nothing new.
//   b. `state_grad_term_kernel`, grid (chunk, head, batch): the chunk's
//      (exp(L) o dy)^T C, a (P, S) product of depth c, in B8's chunk-state
//      layout (both operands whole in shared memory, 4 x 4 tiles).
//   c. `state_grad_pass_kernel`, B8's state pass reversed: a thread per
//      state entry walks the chunks from the last, G <- exp(L_c) G + term,
//      writing the G leaving each chunk over its term.
//   d. `chunk_bwd_kernel`, grid (chunk, head, batch) (4,096 blocks at
//      zamba2-1.2b's training shape, two an SM): N into shared memory,
//      then every product above, dx, ddt, the chunk's dA and the head's
//      dB and dC.
//   e. `scan_bwd_reduce_kernel`: the heads' dB and dC, the batch's and
//      chunks' dA, added in order.
// No atomics: every run gives the same bits. Each product of the chunk
// backward keeps an 8 x 4 register tile a thread (a 128 x 64 output a
// block of 256 threads, the layout of B8's chunk scan) and reads both
// operands as float4 rows of k-major shared memory, staged kStrip steps of
// k at a time: a thread's loads of a strip are all issued before its
// stores. Short strips keep the loads' registers few (the compiler holds
// their addresses across the strips). One accumulator tile is live at a
// time: N B and N^T C go to dC's and dB's outputs first, and the terms of
// depth P are added there once N's area is free, which then holds a
// (128, 64) result for the row chains. A product whose terms past the
// diagonal are zero stops its chains there (a zero term leaves an fmaf
// chain as it is). A chunk shorter than 128 steps runs as rows masked to
// zero; a ragged last chunk is masked as B8 masks it.
//
// Order of arithmetic. `mamba_scan_bwd_plain` (kernels/mamba_scan.py)
// computes each product as a float32 GEMM of a batch of matrices (cuBLAS,
// which adds each output's products in k order by FFMA, as these fmaf
// chains do), every other step op for op in the order written above, and
// each row sum or dot product in order from zero, as the threads' chains
// here. A change of either side's order changes the other.
//
// Bound on the H100. At zamba2-1.2b's training shape (B 2, T 4096, 64
// heads of P 64, S 64, bf16) the gradient reads x, dy, dt, B, C once and
// writes dx, ddt, dB, dC once: 0.0626 ms at 3.35 TB/s, counting B8's
// products twice at the bf16 rate. This design's own floor: about 19 G
// float32 FMAs (eight products of depth 64 or 128 per chunk and head,
// the three triangular ones about halved), 0.56 ms at the 67 TFLOP/s of
// the SMs' float32 pipes; staging the strips and the row chains add to
// it. The first
// design (one block per (head, batch) walking the step recurrence, a
// checkpoint every 16 steps, 805 MB of scratch) took 14.912 device ms
// there; this one's time is in PERF.md.
//
// Built with --fmad=false like every source here: each product and sum
// rounds on its own, as in the plain version.
#include "lm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;         // c; B8's kMaxChunk
constexpr int kRows = 128;             // a product tile's rows
constexpr int kCols = 64;              // its columns
constexpr int kStrip = 8;              // k steps a staged strip holds
constexpr int kLdRows = kRows + 4;     // a [k][row] strip row, float4-aligned
constexpr int kLdCols = kCols + 4;     // a [k][col] strip row
constexpr int kStripFloats = kStrip * (kLdRows + kLdCols);
constexpr int kVecs = 8;               // vectors of kMaxChunk floats
constexpr int kPrefetch = 8;           // chunks the state-gradient pass loads at once

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// dynamic shared memory of the chunk backward, in floats (the wrapper's
// `bwd_shared_bytes`)
__host__ __device__ constexpr int chunk_bwd_smem_floats(int P) {
  return kMaxChunk * kLdRows + kStripFloats + kVecs * kMaxChunk + round4(P);
}
// and of the state-gradient term, B8's chunk-state layout
__host__ __device__ constexpr int term_smem_floats(int c, int P, int S) {
  return 3 * kMaxChunk + c * (round4(P) + round4(S));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// L over n steps: the running float32 sum of dt * a, in order (B8's)
__device__ __forceinline__ void log_decay_in_order(const float* __restrict__ dt,
                                                   float a, int n,
                                                   float* __restrict__ L) {
  float run = 0.f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    run += dt[i] * a;
    L[i] = run;
  }
}

// This thread's tile of a (128, 64) product: rows [ty0, ty0 + 8), columns
// [py0, py0 + 4); a warp holds 4 row tiles x 8 column tiles (B8's chunk
// scan's layout).
struct Tile {
  int ty0, py0;
  __device__ __forceinline__ Tile() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    ty0 = 8 * (4 * (warp >> 1) + (lane >> 3));
    py0 = 4 * (8 * (warp & 1) + (lane & 7));
  }
};

// dst[kk][r] = f(k0 + kk, r) for a strip of kStrip steps and W rows, 0
// past step K: every value of this thread first (their loads in flight
// together), then the stores. kKFast walks kk fastest (for sources
// contiguous in k), else r.
template <bool kKFast, int W, typename F>
__device__ __forceinline__ void fill_strip(float* __restrict__ dst, int ld,
                                           int k0, int K, F f) {
  constexpr int kPer = kStrip * W / kThreads;
  float v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int kk = kKFast ? e % kStrip : e / W;
    const int r = kKFast ? e / kStrip : e % W;
    v[u] = k0 + kk < K ? f(k0 + kk, r) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int kk = kKFast ? e % kStrip : e / W;
    const int r = kKFast ? e / kStrip : e % W;
    dst[kk * ld + r] = v[u];
  }
}

// acc + term(0) + term(1) + ... + term(n - 1), added in order: the terms
// (each a rounded product) are computed 16 at a time, their loads in
// flight together, then added.
template <typename F>
__device__ __forceinline__ float chain(float acc, int n, F term) {
  for (int j0 = 0; j0 < n; j0 += 16) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = j0 + u < n ? term(j0 + u) : 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (j0 + u < n) acc = acc + v[u];
  }
  return acc;
}

// acc[i][j] = fmaf(X(k, ty0 + i), Y(k, py0 + j), acc[i][j]) for k in
// [0, K) in order: X(k, row) for 128 rows and Y(k, col) for 64 columns
// staged strip by strip. Every thread of the block calls it (it
// synchronises); a thread adds only the k in [k_lo, k_hi) (the others
// are zero terms for its tile) and only if `owns`.
template <bool kXK, bool kYK, typename FX, typename FY>
__device__ __forceinline__ void strip_product(float (&acc)[8][4],
                                              float* __restrict__ sX,
                                              float* __restrict__ sY, int K,
                                              int k_lo, int k_hi, bool owns,
                                              const Tile& tl, FX fx, FY fy) {
  for (int k0 = 0; k0 < K; k0 += kStrip) {
    __syncthreads();   // the strip before is consumed
    fill_strip<kXK, kRows>(sX, kLdRows, k0, K, fx);
    fill_strip<kYK, kCols>(sY, kLdCols, k0, K, fy);
    __syncthreads();
    const int ka = max(k0, k_lo), kb = min(min(k0 + kStrip, K), k_hi);
    if (!owns) continue;
#pragma unroll 4
    for (int k = ka; k < kb; ++k) {
      const float* xr = sX + (k - k0) * kLdRows + tl.ty0;
      const float4 a0 = ld4(xr), a1 = ld4(xr + 4);
      const float4 b = ld4(sY + (k - k0) * kLdCols + tl.py0);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// this thread's tile, its rows below nv and columns below S, into rows
// of S floats at column s0
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[8][4],
                                           const Tile& tl, bool owns, int nv,
                                           int S, int s0) {
  if (!owns) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = tl.ty0 + i;
    if (t >= nv) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (s0 + tl.py0 + j < S)
        out[static_cast<size_t>(t) * S + s0 + tl.py0 + j] = acc[i][j];
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// The inputs of one (chunk, head, batch): reads that give 0 past the
// chunk's steps inside T (nv) and past the row widths.
template <typename T>
struct ChunkIn {
  const T* x;     // (B, T, H, P)
  const T* dy;    // (B, T, H, P)
  const T* Bm;    // (B, T, S)
  const T* Cm;    // (B, T, S)
  size_t row0;    // b * T + the chunk's first step
  int H, h, P, S, nv;
  __device__ __forceinline__ float xv(int t, int p) const {
    return t < nv && p < P
               ? cato::to_float(x[((row0 + t) * H + h) * P + p]) : 0.f;
  }
  __device__ __forceinline__ float dyv(int t, int p) const {
    return t < nv && p < P
               ? cato::to_float(dy[((row0 + t) * H + h) * P + p]) : 0.f;
  }
  __device__ __forceinline__ float bv(int t, int s) const {
    return t < nv && s < S ? cato::to_float(Bm[(row0 + t) * S + s]) : 0.f;
  }
  __device__ __forceinline__ float cv(int t, int s) const {
    return t < nv && s < S ? cato::to_float(Cm[(row0 + t) * S + s]) : 0.f;
  }
};

// dt of the chunk (0 past nv), L over all 128 steps, and exp(L)
template <typename T>
__device__ __forceinline__ void chunk_decay(const ChunkIn<T>& in,
                                            const float* __restrict__ dt,
                                            float a, float* sDT, float* sL,
                                            float* sEL) {
  const int tid = threadIdx.x;
  if (tid < kMaxChunk)
    sDT[tid] = tid < in.nv ? dt[(in.row0 + tid) * in.H + in.h] : 0.f;
  __syncthreads();
  if (tid == 0) log_decay_in_order(sDT, a, kMaxChunk, sL);
  __syncthreads();
  if (tid < kMaxChunk) sEL[tid] = expf(sL[tid]);
}

// b. the chunk's share of the state gradient, (exp(L) o dy)^T C, (P, S),
// into G (B, H, n_chunks, P, S): B8's chunk-state pass with exp(L) o dy
// and C for W o dt o x and B. The chunk's exp(L) o dy (rows of P rounded
// up to 4 floats) and C (rows of S4) stay in shared memory; each thread
// keeps 4 x 4 tiles, k the chunk's steps in order.
template <typename T>
__global__ void __launch_bounds__(kThreads) state_grad_term_kernel(
    const T* __restrict__ dy, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Cm,
    float* __restrict__ G, int Tn, int H, int P, int S, int c) {
  extern __shared__ __align__(16) float smem[];
  const int P4 = round4(P), S4 = round4(S);
  float* sDT = smem;
  float* sL = sDT + kMaxChunk;
  float* sEL = sL + kMaxChunk;
  float* sX = sEL + kMaxChunk;    // c x P4: dy, then exp(L) o dy
  float* sC = sX + c * P4;        // c x S4
  const int ic = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, t0 = ic * c, tid = threadIdx.x;
  const ChunkIn<T> in{nullptr, dy, nullptr, Cm,
                      static_cast<size_t>(b) * Tn + t0, H, h, P, S,
                      min(c, Tn - t0)};
  const T* dyc = dy + (in.row0 * H + h) * P;   // the chunk's first step
  const T* cc = Cm + in.row0 * S;
  for (int e = tid; e < c * P4; e += kThreads) {
    const int r = e / P4, p = e - r * P4;
    sX[e] = r < in.nv && p < P ? cato::to_float(dyc[r * H * P + p]) : 0.f;
  }
  for (int e = tid; e < c * S4; e += kThreads) {
    const int r = e / S4, s = e - r * S4;
    sC[e] = r < in.nv && s < S ? cato::to_float(cc[r * S + s]) : 0.f;
  }
  chunk_decay(in, dt, A[h], sDT, sL, sEL);
  __syncthreads();
  for (int e = tid; e < c * P4; e += kThreads) sX[e] = sEL[e / P4] * sX[e];
  __syncthreads();
  float* out = G + ((static_cast<size_t>(b) * H + h) * nc + ic) * P * S;
  const int s_tiles = S4 / 4, n_tiles = (P4 / 4) * s_tiles;
  for (int tile = tid; tile < n_tiles; tile += kThreads) {
    const int p0 = 4 * (tile / s_tiles), s0 = 4 * (tile % s_tiles);
    float acc[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < c; ++k) {
      const float4 a = ld4(sX + k * P4 + p0), bk = ld4(sC + k * S4 + s0);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (p0 + i >= P) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s0 + j < S) out[static_cast<size_t>(p0 + i) * S + s0 + j] = acc[i][j];
    }
  }
}

// c. the gradient of the state leaving each chunk, from the last: each
// thread walks one state entry, G <- exp(L_c) G + the chunk's term, and
// writes the G leaving the chunk over its term; the terms of kPrefetch
// chunks are loaded at once
__global__ void __launch_bounds__(kThreads) state_grad_pass_kernel(
    float* __restrict__ G,              // (B, H, n_chunks, P, S)
    const float* __restrict__ decay,    // (B, H, n_chunks): exp(L_c)
    const float* __restrict__ dh_last,  // (B, H, P, S) or null
    int H, int PS, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PS) return;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  float* g = G + bh * nc * PS + e;
  const float* dec = decay + bh * nc;
  float gv = dh_last != nullptr ? dh_last[bh * PS + e] : 0.f;
  for (int k1 = nc; k1 > 0; k1 -= kPrefetch) {   // chunks k1 - 1 down
    float term[kPrefetch];
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i)
      if (k1 - 1 - i >= 0) term[i] = g[static_cast<size_t>(k1 - 1 - i) * PS];
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int k = k1 - 1 - i;
      if (k >= 0) {
        g[static_cast<size_t>(k) * PS] = gv;
        gv = dec[k] * gv + term[i];
      }
    }
  }
}

// d. the chunk backward of one (chunk, head, batch)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) chunk_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const T* __restrict__ dy,
    const float* __restrict__ cb,       // (B, n_chunks, 128, 128): C B^T, transposed
    const float* __restrict__ states,   // (B, H, n_chunks, P, S): entering
    const float* __restrict__ h_last,   // (B, H, P, S)
    const float* __restrict__ G,        // (B, H, n_chunks, P, S): leaving
    T* __restrict__ dx,                 // (B, T, H, P)
    float* __restrict__ ddt,            // (B, T, H)
    float* __restrict__ dB_part,        // (B, H, T, S)
    float* __restrict__ dC_part,        // (B, H, T, S)
    float* __restrict__ dA_part,        // (B, H, n_chunks)
    int Tn, int H, int P, int S, int c) {
  extern __shared__ __align__(16) float smem[];
  float* sN = smem;                          // [t][tau]  N = E o (dy u^T)
  float* sX = sN + kMaxChunk * kLdRows;      // the operands' strips
  float* sY = sX + kStrip * kLdRows;
  float* sDT = sY + kStrip * kLdCols;
  float* sL = sDT + kMaxChunk;
  float* sEL = sL + kMaxChunk;
  float* sW = sEL + kMaxChunk;               // exp(L_c - L)
  float* sRowZ = sW + kMaxChunk;             // sum_tau (N o C B^T)[t, tau]
  float* sInter = sRowZ + kMaxChunk;         // C_t . (dy h)_t
  float* sXdu = sInter + kMaxChunk;          // x . du
  float* sUdu = sXdu + kMaxChunk;            // u . du
  float* sLam = sUdu + kMaxChunk;            // a row of G . h'
  const int ic = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x, t0 = ic * c;
  const ChunkIn<T> in{x, dy, Bm, Cm, static_cast<size_t>(b) * Tn + t0, H, h,
                      P, S, min(c, Tn - t0)};
  const float a = A[h];
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t PS = static_cast<size_t>(P) * S;
  const float* cbc = cb + (static_cast<size_t>(b) * nc + ic) * kMaxChunk * kMaxChunk;
  const float* hc = states + (bh * nc + ic) * PS;
  const float* hn = ic + 1 < nc ? hc + PS : h_last + bh * PS;
  const float* gc = G + (bh * nc + ic) * PS;
  chunk_decay(in, dt, a, sDT, sL, sEL);
  if (tid < kMaxChunk) {
    sW[tid] = expf(sL[c - 1] - sL[tid]);
    sInter[tid] = sXdu[tid] = sUdu[tid] = 0.f;
  }
  __syncthreads();
  const Tile tl;
  const bool rows_in = tl.ty0 < c;
  auto uv = [&](int t, int p) { return sDT[t] * in.xv(t, p); };
  // E o C B^T (B8's M), 0 where tau > t or t is past the chunk
  auto mv = [&](int t, int tau) {
    return t < c && tau <= t
               ? expf(sL[t] - sL[tau]) * cbc[static_cast<size_t>(tau) * kMaxChunk + t]
               : 0.f;
  };

  // N = E o (dy u^T), two halves of 64 steps tau
  for (int g = 0; g < kMaxChunk; g += kCols) {
    float acc[8][4];
    zero(acc);
    // a tile wholly past the diagonal (tau > t) is all zero
    const bool owns = rows_in && g + tl.py0 < c && g + tl.py0 <= tl.ty0 + 7;
    strip_product<true, true>(
        acc, sX, sY, g < c ? P : 0, 0, P, owns, tl,
        [&](int p, int t) { return in.dyv(t, p); },
        [&](int p, int j) { return uv(g + j, p); });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = tl.ty0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tau = g + tl.py0 + j;
        sN[t * kLdRows + tau] =
            t < c && tau <= t ? expf(sL[t] - sL[tau]) * acc[i][j] : 0.f;
      }
    }
  }
  __syncthreads();
  // row sums of N o C B^T, in order of tau
  if (tid < c)
    sRowZ[tid] = chain(0.f, tid + 1, [&](int tau) {
      return sN[tid * kLdRows + tau] *
             cbc[static_cast<size_t>(tau) * kMaxChunk + tid];
    });

  // One accumulator tile is live at a time. First the products with N:
  // dC's N B and dB's N^T C, 64 columns s at a time, into the outputs.
  float* dCp = dC_part + (bh * Tn + t0) * S;
  float* dBp = dB_part + (bh * Tn + t0) * S;
  for (int s0 = 0; s0 < S; s0 += kCols) {
    const bool owns = rows_in && s0 + tl.py0 < S;
    float acc[8][4];
    zero(acc);
    strip_product<true, false>(
        acc, sX, sY, c, 0, tl.ty0 + 8, owns, tl,
        [&](int tau, int t) { return sN[t * kLdRows + tau]; },
        [&](int tau, int s) { return in.bv(tau, s0 + s); });
    store_tile(dCp, acc, tl, owns, in.nv, S, s0);
    zero(acc);
    strip_product<false, false>(
        acc, sX, sY, c, tl.ty0, c, owns, tl,
        [&](int t, int tau) { return sN[t * kLdRows + tau]; },
        [&](int t, int s) { return in.cv(t, s0 + s); });
    store_tile(dBp, acc, tl, owns, in.nv, S, s0);
  }
  // N is consumed: its area holds a (128, 64) result from here on
  float* sR = sN;

  // dC += exp(L) o (dy h); C . (dy h) per row
  for (int s0 = 0; s0 < S; s0 += kCols) {
    const bool owns = rows_in && s0 + tl.py0 < S;
    float acc[8][4];
    zero(acc);
    strip_product<true, false>(
        acc, sX, sY, P, 0, P, owns, tl,
        [&](int p, int t) { return in.dyv(t, p); },
        [&](int p, int s) { return s0 + s < S ? hc[p * S + s0 + s] : 0.f; });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = tl.ty0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tl.py0 + j;
        sR[t * kLdCols + tl.py0 + j] = acc[i][j];
        if (owns && t < in.nv && s < S) {
          float& out = dCp[static_cast<size_t>(t) * S + s];
          out = out + sEL[t] * acc[i][j];
        }
      }
    }
    __syncthreads();
    if (tid < c)
      sInter[tid] = chain(sInter[tid], min(kCols, S - s0), [&](int s) {
        return in.cv(tid, s0 + s) * sR[tid * kLdCols + s];
      });
  }

  // dB += W o (u G)
  for (int s0 = 0; s0 < S; s0 += kCols) {
    const bool owns = rows_in && s0 + tl.py0 < S;
    float acc[8][4];
    zero(acc);
    strip_product<true, false>(
        acc, sX, sY, P, 0, P, owns, tl,
        [&](int p, int tau) { return uv(tau, p); },
        [&](int p, int s) { return s0 + s < S ? gc[p * S + s0 + s] : 0.f; });
    if (!owns) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int tau = tl.ty0 + i;
      if (tau >= in.nv) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tl.py0 + j;
        if (s < S) {
          float& out = dBp[static_cast<size_t>(tau) * S + s];
          out = out + sW[tau] * acc[i][j];
        }
      }
    }
  }

  // du = M^T dy + W o (B G^T), dx = dt o du; x . du and u . du per row
  for (int p0 = 0; p0 < P; p0 += kCols) {
    const bool owns = rows_in && p0 + tl.py0 < P;
    float acc[8][4];
    zero(acc);
    strip_product<true, true>(
        acc, sX, sY, S, 0, S, owns, tl,
        [&](int s, int tau) { return in.bv(tau, s); },
        [&](int s, int p) { return p0 + p < P ? gc[(p0 + p) * S + s] : 0.f; });
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(sR + (tl.ty0 + i) * kLdCols + tl.py0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    zero(acc);
    strip_product<true, false>(
        acc, sX, sY, c, tl.ty0, c, owns, tl, mv,
        [&](int t, int p) { return in.dyv(t, p0 + p); });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int tau = tl.ty0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + tl.py0 + j;
        float& r = sR[tau * kLdCols + tl.py0 + j];
        const float du = acc[i][j] + sW[tau] * r;
        r = du;
        if (owns && tau < in.nv && p < P)
          dx[((in.row0 + tau) * H + h) * P + p] =
              cato::from_float<T>(sDT[tau] * du);
      }
    }
    __syncthreads();
    const int r = tid % kMaxChunk;
    if (tid < 2 * kMaxChunk && r < c) {
      const bool by_u = tid >= kMaxChunk;
      float* dot = by_u ? sUdu : sXdu;
      dot[r] = chain(dot[r], min(kCols, P - p0), [&](int p) {
        const float xv = in.xv(r, p0 + p);
        return (by_u ? sDT[r] * xv : xv) * sR[r * kLdCols + p];
      });
    }
  }

  // G . h', the state leaving the chunk: a chain over s for each row p
  for (int p = tid; p < P; p += kThreads)
    sLam[p] = chain(0.f, S, [&](int s) { return gc[p * S + s] * hn[p * S + s]; });
  __syncthreads();
  // the rows of G . h' in order; then dL, its reverse cumsum da from G .
  // h', ddt = x . du + da A, and the chunk's dA = sum of da dt (from the
  // last step)
  if (tid == 0) {
    float run = 0.f;
    for (int p = 0; p < P; ++p) run = run + sLam[p];
    float dA_acc = 0.f;
    for (int j = c - 1; j >= 0; --j) {
      const float dL = (sRowZ[j] + sEL[j] * sInter[j]) - sUdu[j];
      run = run + dL;
      if (j < in.nv) ddt[(in.row0 + j) * H + h] = sXdu[j] + run * a;
      dA_acc = dA_acc + run * sDT[j];
    }
    dA_part[bh * nc + ic] = dA_acc;
  }
}

// e. dBm and dCm: the heads' parts added in order; dA: the batch's, each
// its chunks', in order
template <typename T>
__global__ void scan_bwd_reduce_kernel(
    const float* __restrict__ dB_part, const float* __restrict__ dC_part,
    const float* __restrict__ dA_part, T* __restrict__ dBm,
    T* __restrict__ dCm, float* __restrict__ dA, int B, int Tn, int H,
    int S, int nc) {
  const size_t n = static_cast<size_t>(B) * Tn * S;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       idx < n; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t bt = idx / S;
    const int s = static_cast<int>(idx - bt * S);
    const int bi = static_cast<int>(bt / Tn);
    const int t = static_cast<int>(bt - static_cast<size_t>(bi) * Tn);
    float ab = 0.f, ac = 0.f;
    for (int hh = 0; hh < H; ++hh) {
      const size_t g = ((static_cast<size_t>(bi) * H + hh) * Tn + t) * S + s;
      ab = ab + dB_part[g];
      ac = ac + dC_part[g];
    }
    dBm[idx] = cato::from_float<T>(ab);
    dCm[idx] = cato::from_float<T>(ac);
  }
  if (blockIdx.x == 0)
    for (int hh = threadIdx.x; hh < H; hh += blockDim.x) {
      float acc = 0.f;
      for (int bi = 0; bi < B; ++bi)
        for (int k = 0; k < nc; ++k)
          acc = acc + dA_part[(static_cast<size_t>(bi) * H + hh) * nc + k];
      dA[hh] = acc;
    }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const void* dy, const float* dh_last, void* dx,
           float* ddt, float* dA, void* dBm, void* dCm, const float* states,
           const float* decay, const float* cb, const float* h_last,
           float* G, float* dB_part, float* dC_part, float* dA_part, int B,
           int Tn, int H, int P, int S, int c, cudaStream_t stream) {
  const int nc = (Tn + c - 1) / c;
  const size_t term_bytes = sizeof(float) * term_smem_floats(c, P, S);
  const size_t bwd_bytes = sizeof(float) * chunk_bwd_smem_floats(P);
  cudaError_t err =
      cato::allow_shared_memory(state_grad_term_kernel<T>, term_bytes);
  if (err == cudaSuccess)
    err = cato::allow_shared_memory(chunk_bwd_kernel<T>, bwd_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  const dim3 chunks(nc, H, B);
  state_grad_term_kernel<T><<<chunks, kThreads, term_bytes, stream>>>(
      dyt, dt, A, Ct, G, Tn, H, P, S, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  state_grad_pass_kernel<<<dim3((P * S + kThreads - 1) / kThreads, H, B),
                           kThreads, 0, stream>>>(G, decay, dh_last, H, P * S,
                                                  nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_bwd_kernel<T><<<chunks, kThreads, bwd_bytes, stream>>>(
      xt, dt, A, Bt, Ct, dyt, cb, states, h_last, G, static_cast<T*>(dx), ddt,
      dB_part, dC_part, dA_part, Tn, H, P, S, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(B) * Tn * S;
  const int blocks = static_cast<int>(
      n / 256 + 1 < 8192 ? n / 256 + 1 : 8192);
  scan_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      dB_part, dC_part, dA_part, static_cast<T*>(dBm), static_cast<T*>(dCm),
      dA, B, Tn, H, S, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (four kernels), allocates nothing, does not
// synchronise; the caller has run mamba_scan_states_launch (B8's passes
// 0-2) on the same inputs and chunk into `states`, `decay`, `cb` and
// `h_last`. `bf16` selects bfloat16 x, Bm, Cm, dy, dx, dBm and dCm (else
// float32); dt, A, dh_last (null for none), ddt, dA and the scratch are
// float32: `G` (B, H, n_chunks, P, S), `dB_part` and `dC_part` (B, H, T,
// S), `dA_part` (B, H, n_chunks), n_chunks = ceil(T / chunk). `chunk` is
// c <= 128 (the caller passes min(chunk, T) and T >= 1); the wrapper
// checks that the shared memory fits. Returns the first CUDA error of the
// launches (0 on success), or cudaErrorInvalidValue for a chunk above 128.
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dh_last, void* dx,
    void* ddt, void* dA, void* dBm, void* dCm, void* states, void* decay,
    void* cb, void* h_last, void* G, void* dB_part, void* dC_part,
    void* dA_part, int B, int T, int H, int P, int S, int chunk, int bf16,
    void* stream) {
  if (chunk < 1 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* dhf = static_cast<const float*>(dh_last);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  const float* st = static_cast<const float*>(states);
  const float* dec = static_cast<const float*>(decay);
  const float* cbf = static_cast<const float*>(cb);
  const float* hl = static_cast<const float*>(h_last);
  float* g = static_cast<float*>(G);
  float* pb = static_cast<float*>(dB_part);
  float* pc = static_cast<float*>(dC_part);
  float* pa = static_cast<float*>(dA_part);
  return bf16 ? launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, dy, dhf, dx, ddtf,
                                      dAf, dBm, dCm, st, dec, cbf, hl, g, pb,
                                      pc, pa, B, T, H, P, S, chunk, s)
              : launch<float>(x, dtf, Af, Bm, Cm, dy, dhf, dx, ddtf, dAf, dBm,
                              dCm, st, dec, cbf, hl, g, pb, pc, pa, B, T, H,
                              P, S, chunk, s);
}
