// B8: the chunked Mamba-2 / SSD scan (prefill of the SSM layers).
//
// Replaces the Pallas kernel src/repro/kernels/mamba_scan.py
// `mamba_scan_kernel_call` (body `_ssd_kernel`), reached through
// src/repro/kernels/ops.py `mamba_scan`; it computes what
// src/repro/models/ssm.py `chunked_ssd` computes for `mamba2_forward` (one
// shared B/C group, log decay dt * A, input scale dt). Per (batch, head)
// with the (P, S) state h carried over chunks of c steps:
//   L    = cumsum(dt * A) over the chunk
//   y    = (tril(exp(L_t - L_tau)) o (C B^T)) @ (dt o x) + exp(L) o (C h^T)
//   h   <- exp(L_c) h + ((dt o x) o exp(L_c - L_tau))^T @ B
// in float32, y written in x's type. The TPU kernel keeps the final state
// in VMEM scratch; here it is also written out, (B, H, P, S) float32,
// since `mamba2_forward` returns it.
//
// Layout: four launches, the split Mamba-2's SSD takes on GPUs. The TPU
// grid walks the chunks of a sequence in order; here only the state's
// recurrence does, and the products run with one block per (batch, head,
// chunk) (2,048 blocks at zamba2-1.2b's prefill, B 2, T 2048, 64 heads):
//   0. C B^T, grid (chunk, batch, 4 row blocks of 32): one chunk's C B^T,
//      the same for every head (one B/C group), into a float32 scratch
//      (B, n_chunks, 128, 128), transposed; beside it the chunk's C,
//      transposed, and B, both in float32 (2.1 + 1 + 1 MB at zamba2-1.2b's
//      prefill, so they stay in the 50 MB L2);
//   1. chunk state, grid (chunk, head, batch): L in order, W = exp(L_c -
//      L_tau), upd = (W o dt o x)^T @ B (P x S) into a float32 scratch
//      (B, H, n_chunks, P, S) and exp(L_c) into one of (B, H, n_chunks)
//      (33.5 MB there);
//   2. state passing, grid (P S / 256, head, batch): each thread walks one
//      state entry over the chunks in order, h <- exp(L_c) h + upd, writes
//      the state entering each chunk over that chunk's upd, and the final
//      state;
//   3. chunk scan, grid (chunk, head, batch): L again by the same chain,
//      then y from C B^T, the decay mask, dt o x and the entering state.
// The wrapper allocates the scratch; the launches allocate nothing and
// read nothing back, so a CUDA graph captures them.
// Every product keeps a register tile of outputs per thread and reads
// both operands as float4 rows of shared memory laid out k-major, so
// that a k step costs 2 or 3 shared loads for 16 or 32 fmaf: C B^T and
// upd 4 x 4, y 8 x 4 (rows x columns). A warp's lanes share rows and
// columns, so each load is one 128-byte wavefront. The chunk scan holds C
// transposed (S x 132 floats) and streams dt o x and M in strips of 32
// steps tau; the intra product adds each strip's terms as they come, so M
// is never whole in shared memory. What pass 0 wrote arrives by cp.async:
// C and B at a block's start, C B^T into two strip buffers one strip
// ahead (M is made from it in place, 4 rows t at a time); the next strip
// of x is loaded into registers as it is (bf16 or float) while the
// current one computes, and the entering state arrives by cp.async while
// the strips compute. Loads that fill shared memory step (row, column)
// without a division and keep 16 loads in flight a thread. Shared memory
// at c 128, P = S = 64: pass 0 42 KB, chunk state 65.5 KB (three blocks
// an SM), chunk scan 92.5 KB and 128 registers a thread (two blocks, 16
// warps, an SM; 512-thread blocks with 4 x 4 tiles, 32 warps, ran no
// faster). A chunk shorter than 128 steps (T < 128, or a smaller `chunk`)
// runs as rows masked to zero; a ragged last chunk is masked as the
// reference's zero padding in `ops.mamba_scan` acts: dt = 0 (decay 1) and
// x = B = C = 0 past T, and rows past T are not written.
//
// Order of arithmetic: the one-block-per-sequence kernel's, so the plain
// version in kernels/mamba_scan.py (cuBLAS's float32 GEMMs, which add each
// output's products in k order by FFMA) agrees to the last bit:
// - L is the running float32 sum of dt * A in step order (one thread;
//   `cumsum_in_order` in the plain version);
// - C B^T, the intra product, C h^T and upd are each one fmaf chain per
//   output in k order (s, tau, s, tau). The intra chain stops at the
//   tile's last row: the terms past the diagonal are fmaf(0, x, acc), which
//   leave acc as it is, so any tile may stop there or include them;
// - M = exp(L_t - L_tau) * (C B^T) where tau <= t, else 0; W o dt o x is
//   W * (dt * x); y = yi + exp(L_t) * (C h^T); h = exp(L_c) * h + upd.
// nvcc runs with --fmad=false, so no other product is contracted; expf
// is the accurate one.
//
// Bound on the H100. At zamba2-1.2b's prefill (B 2, T 2048, 64 heads of
// P = 64, S = 64, bf16) the scan must read 36 MB and write 36 MB (y and
// the final state) against about 8.6 GFLOP: bytes bound it, about 0.021
// ms. This design's own floor is higher: its 3.5 G float32 FMAs (C B^T
// once per chunk, not per head) are 0.105 ms at the 67 TFLOP/s of the SMs'
// float32 pipes, and the scratch adds about 140 MB of traffic (the states
// written, read and rewritten, read), 0.042 ms. The chunk scan, the
// largest pass (PERF.md has each pass's time), spends its time on the
// intra product, C h^T, M's exponentials and the barriers of its
// triangular strips, where the warps above a strip's rows wait. The
// products could move to the tensor cores only with a plain version that
// repeats their order and precision.
#include "lm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;          // c; the wrapper raises above it
constexpr int kStrip = 32;              // steps tau of M a strip holds
constexpr int kGroupP = 64;             // value columns a pass of the scan covers
constexpr int kLdT = kMaxChunk + 4;     // a [s][t] row: float4-aligned, rows 4 banks apart
constexpr int kLdStrip = kStrip + 4;    // a [s][tau] row of a strip
constexpr int kLdP = kGroupP + 4;       // a [s][p] row of the entering state
constexpr int kPrefetch = 8;            // chunks whose upd the state pass loads at once
// a strip's x, as many values a thread as it prefetches
constexpr int kStripX = kStrip * kGroupP / kThreads;

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Dynamic shared memory of each block, in floats; the wrapper's
// `scan_shared_bytes` computes the largest.
__host__ __device__ constexpr int state_smem_floats(int c, int P, int S) {
  return 3 * kMaxChunk + c * (round4(P) + round4(S));
}
__host__ __device__ constexpr int cb_smem_floats(int S) {
  return S * kLdStrip + S * kLdT;
}
__host__ __device__ constexpr int scan_smem_floats(int S) {
  return 3 * kMaxChunk + S * kLdT + kStrip * kGroupP + 2 * kStrip * kLdT +
         S * kLdP;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One float copied from device to shared memory without a register: the
// entering state and C B^T arrive while the strips compute.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
// 16 bytes the same way (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The (row, column) of flat index threadIdx.x + u * kThreads over rows of
// w columns, stepped in u without a division.
struct Walk {
  int r, col, w, dr, dc;
  __device__ __forceinline__ explicit Walk(int width) : w(width) {
    r = threadIdx.x / w;
    col = threadIdx.x - r * w;
    dr = kThreads / w;
    dc = kThreads - dr * w;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    col += dc;
    if (col >= w) {
      col -= w;
      ++r;
    }
  }
};

// v[u] = *at(row, col) for this thread's u-th element of a rows x w array,
// 0 where `at` gives null or past the last row: kPer loads in flight a
// thread. The values stay as loaded (bf16 or float) and nothing here reads
// them, so a prefetch does not wait for its loads; `scatter` converts and
// puts them.
template <int kPer, typename V, typename At>
__device__ __forceinline__ void gather(V (&v)[kPer], Walk it, int rows, At at) {
#pragma unroll
  for (int u = 0; u < kPer; ++u, it.next()) {
    v[u] = cato::from_float<V>(0.f);
    const V* q = it.r < rows ? at(it.r, it.col) : nullptr;
    if (q != nullptr) v[u] = *q;
  }
}
template <int kPer, typename V, typename Put>
__device__ __forceinline__ void scatter(const V (&v)[kPer], Walk it, int rows,
                                        Put put) {
#pragma unroll
  for (int u = 0; u < kPer; ++u, it.next())
    if (it.r < rows) put(it.r, it.col, cato::to_float(v[u]));
}
// put(r, col, *at(r, col)) over a rows x w array, kPer loads in flight a
// thread.
template <int kPer, typename V, typename At, typename Put>
__device__ __forceinline__ void stage(int rows, int w, At at, Put put) {
  for (Walk it(w); it.r < rows;) {
    V v[kPer];
    gather<kPer>(v, it, rows, at);
    scatter<kPer>(v, it, rows, put);
    for (int u = 0; u < kPer; ++u) it.next();
  }
}

// acc[i][j] = fmaf(a[i], b[j], acc[i][j]) for an R x 4 tile, a in 4-row
// pieces: one k step of a register-tiled product.
template <int R>
__device__ __forceinline__ void fma_tile(float (&acc)[R][4], const float4 (&a)[R / 4],
                                         const float4 b) {
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float av[4] = {a[q].x, a[q].y, a[q].z, a[q].w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[4 * q + i][j] = fmaf(av[i], bv[j], acc[4 * q + i][j]);
  }
}

// L over n steps: the running float32 sum of dt * a, in order.
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

// 1. chunk state: upd = (W o dt o x)^T @ B and exp(L_c) of one chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(
    const T* __restrict__ x,        // (B, T, H, P)
    const float* __restrict__ dt,   // (B, T, H)
    const float* __restrict__ A,    // (H,)
    const float* __restrict__ bt,   // (B, n_chunks, 128, round4(S)): B
    float* __restrict__ states,     // (B, H, n_chunks, P, S): upd out
    float* __restrict__ decay,      // (B, H, n_chunks): exp(L_c) out
    int Tn, int H, int P, int S, int c) {
  extern __shared__ __align__(16) float smem[];
  const int P4 = round4(P), S4 = round4(S);
  float* sDT = smem;              // c      dt
  float* sL = sDT + kMaxChunk;    // c      L
  float* sW = sL + kMaxChunk;     // c      exp(L_c - L_tau)
  float* sX = sW + kMaxChunk;     // c x P4 x, then W o dt o x
  float* sB = sX + c * P4;        // c x S4
  const int ic = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int t0 = ic * c;
  const size_t row0 = static_cast<size_t>(b) * Tn + t0;
  const int nv = min(c, Tn - t0);   // steps of the chunk inside T
  const T* xc = x + (row0 * H + h) * P;
  const float* btc = bt + (static_cast<size_t>(b) * nc + ic) * kMaxChunk * S4;
  for (Walk it(S4 / 4); it.r < c; it.next())   // B, while x loads
    cp_async16(sB + it.r * S4 + 4 * it.col, btc + it.r * S4 + 4 * it.col);
  cp_async_commit();
  const float a = A[h];
  if (tid < c) sDT[tid] = tid < nv ? dt[(row0 + tid) * H + h] : 0.f;
  stage<16, T>(c, P4, [&](int r, int p) {
    return p < P && r < nv ? xc + r * H * P + p : nullptr;
  }, [&](int r, int p, float v) { sX[r * P4 + p] = v; });
  cp_async_wait<0>();
  __syncthreads();
  if (tid == 0) log_decay_in_order(sDT, a, c, sL);
  __syncthreads();
  for (int r = tid; r < c; r += kThreads) sW[r] = expf(sL[c - 1] - sL[r]);
  __syncthreads();
  for (Walk it(P4); it.r < c; it.next()) {
    float& v = sX[it.r * P4 + it.col];
    v = sW[it.r] * (sDT[it.r] * v);
  }
  __syncthreads();

  const size_t bhc = (static_cast<size_t>(b) * H + h) * nc + ic;
  float* out = states + bhc * P * S;
  const int s_tiles = S4 / 4, n_tiles = (P4 / 4) * s_tiles;
  for (int tile = tid; tile < n_tiles; tile += kThreads) {
    const int p0 = 4 * (tile / s_tiles), s0 = 4 * (tile % s_tiles);
    float acc[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < c; ++k) {
      const float4 a[1] = {ld4(sX + k * P4 + p0)};
      fma_tile<4>(acc, a, ld4(sB + k * S4 + s0));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (p0 + i >= P) break;
      float* o = out + static_cast<size_t>(p0 + i) * S + s0;
      if (S4 == S) {   // rows of S floats stay 16-byte aligned
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (s0 + j < S) o[j] = acc[i][j];
      }
    }
  }
  if (tid == 0) decay[bhc] = expf(sL[c - 1]);
}

// 2. state passing: the state entering each chunk, over that chunk's upd,
// and the final state.
__global__ void __launch_bounds__(kThreads) state_pass_kernel(
    float* __restrict__ states,       // (B, H, n_chunks, P, S)
    const float* __restrict__ decay,  // (B, H, n_chunks)
    float* __restrict__ h_last,       // (B, H, P, S)
    int H, int PS, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PS) return;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  float* st = states + bh * nc * PS + e;
  const float* dec = decay + bh * nc;
  float hv = 0.f;
  for (int k0 = 0; k0 < nc; k0 += kPrefetch) {
    float u[kPrefetch];
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i)
      if (k0 + i < nc) u[i] = st[static_cast<size_t>(k0 + i) * PS];
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      if (k0 + i < nc) {
        st[static_cast<size_t>(k0 + i) * PS] = hv;
        hv = dec[k0 + i] * hv + u[i];
      }
    }
  }
  h_last[bh * PS + e] = hv;
}

// 0. C B^T of one chunk, shared by every head: rows [32 rb, 32 rb + 32)
// against steps [0, 32 rb + 32), written transposed, cb[b][chunk][tau][t];
// and those rows of C, transposed and in float32, ct[b][chunk][s][t], and
// of B in float32, bt[b][chunk][t][s], rows padded with 0 to 4 floats.
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_cb_kernel(
    const T* __restrict__ Bm,   // (B, T, S)
    const T* __restrict__ Cm,   // (B, T, S)
    float* __restrict__ cb,     // (B, n_chunks, 128, 128): C B^T out
    float* __restrict__ ct,     // (B, n_chunks, S, 128): C^T out
    float* __restrict__ bt,     // (B, n_chunks, 128, round4(S)): B out
    int Tn, int S, int c) {
  extern __shared__ __align__(16) float smem[];
  float* sCt = smem;                 // S x kLdStrip  the block's C rows^T
  float* sBt = sCt + S * kLdStrip;   // S x kLdT      B^T up to its last row
  const int ic = blockIdx.x, b = blockIdx.y, t_lo = blockIdx.z * kStrip;
  if (t_lo >= c) return;   // padding rows: nothing reads them
  const int nc = gridDim.x, tid = threadIdx.x;
  const int t0 = ic * c, nv = min(c, Tn - t0);
  const int n_tau = t_lo + kStrip;
  const size_t row0 = static_cast<size_t>(b) * Tn + t0;
  const T* Bc = Bm + row0 * S;
  const T* Cc = Cm + row0 * S;
  stage<8, T>(kStrip, S, [&](int r, int s) {
    return t_lo + r < nv ? Cc + (t_lo + r) * S + s : nullptr;
  }, [&](int r, int s, float v) { sCt[s * kLdStrip + r] = v; });
  stage<16, T>(n_tau, S, [&](int r, int s) {
    return r < nv ? Bc + r * S + s : nullptr;
  }, [&](int r, int s, float v) { sBt[s * kLdT + r] = v; });
  __syncthreads();
  float* cto = ct + (static_cast<size_t>(b) * nc + ic) * S * kMaxChunk + t_lo;
  for (Walk it(kStrip / 4); it.r < S; it.next())
    *reinterpret_cast<float4*>(cto + it.r * kMaxChunk + 4 * it.col) =
        ld4(sCt + it.r * kLdStrip + 4 * it.col);
  const int S4 = round4(S);
  float* bto = bt + ((static_cast<size_t>(b) * nc + ic) * kMaxChunk + t_lo) * S4;
  for (Walk it(S4); it.r < kStrip; it.next())
    bto[it.r * S4 + it.col] = it.col < S ? sBt[it.col * kLdT + t_lo + it.r] : 0.f;
  // 4 rows x 4 steps a thread; a warp holds 8 row tiles x 4 step tiles
  float* out = cb + (static_cast<size_t>(b) * nc + ic) * kMaxChunk * kMaxChunk;
  const int n_tiles = 8 * (n_tau / 4);
  for (int tile = tid; tile < n_tiles; tile += kThreads) {
    const int r0 = 4 * (tile % 8), k0 = 4 * (tile / 8);
    float acc[4][4] = {};
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const float4 a[1] = {ld4(sCt + s * kLdStrip + r0)};
      fma_tile<4>(acc, a, ld4(sBt + s * kLdT + k0));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(out + (k0 + j) * kMaxChunk + t_lo + r0) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
  }
}

// 3. chunk scan: y of one chunk from its entering state and C B^T.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) chunk_scan_kernel(
    const T* __restrict__ x,            // (B, T, H, P)
    const float* __restrict__ dt,       // (B, T, H)
    const float* __restrict__ A,        // (H,)
    const float* __restrict__ cb,       // (B, n_chunks, 128, 128): C B^T, transposed
    const float* __restrict__ ct,       // (B, n_chunks, S, 128): C^T
    const float* __restrict__ states,   // (B, H, n_chunks, P, S): entering
    T* __restrict__ y,                  // (B, T, H, P)
    int Tn, int H, int P, int S, int c) {
  extern __shared__ __align__(16) float smem[];
  float* sDT = smem;                    // 128      dt, 0 past the chunk
  float* sL = sDT + kMaxChunk;          // 128      L
  float* sEL = sL + kMaxChunk;          // 128      exp(L_t)
  float* sCt = sEL + kMaxChunk;         // S x kLdT C, transposed
  float* sDX = sCt + S * kLdT;          // kStrip x kGroupP   a strip's dt o x
  float* sM = sDX + kStrip * kGroupP;   // 2 x kStrip x kLdT  two strips' M^T
  float* sHt = sM + 2 * kStrip * kLdT;  // S x kLdP  the entering state^T
  const int ic = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int t0 = ic * c;
  const size_t row0 = static_cast<size_t>(b) * Tn + t0;
  const int nv = min(c, Tn - t0);   // steps of the chunk inside T
  const T* xc = x + (row0 * H + h) * P;
  const float* cbc = cb + (static_cast<size_t>(b) * nc + ic) * kMaxChunk * kMaxChunk;
  const float* ctc = ct + (static_cast<size_t>(b) * nc + ic) * S * kMaxChunk;
  const float* st = states + ((static_cast<size_t>(b) * H + h) * nc + ic) * P * S;

  const int n_strips = (c + kStrip - 1) / kStrip;
  const int rows = n_strips * kStrip;   // rows past it are padding
  const int n_groups = (P + kGroupP - 1) / kGroupP;
  // strip q (of every group's strips, in order) of C B^T, the rows
  // [tau0, rows) of its steps, into buffer q % 2 by cp.async
  auto copy_cb = [&](int q) {
    const int tau0 = (q % n_strips) * kStrip;
    float* dst = sM + (q % 2) * kStrip * kLdT + tau0;
    for (Walk it((rows - tau0) / 4); it.r < kStrip; it.next())
      cp_async16(dst + it.r * kLdT + 4 * it.col,
                 cbc + (tau0 + it.r) * kMaxChunk + tau0 + 4 * it.col);
    cp_async_commit();
  };
  // strip j of x for column group pg, in registers, loaded while the
  // strip before it computes
  const Walk walk_x(kGroupP);
  T rx[kStripX];
  auto load_x = [&](int pg, int j) {
    const int tau0 = j * kStrip, pw = min(kGroupP, P - pg);
    gather<kStripX>(rx, walk_x, kStrip, [&](int r, int p) {
      return p < pw && tau0 + r < nv ? xc + (tau0 + r) * H * P + pg + p : nullptr;
    });
  };
  // the group's entering state, transposed, by cp.async
  const Walk walk_s(S);
  auto copy_state = [&](int pg, int pw) {
    for (Walk it = walk_s; it.r < kGroupP; it.next()) {
      float* dst = sHt + it.col * kLdP + it.r;
      if (it.r < pw) cp_async4(dst, st + (pg + it.r) * S + it.col);
      else *dst = 0.f;
    }
  };
  copy_state(0, min(kGroupP, P));
  for (Walk it(rows / 4); it.r < S; it.next())   // C^T, read by C h^T alone
    cp_async16(sCt + it.r * kLdT + 4 * it.col, ctc + it.r * kMaxChunk + 4 * it.col);
  copy_cb(0);
  load_x(0, 0);
  const float a = A[h];
  if (tid < kMaxChunk) sDT[tid] = tid < nv ? dt[(row0 + tid) * H + h] : 0.f;
  __syncthreads();
  // the steps past c add dt = 0: L stays at L_{c-1} there
  if (tid == 0) log_decay_in_order(sDT, a, kMaxChunk, sL);
  __syncthreads();
  for (int r = tid; r < kMaxChunk; r += kThreads) sEL[r] = expf(sL[r]);

  // this thread's y tile, rows [ty0, ty0 + 8) x columns [py0, py0 + 4) of
  // a group: a warp holds 4 row tiles x 8 column tiles, rows of one strip
  const int ty0 = 8 * (4 * (warp >> 1) + (lane >> 3));
  const int py0 = 4 * (8 * (warp & 1) + (lane & 7));

  for (int g = 0; g < n_groups; ++g) {
    const int pg = g * kGroupP, pw = min(kGroupP, P - pg);
    const bool owns_y = ty0 < rows && py0 < pw;
    if (g > 0) {
      __syncthreads();   // the group before's readers of sHt are done
      copy_state(pg, pw);
    }
    float yi[8][4] = {};
    for (int j = 0; j < n_strips; ++j) {
      const int q = g * n_strips + j, tau0 = j * kStrip;
      float* sMq = sM + (q % 2) * kStrip * kLdT;
      __syncthreads();   // the strip before's readers are done
      scatter<kStripX>(rx, walk_x, kStrip, [&](int r, int p, float v) {
        sDX[r * kGroupP + p] = sDT[tau0 + r] * v;
      });
      if (q + 1 < n_groups * n_strips) {
        copy_cb(q + 1);
        cp_async_wait<1>();   // all but the strip just asked for
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (j + 1 < n_strips) load_x(pg, j + 1);
      else if (g + 1 < n_groups) load_x(pg + kGroupP, 0);
      // M = exp(L_t - L_tau) C B^T where tau <= t, else 0, in place, for
      // rows [tau0, rows), 4 rows t at a time: the rows above see no step
      // of this strip
      for (Walk it((rows - tau0) / 4); it.r < kStrip; it.next()) {
        const int tau = tau0 + it.r, t = tau0 + 4 * it.col;
        float4* mp = reinterpret_cast<float4*>(sMq + it.r * kLdT + t);
        float m[4] = {mp->x, mp->y, mp->z, mp->w};
        const float4 lt4 = ld4(sL + t);
        const float lt[4] = {lt4.x, lt4.y, lt4.z, lt4.w}, lu = sL[tau];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          m[i] = tau <= t + i ? expf(lt[i] - lu) * m[i] : 0.f;
        *mp = make_float4(m[0], m[1], m[2], m[3]);
      }
      __syncthreads();
      // the intra product, the strip's steps up to the tile's last row
      const int kn = min(kStrip, ty0 + 8 - tau0);
      if (owns_y) {
#pragma unroll 4
        for (int k = 0; k < kn; ++k) {
          const float4 a[2] = {ld4(sMq + k * kLdT + ty0),
                               ld4(sMq + k * kLdT + ty0 + 4)};
          fma_tile<8>(yi, a, ld4(sDX + k * kGroupP + py0));
        }
      }
    }
    // C h^T of the entering state, and y
    cp_async_wait<0>();
    __syncthreads();   // every thread's copies have landed
    if (owns_y) {
      float ch[8][4] = {};
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const float4 a[2] = {ld4(sCt + s * kLdT + ty0),
                             ld4(sCt + s * kLdT + ty0 + 4)};
        fma_tile<8>(ch, a, ld4(sHt + s * kLdP + py0));
      }
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int t = ty0 + ii;
        if (t >= nv) continue;
        T* yr = y + ((row0 + t) * H + h) * P + pg;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (py0 + jj < pw)
            yr[py0 + jj] = cato::from_float<T>(yi[ii][jj] + sEL[t] * ch[ii][jj]);
      }
    }
  }
}

// passes 0-2: C B^T, each chunk's state update and the state pass (B8b
// runs these too, for the states entering each chunk)
template <typename T>
int launch_states(const void* x, const float* dt, const float* A,
                  const void* Bm, const void* Cm, float* h_last, float* states,
                  float* decay, float* cb, float* ct, float* bt, int B,
                  int Tn, int H, int P, int S, int c, cudaStream_t stream) {
  const int nc = (Tn + c - 1) / c;
  const size_t cb_bytes = sizeof(float) * cb_smem_floats(S);
  const size_t state_bytes = sizeof(float) * state_smem_floats(c, P, S);
  cudaError_t err = cato::allow_shared_memory(chunk_cb_kernel<T>, cb_bytes);
  if (err == cudaSuccess)
    err = cato::allow_shared_memory(chunk_state_kernel<T>, state_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_cb_kernel<T><<<dim3(nc, B, kMaxChunk / kStrip), kThreads, cb_bytes,
                       stream>>>(static_cast<const T*>(Bm),
                                 static_cast<const T*>(Cm), cb, ct, bt, Tn,
                                 S, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_state_kernel<T><<<dim3(nc, H, B), kThreads, state_bytes, stream>>>(
      static_cast<const T*>(x), dt, A, bt, states, decay, Tn, H, P, S, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  state_pass_kernel<<<dim3((P * S + kThreads - 1) / kThreads, H, B), kThreads,
                      0, stream>>>(states, decay, h_last, H, P * S, nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* h_last, float* states,
           float* decay, float* cb, float* ct, float* bt, int B, int Tn,
           int H, int P, int S, int c, cudaStream_t stream) {
  const int nc = (Tn + c - 1) / c;
  const size_t scan_bytes = sizeof(float) * scan_smem_floats(S);
  cudaError_t err = cato::allow_shared_memory(chunk_scan_kernel<T>, scan_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int st = launch_states<T>(x, dt, A, Bm, Cm, h_last, states, decay,
                                  cb, ct, bt, B, Tn, H, P, S, c, stream);
  if (st != 0) return st;
  chunk_scan_kernel<T><<<dim3(nc, H, B), kThreads, scan_bytes, stream>>>(
      static_cast<const T*>(x), dt, A, cb, ct, states, static_cast<T*>(y),
      Tn, H, P, S, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise, reads
// nothing back (a CUDA graph captures it). `bf16` selects bfloat16 x, Bm,
// Cm and y (else float32); dt, A, h_last and the scratch are float32:
// `states` (B, H, n_chunks, P, S), `decay` (B, H, n_chunks), `cb`
// (B, n_chunks, 128, 128), `ct` (B, n_chunks, S, 128) and `bt`
// (B, n_chunks, 128, S rounded up to 4), n_chunks = ceil(T / chunk). `chunk` is the
// chunk length c <= 128 (the caller passes min(chunk, T) and T >= 1); the
// wrapper checks that the shared memory fits. Returns the first CUDA error
// of the four launches (0 on success).
extern "C" int mamba_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, void* h_last, void* states, void* decay,
    void* cb, void* ct, void* bt, int B, int T, int H, int P, int S,
    int chunk, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* hf = static_cast<float*>(h_last);
  float* sf = static_cast<float*>(states);
  float* df = static_cast<float*>(decay);
  float* cf = static_cast<float*>(cb);
  float* tf = static_cast<float*>(ct);
  float* bf = static_cast<float*>(bt);
  return bf16 ? launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, hf, sf, df, cf,
                                      tf, bf, B, T, H, P, S, chunk, s)
              : launch<float>(x, dtf, Af, Bm, Cm, y, hf, sf, df, cf, tf, bf,
                              B, T, H, P, S, chunk, s);
}

// B8's passes 0-2 alone, for B8b: the same launches and arguments as
// mamba_scan_launch's first three, so the same bits (each chunk's
// entering state in `states`, the final state in h_last). Returns the
// first CUDA error of the three launches (0 on success).
extern "C" int mamba_scan_states_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* h_last, void* states, void* decay, void* cb,
    void* ct, void* bt, int B, int T, int H, int P, int S, int chunk,
    int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* hf = static_cast<float*>(h_last);
  float* sf = static_cast<float*>(states);
  float* df = static_cast<float*>(decay);
  float* cf = static_cast<float*>(cb);
  float* tf = static_cast<float*>(ct);
  float* bf = static_cast<float*>(bt);
  return bf16 ? launch_states<__nv_bfloat16>(x, dtf, Af, Bm, Cm, hf, sf, df,
                                             cf, tf, bf, B, T, H, P, S,
                                             chunk, s)
              : launch_states<float>(x, dtf, Af, Bm, Cm, hf, sf, df, cf, tf,
                                     bf, B, T, H, P, S, chunk, s);
}
