// B8b: the gradient of B8 (the Mamba-2 / SSD scan): dx, ddt, dA, dBm and
// dCm from dy and the final state's gradient dh_last.
//
// Replaces no Pallas kernel: the reference has no backward kernel (no
// `custom_vjp` around src/repro/kernels/mamba_scan.py), and trains through
// XLA's autodiff of `chunked_ssd` (src/repro/models/ssm.py). B8 computes
//   h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) (x) B_t,   y_t = h_t C_t
// per (batch, head), with x_t (P,), B_t and C_t (S,) shared by the heads and
// h (P, S). Each of the P rows of h is its own recurrence over the S
// columns, so this works row by row, on the step recurrence (the same
// function as the chunked form). With g_t = dL/dh_t and gc the part of it
// from later steps (dh_last at the end), from t = T - 1 down:
//   g   = gc + dy_t[p] C_t            dC_t += dy_t[p] h_t       (rows)
//   dB_t += g (dt_t x_t[p])           dX = g . B_t,  dx_t = dX dt_t
//   da  += g . (exp(dt_t A) h_{t-1})  ddt_t = sum_p x_t[p] dX + da A
//   dA  += da dt_t                    gc = exp(dt_t A) g
// and dBm, dCm add the heads, dA the batch.
//
// One block of 16 warps per (head, batch), a lane holding state columns s
// and s + 32 of a row (S <= 64), a warp one row at a time: a head's P rows
// (a multiple of 16, up to 64) in P / 16 passes of 16 rows. The block
// stages each segment of kSeg = 16 steps (dt, x, dy, B, C) in shared
// memory. A forward pass over all T keeps each row's state in registers and
// writes it at every segment start (the checkpoints, scratch in device
// memory); the reverse pass walks the segments from the last, recomputes
// the segment's 16 states of a row from its checkpoint into registers, and
// steps back through them. A row's sums over its columns are the warp's
// xor butterfly; the sums over rows go through shared memory: each pass's
// 16 rows halved (r and r + 8, then + 4, + 2, + 1), the passes added in
// order. ddt is written per (batch, step, head); dBm's, dCm's and dA's
// per-head parts go to scratch, and a second launch adds the heads (dBm,
// dCm) and the batch (dA) in order. No atomics: every run gives the same
// bits.
//
// Order of arithmetic. `mamba_scan_bwd_plain` (kernels/mamba_scan.py)
// repeats every step with torch ops: each product rounded, then each sum,
// in the order above (`_lane_sum_s` for the butterfly, `_row_sum` for the
// rows). A change of either side's order changes the other.
//
// Bound on the H100. At zamba2-1.2b's training shape (B 2, T 4096, 64
// heads of P 64, S 64) the gradient reads x, dy (bf16), dt, B and C once
// and writes dx, ddt, dB and dC once: about 0.27 GB, 0.08 ms at 3.35
// TB/s; its float32 work (about 14 operations per state element and step,
// 3 x 10^10 in all) would take 0.45 ms at 67 TFLOP/s. This first design
// runs 128 blocks, one per SM, each a sequential walk over T with two
// butterflies a row and step: latency, not either bound, sets its time
// (PERF.md).
//
// Built with --fmad=false like every source here: each product and sum
// rounds on its own, as in the plain version.
#include <stdint.h>

#include "lm_common.cuh"

namespace {

constexpr int kSeg = 16;          // steps a checkpoint covers (BWD_SEGMENT)
constexpr int kWarps = 16;        // rows a pass
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPasses = 4;     // P <= 64
constexpr int kMaxP = kWarps * kMaxPasses;
constexpr int kMaxSp = 64;

// shared memory, in floats
constexpr int kOffDt = 0;
constexpr int kOffDecay = kOffDt + kSeg;
constexpr int kOffX = kOffDecay + kSeg;                  // (kSeg, P)
constexpr int kOffDy = kOffX + kSeg * kMaxP;             // (kSeg, P)
constexpr int kOffB = kOffDy + kSeg * kMaxP;             // (kSeg, Sp)
constexpr int kOffC = kOffB + kSeg * kMaxSp;             // (kSeg, Sp)
constexpr int kOffContC = kOffC + kSeg * kMaxSp;         // (warp, kSeg, Sp)
constexpr int kOffContB = kOffContC + kWarps * kSeg * kMaxSp;
constexpr int kOffRowX = kOffContB + kWarps * kSeg * kMaxSp;   // (warp, kSeg)
constexpr int kOffRowA = kOffRowX + kWarps * kSeg;
constexpr int kOffAccC = kOffRowA + kWarps * kSeg;       // (kSeg, Sp)
constexpr int kOffAccB = kOffAccC + kSeg * kMaxSp;
constexpr int kOffAccX = kOffAccB + kSeg * kMaxSp;       // (kSeg,)
constexpr int kOffAccA = kOffAccX + kSeg;
constexpr int kSharedFloats = kOffAccA + kSeg;
constexpr size_t kSharedBytes = sizeof(float) * kSharedFloats;

// 16 values, halved: v[r] + v[r + 8], then + 4, + 2, + 1 (`_row_sum`)
__device__ __forceinline__ float halve16(float* v) {
#pragma unroll
  for (int w = 8; w >= 1; w >>= 1)
#pragma unroll
    for (int r = 0; r < w; ++r) v[r] = v[r] + v[r + w];
  return v[0];
}

template <typename T, int kSL>
__global__ void __launch_bounds__(kThreads, 1) scan_bwd_kernel(
    const T* __restrict__ x,        // (B, T, H, P)
    const float* __restrict__ dt,   // (B, T, H)
    const float* __restrict__ A,    // (H,)
    const T* __restrict__ Bm,       // (B, T, S)
    const T* __restrict__ Cm,       // (B, T, S)
    const T* __restrict__ dy,       // (B, T, H, P)
    const float* __restrict__ dh_last,   // (B, H, P, S) or null
    T* __restrict__ dx,             // (B, T, H, P)
    float* __restrict__ ddt,        // (B, T, H)
    float* __restrict__ ckpt,       // (B, H, n_seg, P, Sp)
    float* __restrict__ dB_part,    // (B, H, T, Sp)
    float* __restrict__ dC_part,    // (B, H, T, Sp)
    float* __restrict__ dA_part,    // (B, H)
    int Tn, int H, int P, int S) {
  constexpr int Sp = 32 * kSL;
  extern __shared__ float sm[];
  float* sDt = sm + kOffDt;
  float* sDecay = sm + kOffDecay;
  float* sX = sm + kOffX;
  float* sDy = sm + kOffDy;
  float* sB = sm + kOffB;
  float* sC = sm + kOffC;
  float* contC = sm + kOffContC;
  float* contB = sm + kOffContB;
  float* rowX = sm + kOffRowX;
  float* rowA = sm + kOffRowA;
  float* accC = sm + kOffAccC;
  float* accB = sm + kOffAccB;
  float* accX = sm + kOffAccX;
  float* accA = sm + kOffAccA;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_pass = P / kWarps;
  const int n_seg = (Tn + kSeg - 1) / kSeg;
  const float a = A[h];
  float* ck = ckpt + (static_cast<size_t>(b) * H + h) * n_seg * P * Sp;

  // stage steps [t0, t0 + kSeg) of this (batch, head); zeros past T
  auto stage = [&](int t0) {
    for (int i = tid; i < kSeg * P; i += kThreads) {
      const int st = i / P, p = i - st * P, t = t0 + st;
      const size_t g = ((static_cast<size_t>(b) * Tn + t) * H + h) * P + p;
      sX[st * P + p] = t < Tn ? cato::to_float(x[g]) : 0.f;
      sDy[st * P + p] = t < Tn ? cato::to_float(dy[g]) : 0.f;
    }
    for (int i = tid; i < kSeg * Sp; i += kThreads) {
      const int st = i / Sp, s = i - st * Sp, t = t0 + st;
      const bool in = t < Tn && s < S;
      const size_t g = (static_cast<size_t>(b) * Tn + t) * S + s;
      sB[i] = in ? cato::to_float(Bm[g]) : 0.f;
      sC[i] = in ? cato::to_float(Cm[g]) : 0.f;
    }
    if (tid < kSeg) {
      const int t = t0 + tid;
      const float d =
          t < Tn ? dt[(static_cast<size_t>(b) * Tn + t) * H + h] : 0.f;
      sDt[tid] = d;
      sDecay[tid] = expf(d * a);
    }
  };

  // forward: each row's state, written at every segment start
  float carry[kMaxPasses][kSL];
#pragma unroll
  for (int i = 0; i < kMaxPasses; ++i)
#pragma unroll
    for (int j = 0; j < kSL; ++j) carry[i][j] = 0.f;
  for (int seg = 0; seg < n_seg; ++seg) {
    const int t0 = seg * kSeg;
    const int n_st = min(kSeg, Tn - t0);
    __syncthreads();
    stage(t0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPasses; ++i) {
      if (i >= n_pass) break;
      const int p = warp + kWarps * i;
      float* row = ck + (static_cast<size_t>(seg) * P + p) * Sp;
#pragma unroll
      for (int j = 0; j < kSL; ++j) row[lane + 32 * j] = carry[i][j];
#pragma unroll
      for (int st = 0; st < kSeg; ++st) {
        if (st < n_st) {
          const float u = sDt[st] * sX[st * P + p];
#pragma unroll
          for (int j = 0; j < kSL; ++j)
            carry[i][j] = sDecay[st] * carry[i][j] +
                          u * sB[st * Sp + lane + 32 * j];
        }
      }
    }
  }

  // reverse: gc starts at dh_last
#pragma unroll
  for (int i = 0; i < kMaxPasses; ++i) {
    const int p = warp + kWarps * i;
#pragma unroll
    for (int j = 0; j < kSL; ++j) {
      const int s = lane + 32 * j;
      carry[i][j] =
          i < n_pass && dh_last != nullptr && s < S
              ? dh_last[((static_cast<size_t>(b) * H + h) * P + p) * S + s]
              : 0.f;
    }
  }
  float dA_acc = 0.f;
  for (int seg = n_seg - 1; seg >= 0; --seg) {
    const int t0 = seg * kSeg;
    const int n_st = min(kSeg, Tn - t0);
    __syncthreads();
    stage(t0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPasses; ++i) {
      if (i >= n_pass) break;
      const int p = warp + kWarps * i;
      // the segment's states of row p: hh[st + 1] after step t0 + st
      float hh[kSeg + 1][kSL];
      const float* row = ck + (static_cast<size_t>(seg) * P + p) * Sp;
#pragma unroll
      for (int j = 0; j < kSL; ++j) hh[0][j] = row[lane + 32 * j];
#pragma unroll
      for (int st = 0; st < kSeg; ++st) {
        if (st < n_st) {
          const float u = sDt[st] * sX[st * P + p];
#pragma unroll
          for (int j = 0; j < kSL; ++j)
            hh[st + 1][j] = sDecay[st] * hh[st][j] +
                            u * sB[st * Sp + lane + 32 * j];
        }
      }
#pragma unroll
      for (int st = kSeg - 1; st >= 0; --st) {
        if (st < n_st) {
          const float dyv = sDy[st * P + p];
          const float xv = sX[st * P + p];
          const float u = sDt[st] * xv;
          const float decay = sDecay[st];
          float g[kSL];
          float part_x = 0.f, part_a = 0.f;
#pragma unroll
          for (int j = 0; j < kSL; ++j) {
            const int s = lane + 32 * j;
            g[j] = carry[i][j] + dyv * sC[st * Sp + s];
            contC[(warp * kSeg + st) * Sp + s] = dyv * hh[st + 1][j];
            contB[(warp * kSeg + st) * Sp + s] = g[j] * u;
            const float tx = g[j] * sB[st * Sp + s];
            const float ta = g[j] * (decay * hh[st][j]);
            part_x = j == 0 ? tx : part_x + tx;
            part_a = j == 0 ? ta : part_a + ta;
          }
          const float dX = cato::warp_sum(part_x);
          const float da = cato::warp_sum(part_a);
          if (lane == 0) {
            dx[((static_cast<size_t>(b) * Tn + t0 + st) * H + h) * P + p] =
                cato::from_float<T>(dX * sDt[st]);
            rowX[warp * kSeg + st] = xv * dX;
            rowA[warp * kSeg + st] = da;
          }
#pragma unroll
          for (int j = 0; j < kSL; ++j) carry[i][j] = decay * g[j];
        }
      }
      __syncthreads();
      // this pass's 16 rows, halved, added to the passes before it
      for (int idx = tid; idx < 2 * kSeg * Sp; idx += kThreads) {
        const int which = idx / (kSeg * Sp), e = idx - which * kSeg * Sp;
        const float* cont = which ? contB : contC;
        float* acc = which ? accB : accC;
        float v[kWarps];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v[w] = cont[w * kSeg * Sp + e];
        const float r = halve16(v);
        acc[e] = (i == 0 ? 0.f : acc[e]) + r;
      }
      if (tid < 2 * kSeg) {
        const int which = tid / kSeg, st = tid - which * kSeg;
        const float* rows = which ? rowA : rowX;
        float* acc = which ? accA : accX;
        float v[kWarps];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v[w] = rows[w * kSeg + st];
        const float r = halve16(v);
        acc[st] = (i == 0 ? 0.f : acc[st]) + r;
      }
      __syncthreads();
    }
    // the segment's per-head parts, ddt and dA
    const size_t base = (static_cast<size_t>(b) * H + h) * Tn + t0;
    for (int e = tid; e < n_st * Sp; e += kThreads) {
      dB_part[base * Sp + e] = accB[e];
      dC_part[base * Sp + e] = accC[e];
    }
    if (tid < n_st)
      ddt[(static_cast<size_t>(b) * Tn + t0 + tid) * H + h] =
          accX[tid] + accA[tid] * a;
    if (tid == 0)
      for (int st = n_st - 1; st >= 0; --st)
        dA_acc = dA_acc + accA[st] * sDt[st];
  }
  if (tid == 0) dA_part[static_cast<size_t>(b) * H + h] = dA_acc;
}

// dBm and dCm: the heads' parts added in order; dA: the batch's in order
template <typename T>
__global__ void scan_bwd_reduce_kernel(
    const float* __restrict__ dB_part, const float* __restrict__ dC_part,
    const float* __restrict__ dA_part, T* __restrict__ dBm,
    T* __restrict__ dCm, float* __restrict__ dA, int B, int Tn, int H,
    int S, int Sp) {
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
      const size_t g =
          ((static_cast<size_t>(bi) * H + hh) * Tn + t) * Sp + s;
      ab = ab + dB_part[g];
      ac = ac + dC_part[g];
    }
    dBm[idx] = cato::from_float<T>(ab);
    dCm[idx] = cato::from_float<T>(ac);
  }
  if (blockIdx.x == 0)
    for (int hh = threadIdx.x; hh < H; hh += blockDim.x) {
      float acc = 0.f;
      for (int bi = 0; bi < B; ++bi) acc = acc + dA_part[bi * H + hh];
      dA[hh] = acc;
    }
}

template <typename T, int kSL>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const void* dy, const float* dh_last, void* dx,
           float* ddt, float* dA, void* dBm, void* dCm, float* ckpt,
           float* dB_part, float* dC_part, float* dA_part, int B, int Tn,
           int H, int P, int S, cudaStream_t stream) {
  cudaError_t err = cato::allow_shared_memory(scan_bwd_kernel<T, kSL>,
                                              kSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_kernel<T, kSL><<<dim3(H, B), kThreads, kSharedBytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(dy), dh_last,
      static_cast<T*>(dx), ddt, ckpt, dB_part, dC_part, dA_part, Tn, H, P,
      S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(B) * Tn * S;
  const int blocks = static_cast<int>(
      n / 256 + 1 < 8192 ? n / 256 + 1 : 8192);
  scan_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      dB_part, dC_part, dA_part, static_cast<T*>(dBm), static_cast<T*>(dCm),
      dA, B, Tn, H, S, 32 * kSL);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (two kernels), allocates nothing, does not
// synchronise. `bf16` selects bfloat16 x, Bm, Cm, dy, dx, dBm and dCm
// (else float32); dt, A, dh_last (null for none), ddt, dA and the scratch
// are float32: `ckpt` (B, H, ceil(T / 16), P, Sp), `dB_part` and
// `dC_part` (B, H, T, Sp), `dA_part` (B, H), Sp = 32 for S <= 32, else
// 64. P is a multiple of 16 up to 64 and S at most 64 (the wrapper
// checks). Returns the first CUDA error of the two launches (0 on
// success), or cudaErrorInvalidValue for a P or S it does not take.
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dh_last, void* dx,
    void* ddt, void* dA, void* dBm, void* dCm, void* ckpt, void* dB_part,
    void* dC_part, void* dA_part, int B, int T, int H, int P, int S,
    int bf16, void* stream) {
  if (P % kWarps || P < kWarps || P > kMaxP || S < 1 || S > kMaxSp)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* dhf = static_cast<const float*>(dh_last);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  float* ck = static_cast<float*>(ckpt);
  float* pb = static_cast<float*>(dB_part);
  float* pc = static_cast<float*>(dC_part);
  float* pa = static_cast<float*>(dA_part);
#define CATO_SB_LAUNCH(TYPE, SL)                                            \
  return launch<TYPE, SL>(x, dtf, Af, Bm, Cm, dy, dhf, dx, ddtf, dAf, dBm, \
                          dCm, ck, pb, pc, pa, B, T, H, P, S, s)
  if (bf16) {
    if (S <= 32) CATO_SB_LAUNCH(__nv_bfloat16, 1);
    CATO_SB_LAUNCH(__nv_bfloat16, 2);
  }
  if (S <= 32) CATO_SB_LAUNCH(float, 1);
  CATO_SB_LAUNCH(float, 2);
#undef CATO_SB_LAUNCH
}
