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
// since `mamba2_forward` returns it, so one launch gives both outputs.
//
// Layout. The TPU grid walks (batch, head, chunk) with the chunk axis
// innermost and sequential; here one block per (head, batch) walks the
// chunks in order, a loop in place of that grid axis. The state lives in
// shared memory for the whole scan (64 x 64 floats, 16 KB, at zamba2-1.2b's
// width), beside the chunk's dt o x, B, C, the c x c masked decay-weighted
// C B^T, and the chunk's L (about 180 KB at c = 128, P = S = 64: one block
// per SM, in dynamic shared memory above 48 KB). Rows of B and of the state
// are padded to S + 1 floats so that lanes walking them fall in distinct
// banks. A ragged last chunk is masked with the effect of the reference's
// zero padding in `ops.mamba_scan`: dt = 0 (decay 1) and x = B = C = 0
// past T, and rows past T are not written.
//
// Bound on the H100. At zamba2-1.2b's prefill (B 2, T 2048, 64 heads of
// P = 64, S = 64, bf16) the scan reads 36 MB and writes 36 MB (y and the
// state) against about 8.6 GFLOP: bytes bound it, about 0.021 ms. This
// kernel's products are scalar float32 FMAs from shared memory, chunk after
// chunk in one block per (head, batch) (128 blocks on 132 SMs), with a
// serial cumulative sum per chunk; it is bound by the SMs' float32 issue
// rate and shared-memory bandwidth, far above the byte bound. Tensor-core
// tiles for the three products, and more blocks per sequence through a
// second pass over chunk states, are the steps to speed (a later PR).
//
// Order of arithmetic. The plain versions in kernels/mamba_scan.py sum L
// step by step as this kernel does (cumsum_in_order), so that a deep bf16
// model run on either gives the same argmaxes; a kernel that sums L in
// another order changes them too.
#include "lm_common.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(
    const T* __restrict__ x,        // (B, T, H, P)
    const float* __restrict__ dt,   // (B, T, H)
    const float* __restrict__ A,    // (H,)
    const T* __restrict__ Bm,       // (B, T, S)
    const T* __restrict__ Cm,       // (B, T, S)
    T* __restrict__ y,              // (B, T, H, P)
    float* __restrict__ h_last,     // (B, H, P, S)
    int Tn, int H, int P, int S, int c) {
  const int SS = S + 1;
  extern __shared__ float smem[];
  float* sDX = smem;            // c x P     dt o x
  float* sB = sDX + c * P;      // c x (S + 1)
  float* sC = sB + c * SS;      // c x S
  float* sH = sC + c * S;       // P x (S + 1)  the carried state
  float* sM = sH + P * SS;      // c x c     tril(exp(L_t - L_tau)) o (C B^T)
  float* sL = sM + c * c;       // c         cumulative log decay
  float* sW = sL + c;           // c         exp(L_c - L_tau)
  float* sDT = sW + c;          // c

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = A[h];
  for (int i = tid; i < P * SS; i += kThreads) sH[i] = 0.f;

  const int n_chunks = (Tn + c - 1) / c;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int t0 = ic * c;
    __syncthreads();   // the previous chunk's readers are done
    for (int i = tid; i < c; i += kThreads)
      sDT[i] = t0 + i < Tn ? dt[(static_cast<size_t>(b) * Tn + t0 + i) * H + h]
                           : 0.f;
    for (int i = tid; i < c * S; i += kThreads) {
      const int r = i / S, s = i - r * S;
      const bool in = t0 + r < Tn;
      const size_t g = (static_cast<size_t>(b) * Tn + t0 + r) * S + s;
      sB[r * SS + s] = in ? cato::to_float(Bm[g]) : 0.f;
      sC[i] = in ? cato::to_float(Cm[g]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < c * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      sDX[i] = t0 + r < Tn
                   ? sDT[r] * cato::to_float(
                                  x[((static_cast<size_t>(b) * Tn + t0 + r) * H + h) * P + p])
                   : 0.f;
    }
    if (tid == 0) {   // the cumulative sum, in order
      float run = 0.f;
      for (int i = 0; i < c; ++i) {
        run += sDT[i] * a;
        sL[i] = run;
      }
    }
    __syncthreads();
    if (tid < c) sW[tid] = expf(sL[c - 1] - sL[tid]);
    for (int i = tid; i < c * c; i += kThreads) {
      const int t = i / c, tau = i - t * c;
      float v = 0.f;
      if (tau <= t) {
        float cb = 0.f;
        for (int s = 0; s < S; ++s) cb = fmaf(sC[t * S + s], sB[tau * SS + s], cb);
        v = expf(sL[t] - sL[tau]) * cb;
      }
      sM[i] = v;
    }
    __syncthreads();

    // y: the intra-chunk product plus the carried state's contribution
    for (int i = tid; i < c * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      if (t0 + t >= Tn) continue;
      float yi = 0.f;
      for (int tau = 0; tau <= t; ++tau) yi = fmaf(sM[t * c + tau], sDX[tau * P + p], yi);
      float ch = 0.f;
      for (int s = 0; s < S; ++s) ch = fmaf(sC[t * S + s], sH[p * SS + s], ch);
      y[((static_cast<size_t>(b) * Tn + t0 + t) * H + h) * P + p] =
          cato::from_float<T>(yi + expf(sL[t]) * ch);
    }
    __syncthreads();   // every reader of the old state is done

    // the state update; each entry is read and written by one thread
    const float decay = expf(sL[c - 1]);
    for (int i = tid; i < P * S; i += kThreads) {
      const int p = i / S, s = i - p * S;
      float upd = 0.f;
      for (int tau = 0; tau < c; ++tau)
        upd = fmaf(sW[tau] * sDX[tau * P + p], sB[tau * SS + s], upd);
      sH[p * SS + s] = decay * sH[p * SS + s] + upd;
    }
  }
  __syncthreads();
  float* hp = h_last + (static_cast<size_t>(b) * H + h) * P * S;
  for (int i = tid; i < P * S; i += kThreads) {
    const int p = i / S, s = i - p * S;
    hp[i] = sH[p * SS + s];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* h_last, int B, int Tn, int H,
           int P, int S, int c, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * (static_cast<size_t>(c) * P + c * (S + 1) + c * S +
                       P * (S + 1) + c * c + 3 * c);
  cudaError_t err = cato::allow_shared_memory(mamba_scan_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba_scan_kernel<T><<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), h_last, Tn, H, P, S, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise. `bf16`
// selects bfloat16 x, Bm, Cm and y (else float32); dt, A and h_last are
// float32. `chunk` is the chunk length c <= 512 (the caller passes
// min(chunk, T)); the wrapper checks that the shared memory fits. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mamba_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, void* h_last, int B, int T, int H, int P, int S,
    int chunk, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* hf = static_cast<float*>(h_last);
  return bf16 ? launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, hf, B, T, H, P,
                                      S, chunk, s)
              : launch<float>(x, dtf, Af, Bm, Cm, y, hf, B, T, H, P, S, chunk,
                              s);
}
