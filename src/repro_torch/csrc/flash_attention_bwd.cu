// B6b: the gradient of B6 (GQA attention over a full sequence): dQ, dK and
// dV from the forward's inputs, its output O and the output's gradient dO.
//
// Replaces no Pallas kernel: the reference has no backward kernel (no
// `custom_vjp` around src/repro/kernels/flash_attention.py), and trains
// through XLA's autodiff of its jnp attention
// (src/repro/models/layers.py `attention`, attn_impl="xla"). This computes
// the gradient that autodiff computes for the function B6 computes,
//   out[i] = sum_j P[i, j] v[j],  P[i, :] = softmax_j(scale * q[i] . k[j])
// over the keys row i may see (all, or causal: j <= i + Tk - Tq), a row
// with no valid key giving 0:
//   Delta[i] = dO[i] . O[i]
//   dP[i, j] = dO[i] . v[j]
//   dS[i, j] = P[i, j] (dP[i, j] - Delta[i]) scale
//   dQ[i] = sum_j dS[i, j] k[j],  dK[j] = sum_i dS[i, j] q[i],
//   dV[j] = sum_i P[i, j] dO[i]
// with dK and dV summed over the query heads that share a kv head (GQA).
// Everything is float32 on inputs read as float32 (bfloat16 inputs are
// widened exactly), the gradients are written in the inputs' type.
//
// Two launches, no atomics, so every run gives the same bits:
// - `fa_bwd_dq_kernel`, one block per (64-row query tile, q head, batch),
//   its 8 warps owning 8 rows each as in B6's scalar kernel. It takes
//   Delta (a float32 chain over D, in column order), recomputes the
//   softmax statistics m and l with B6's own float32 loop (a pass over the
//   64-key tiles: running max from -1e30, l = l * exp(m_old - m_new) + the
//   tile's sum in the lane butterfly), then walks the tiles again: S and
//   dP per tile (fmaf chains over D), P = exp(scale S - m) / l, dS, and
//   the tile's dS K from zero in key order, added to dQ. It writes m, l
//   and Delta per row for the second launch.
// - `fa_bwd_dkdv_kernel`, one block per (64-key tile, kv head, batch), its
//   8 warps owning 8 keys each: for each query head of the group in order,
//   for each 64-row query tile in order (causal: from the first that sees
//   the tile), it recomputes S, dP, P and dS for its keys (lanes over
//   queries), then the tile's P^T dO and dS^T Q from zero in query order,
//   added to dV and dK.
// S and dP are the same fmaf chains in both launches, so P and dS are the
// same bits in both.
//
// Order of arithmetic. `flash_attention_bwd_plain` (kernels/
// flash_attention.py) computes the same steps with torch ops: Delta as a
// loop over columns, the statistics as B6's float32 plain version, and
// every per-tile product as a float32 GEMM of depth D or 64 (cuBLAS, which
// adds each output's products in k order by FFMA, as these fmaf chains
// do), the tiles added in the same order. A change of either side's order
// changes the other.
//
// Bound on the H100. At zamba2-1.2b's training shape (B 2, 32 and 32
// heads, T 4096, D 64, causal) the gradient needs the products S, dP, dQ,
// dK and dV: 5 x 2 x D per attended (row, key) pair, about 2.5 times the
// forward's operations, against q, k, v, O, dO read once and dQ, dK, dV
// written once; at bf16's 989 TFLOP/s operations bound it. This first
// design is scalar float32 on the CUDA cores (67 TFLOP/s at best), and
// recomputes S and dP in both launches; its time is in PERF.md.
//
// Head dims: compiled for the tile widths 32, 64 and 128; any other even D
// up to 128 runs the next width on rows zero-padded as they are loaded
// (a zero column adds exact zeros), and only columns below D are written.
//
// Built with --fmad=false like every source here: no multiply and add is
// contracted but the explicit fmaf.
#include <stdint.h>

#include "lm_common.cuh"

namespace {

constexpr int kBQ = 64;                       // query rows per tile
constexpr int kBK = 64;                       // keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;    // 8 (rows, or keys)
constexpr int kPerLane = 2;                   // keys (or rows) a lane scores

template <int Dp>
constexpr size_t dq_shared_bytes() {
  // sQ, sdO (kBQ x Dp), sK, sV (kBK x (Dp + 1)), sDS (kBQ x kBK)
  return sizeof(float) *
         (2 * kBQ * Dp + 2 * kBK * (Dp + 1) + kBQ * kBK);
}

template <int Dp>
constexpr size_t dkdv_shared_bytes() {
  // sK, sV, sQ, sdO (64 x (Dp + 1)), sP, sDS (kBK x kBQ), m, l, Delta
  return sizeof(float) *
         (4 * 64 * (Dp + 1) + 2 * kBK * kBQ + 3 * kBQ);
}

template <typename T, int Dp, bool kPad>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq_kernel(
    const T* __restrict__ q,     // (B, Hq, Tq, D)
    const T* __restrict__ k,     // (B, Hkv, Tk, D)
    const T* __restrict__ v,     // (B, Hkv, Tk, D)
    const T* __restrict__ o,     // (B, Hq, Tq, D), the forward's output
    const T* __restrict__ dout,  // (B, Hq, Tq, D)
    T* __restrict__ dq,          // (B, Hq, Tq, D)
    float* __restrict__ stats,   // (3, B, Hq, Tq): m, l, Delta
    int B, int Hq, int Hkv, int Tq, int Tk, int causal, float scale,
    int d_arg) {
  constexpr int kCols = Dp / 32;
  constexpr int kKS = Dp + 1;
  const int D = kPad ? d_arg : Dp;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kBQ * Dp;          // dO
  float* sK = sO + kBQ * Dp;
  float* sV = sK + kBK * kKS;
  float* sDS = sV + kBK * kKS;
  __shared__ float sDelta[kBQ];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qoff = (static_cast<size_t>(b) * Hq + h) * Tq * D;
  const T* qp = q + qoff;
  const T* op = o + qoff;
  const T* dop = dout + qoff;
  const T* kp = k + (static_cast<size_t>(b) * Hkv + kvh) * Tk * D;
  const T* vp = v + (static_cast<size_t>(b) * Hkv + kvh) * Tk * D;

  for (int i = tid; i < kBQ * Dp; i += kThreads) {
    const int r = i / Dp, c = i - r * Dp;
    const bool in = q0 + r < Tq && c < D;
    const size_t g = static_cast<size_t>(q0 + r) * D + c;
    sQ[i] = in ? cato::to_float(qp[g]) : 0.f;
    sO[i] = in ? cato::to_float(dop[g]) : 0.f;
  }
  __syncthreads();
  // Delta = dO . O, one float32 chain over the columns in order
  if (tid < kBQ) {
    float delta = 0.f;
    if (q0 + tid < Tq) {
      const T* orow = op + static_cast<size_t>(q0 + tid) * D;
      for (int c = 0; c < D; ++c)
        delta = delta + sO[tid * Dp + c] * cato::to_float(orow[c]);
    }
    sDelta[tid] = delta;
  }
  __syncthreads();
  const int offset = Tk - Tq;
  int k_end = Tk;
  if (causal) {
    const int last_row = min(q0 + kBQ, Tq) - 1;
    k_end = max(0, min(Tk, last_row + offset + 1));
  }

  auto load_tile = [&](int k0) {
    for (int i = tid; i < kBK * Dp; i += kThreads) {
      const int r = i / Dp, c = i - r * Dp;
      const bool in = k0 + r < Tk && c < D;
      const size_t g = static_cast<size_t>(k0 + r) * D + c;
      sK[r * kKS + c] = in ? cato::to_float(kp[g]) : 0.f;
      sV[r * kKS + c] = in ? cato::to_float(vp[g]) : 0.f;
    }
  };

  // pass 1: the statistics, as B6's scalar kernel computes them
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = cato::kNegInf;
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();
    load_tile(k0);
    __syncthreads();
    float s[kRowsPerWarp][kPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dp; ++d) {
      float kd[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) kd[j] = sK[(lane + 32 * j) * kKS + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qd = sQ[(warp * kRowsPerWarp + r) * Dp + d];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) s[r][j] = fmaf(qd, kd[j], s[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + warp * kRowsPerWarp + r;
      bool valid[kPerLane];
      float mx = cato::kNegInf;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int key = k0 + lane + 32 * j;
        valid[j] = key < Tk && (!causal || key <= qpos + offset);
        s[r][j] *= scale;
        if (valid[j]) mx = fmaxf(mx, s[r][j]);
      }
      mx = cato::warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        psum += valid[j] ? expf(s[r][j] - m_new) : 0.f;
      psum = cato::warp_sum(psum);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
    }
  }

  // pass 2: P, dS and dQ, tile by tile
  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();
    load_tile(k0);
    __syncthreads();
    float s[kRowsPerWarp][kPerLane], dp[kRowsPerWarp][kPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < Dp; ++d) {
      float kd[kPerLane], vd[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        kd[j] = sK[(lane + 32 * j) * kKS + d];
        vd[j] = sV[(lane + 32 * j) * kKS + d];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qd = sQ[(warp * kRowsPerWarp + r) * Dp + d];
        const float od = sO[(warp * kRowsPerWarp + r) * Dp + d];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          s[r][j] = fmaf(qd, kd[j], s[r][j]);
          dp[r][j] = fmaf(od, vd[j], dp[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qpos = q0 + row;
      const float delta = sDelta[row];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int key = k0 + lane + 32 * j;
        const bool valid = key < Tk && (!causal || key <= qpos + offset);
        const float sv = s[r][j] * scale;
        const float p = valid && l[r] > 0.f ? expf(sv - m[r]) / l[r] : 0.f;
        sDS[row * kBK + lane + 32 * j] = (p * (dp[r][j] - delta)) * scale;
      }
    }
    __syncwarp();   // each warp reads back only its own rows of sDS
    float t[kRowsPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) t[r][c] = 0.f;
    for (int j = 0; j < kBK; ++j) {
      float kj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kj[c] = sK[j * kKS + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float ds = sDS[(warp * kRowsPerWarp + r) * kBK + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) t[r][c] = fmaf(ds, kj[c], t[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = acc[r][c] + t[r][c];
  }

  const size_t n_rows = static_cast<size_t>(B) * Hq * Tq;
  const size_t srow = (static_cast<size_t>(b) * Hq + h) * Tq;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    if (q0 + row >= Tq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (!kPad || lane + 32 * c < D)
        dq[qoff + static_cast<size_t>(q0 + row) * D + lane + 32 * c] =
            cato::from_float<T>(acc[r][c]);
    if (lane == 0) {
      stats[srow + q0 + row] = m[r];
      stats[n_rows + srow + q0 + row] = l[r];
      stats[2 * n_rows + srow + q0 + row] = sDelta[row];
    }
  }
}

template <typename T, int Dp, bool kPad>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkdv_kernel(
    const T* __restrict__ q,       // (B, Hq, Tq, D)
    const T* __restrict__ k,       // (B, Hkv, Tk, D)
    const T* __restrict__ v,       // (B, Hkv, Tk, D)
    const T* __restrict__ dout,    // (B, Hq, Tq, D)
    const float* __restrict__ stats,   // (3, B, Hq, Tq)
    T* __restrict__ dk,            // (B, Hkv, Tk, D)
    T* __restrict__ dv,            // (B, Hkv, Tk, D)
    int B, int Hq, int Hkv, int Tq, int Tk, int causal, float scale,
    int d_arg) {
  constexpr int kCols = Dp / 32;
  constexpr int kKS = Dp + 1;
  const int D = kPad ? d_arg : Dp;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * kKS;
  float* sQ = sV + kBK * kKS;
  float* sO = sQ + kBQ * kKS;        // dO
  float* sP = sO + kBQ * kKS;        // (key, query)
  float* sDS = sP + kBK * kBQ;       // (key, query)
  float* sM = sDS + kBK * kBQ;
  float* sL = sM + kBQ;
  float* sDelta = sL + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t koff = (static_cast<size_t>(b) * Hkv + kvh) * Tk * D;
  const size_t n_rows = static_cast<size_t>(B) * Hq * Tq;

  for (int i = tid; i < kBK * Dp; i += kThreads) {
    const int r = i / Dp, c = i - r * Dp;
    const bool in = k0 + r < Tk && c < D;
    const size_t gi = koff + static_cast<size_t>(k0 + r) * D + c;
    sK[r * kKS + c] = in ? cato::to_float(k[gi]) : 0.f;
    sV[r * kKS + c] = in ? cato::to_float(v[gi]) : 0.f;
  }

  const int offset = Tk - Tq;
  // the first query tile with a row that may see this tile's first key
  int i_begin = 0;
  if (causal) i_begin = max(0, k0 - offset) / kBQ * kBQ;

  float acc_k[kRowsPerWarp][kCols], acc_v[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const size_t qoff = (static_cast<size_t>(b) * Hq + h) * Tq * D;
    const size_t srow = (static_cast<size_t>(b) * Hq + h) * Tq;
    for (int i0 = i_begin; i0 < Tq; i0 += kBQ) {
      __syncthreads();   // the previous query tile is consumed
      for (int i = tid; i < kBQ * Dp; i += kThreads) {
        const int r = i / Dp, c = i - r * Dp;
        const bool in = i0 + r < Tq && c < D;
        const size_t gi = qoff + static_cast<size_t>(i0 + r) * D + c;
        sQ[r * kKS + c] = in ? cato::to_float(q[gi]) : 0.f;
        sO[r * kKS + c] = in ? cato::to_float(dout[gi]) : 0.f;
      }
      if (tid < kBQ) {
        const bool in = i0 + tid < Tq;
        const size_t si = srow + i0 + tid;
        sM[tid] = in ? stats[si] : cato::kNegInf;
        sL[tid] = in ? stats[n_rows + si] : 0.f;
        sDelta[tid] = in ? stats[2 * n_rows + si] : 0.f;
      }
      __syncthreads();

      // S and dP for this warp's keys (rows of sK) against the lanes' rows
      float s[kRowsPerWarp][kPerLane], dp[kRowsPerWarp][kPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < Dp; ++d) {
        float qd[kPerLane], od[kPerLane];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          qd[j] = sQ[(lane + 32 * j) * kKS + d];
          od[j] = sO[(lane + 32 * j) * kKS + d];
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float kd = sK[(warp * kRowsPerWarp + r) * kKS + d];
          const float vd = sV[(warp * kRowsPerWarp + r) * kKS + d];
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) {
            s[r][j] = fmaf(qd[j], kd, s[r][j]);
            dp[r][j] = fmaf(od[j], vd, dp[r][j]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int kl = warp * kRowsPerWarp + r;
        const int key = k0 + kl;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int ql = lane + 32 * j;
          const int row = i0 + ql;
          const bool valid = row < Tq && key < Tk &&
                             (!causal || key <= row + offset);
          const float sv = s[r][j] * scale;
          const float lr = sL[ql];
          const float p = valid && lr > 0.f ? expf(sv - sM[ql]) / lr : 0.f;
          sP[kl * kBQ + ql] = p;
          sDS[kl * kBQ + ql] = (p * (dp[r][j] - sDelta[ql])) * scale;
        }
      }
      __syncwarp();   // each warp reads back only its own keys' rows

      // this tile's P^T dO and dS^T Q, from zero in query order
      float tv[kRowsPerWarp][kCols], tk[kRowsPerWarp][kCols];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) tv[r][c] = tk[r][c] = 0.f;
      for (int i = 0; i < kBQ; ++i) {
        float oi[kCols], qi[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          oi[c] = sO[i * kKS + lane + 32 * c];
          qi[c] = sQ[i * kKS + lane + 32 * c];
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int kl = warp * kRowsPerWarp + r;
          const float p = sP[kl * kBQ + i];
          const float ds = sDS[kl * kBQ + i];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            tv[r][c] = fmaf(p, oi[c], tv[r][c]);
            tk[r][c] = fmaf(ds, qi[c], tk[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_v[r][c] = acc_v[r][c] + tv[r][c];
          acc_k[r][c] = acc_k[r][c] + tk[r][c];
        }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = k0 + warp * kRowsPerWarp + r;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (!kPad || lane + 32 * c < D) {
        const size_t gi = koff + static_cast<size_t>(key) * D + lane + 32 * c;
        dk[gi] = cato::from_float<T>(acc_k[r][c]);
        dv[gi] = cato::from_float<T>(acc_v[r][c]);
      }
  }
}

template <typename T, int Dp, bool kPad>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* stats,
           int B, int Hq, int Hkv, int Tq, int Tk, int D, int causal,
           float scale, cudaStream_t stream) {
  constexpr size_t dq_bytes = dq_shared_bytes<Dp>();
  constexpr size_t kv_bytes = dkdv_shared_bytes<Dp>();
  cudaError_t err = cato::allow_shared_memory(
      fa_bwd_dq_kernel<T, Dp, kPad>, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cato::allow_shared_memory(fa_bwd_dkdv_kernel<T, Dp, kPad>, kv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  fa_bwd_dq_kernel<T, Dp, kPad>
      <<<dim3((Tq + kBQ - 1) / kBQ, Hq, B), kThreads, dq_bytes, stream>>>(
          qt, kt, vt, static_cast<const T*>(o), dot, static_cast<T*>(dq),
          stats, B, Hq, Hkv, Tq, Tk, causal, scale, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_dkdv_kernel<T, Dp, kPad>
      <<<dim3((Tk + kBK - 1) / kBK, Hkv, B), kThreads, kv_bytes, stream>>>(
          qt, kt, vt, dot, stats, static_cast<T*>(dk), static_cast<T*>(dv),
          B, Hq, Hkv, Tq, Tk, causal, scale, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* stats,
             int B, int Hq, int Hkv, int Tq, int Tk, int D, int causal,
             float scale, cudaStream_t stream) {
  if (D < 2 || D > 128 || D % 2)
    return static_cast<int>(cudaErrorInvalidValue);
#define CATO_FAB_LAUNCH(DP, PAD)                                            \
  return launch<T, DP, PAD>(q, k, v, o, dout, dq, dk, dv, stats, B, Hq,    \
                            Hkv, Tq, Tk, D, causal, scale, stream)
  switch (D) {
    case 32: CATO_FAB_LAUNCH(32, false);
    case 64: CATO_FAB_LAUNCH(64, false);
    case 128: CATO_FAB_LAUNCH(128, false);
    default:
      if (D < 32) CATO_FAB_LAUNCH(32, true);
      if (D < 64) CATO_FAB_LAUNCH(64, true);
      CATO_FAB_LAUNCH(128, true);
  }
#undef CATO_FAB_LAUNCH
}

}  // namespace

// Launches on `stream` (two kernels), allocates nothing, does not
// synchronise. `bf16` selects bfloat16 q, k, v, o, dout and gradients,
// else float32; `stats` is float32 scratch of 3 x B x Hq x Tq. D is even,
// 2 to 128; Hq a multiple of Hkv. Returns the first CUDA error of the two
// launches (0 on success), or cudaErrorInvalidValue for a D it does not
// take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, int B,
    int Hq, int Hkv, int Tq, int Tk, int D, int causal, int bf16,
    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, st, B,
                                        Hq, Hkv, Tq, Tk, D, causal, scale, s)
              : launch_d<float>(q, k, v, o, dout, dq, dk, dv, st, B, Hq, Hkv,
                                Tq, Tk, D, causal, scale, s);
}
