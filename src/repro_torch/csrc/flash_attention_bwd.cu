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
// The gradients are written in the inputs' type. Two launches, no atomics,
// so every run gives the same bits: a dQ launch, one block per (64-row
// query tile, q head, batch), which also writes each row's statistics,
// then a dK/dV launch, one block per (64-key tile, kv head, batch), which
// walks the group's query heads in order and each head's query tiles in
// order (causal: from the first that sees the tile). Each tile's products
// start from zero and are added to the accumulators in that order.
//
// bfloat16: the tensor cores (`fa_bwd_dq_wgmma_kernel`,
// `fa_bwd_dkdv_wgmma_kernel`), built from B6's bf16 forward
// (flash_attention.cu; the helpers in tma_wgmma.cuh). A block is one
// consumer warpgroup, owning 64 rows (query rows, or keys), and one
// producer warp whose thread loads the block's two fixed tiles (Q and dO,
// or K and V) once and streams the others (K and V, or Q and dO) by TMA
// into a 2-stage mbarrier ring of 128- or 64-byte swizzled tiles.
// - Statistics. The dQ launch first runs B6's own online softmax over the
//   row's key tiles (S = Q K^T on wgmma, the same code, so m and l are the
//   forward's bits) and writes m (log2 units), 1/l (0 for a row with no
//   valid key) and Delta (a float32 chain over the columns) per row. This
//   pass costs one product of depth D and an exp2 per pair; having the
//   forward write m and l instead would change the serving launch's code
//   and make autograd save one more tensor, so the backward recomputes
//   them.
// - dQ: per key tile S = Q K^T and dP = dO V^T (wgmma, K-major operands
//   in shared memory), P = exp2(S scale log2(e) - m) (1/l) in float32,
//   dS = P (dP - Delta) scale rounded to bf16 as a register A operand,
//   dQ += dS K (K read MN-major).
// - dK/dV: per query tile S^T = K Q^T and dP^T = V dO^T (the dQ launch's
//   S and dP transposed: each output the same products of depth D in the
//   same order), P^T from the statistics of the 16 query rows a thread's
//   columns hold, rounded to bf16, dS^T as above; dV += P^T dO and dK +=
//   dS^T Q (dO and Q read MN-major).
// Every product has depth D or 64 and sums 16 products a step, the steps
// in order, from zero. The float32 paths of both launches are the first
// design's scalar kernels (below), which the reduced configs' float32
// training runs.
//
// float32: `fa_bwd_dq_kernel`, `fa_bwd_dkdv_kernel`, scalar float32 on
// inputs read as float32, 8 warps a block: the dQ kernel recomputes m and
// l with B6's scalar loop, then per 64-key tile S, dP, P = exp(scale S -
// m) / l, dS and the tile's dS K from zero in key order; the dK/dV kernel
// recomputes S, dP, P and dS for its keys, then the tile's P^T dO and dS^T
// Q from zero in query order. S and dP are the same fmaf chains in both.
//
// Order of arithmetic. `flash_attention_bwd_plain` (kernels/
// flash_attention.py) computes the same steps with torch ops: Delta as a
// loop over columns; for bf16 the statistics as B6's bf16 plain version
// and every per-tile product as a bf16 GEMM into float32 (cuBLAS, which
// sums as wgmma does at these depths), the roundings of P and dS as here;
// for float32 the statistics as B6's float32 plain version and every
// per-tile product as a float32 GEMM (cuBLAS, which adds each output's
// products in k order by FFMA, as the fmaf chains do); the tiles added in
// the same order. A change of either side's order changes the other.
//
// Bound on the H100. At zamba2-1.2b's training shape (B 2, 32 and 32
// heads, T 4096, D 64, causal, bf16) the gradient needs the products S,
// dP, dQ, dK and dV: 5 x 2 x D per attended (row, key) pair, 343.7 G
// operations, 0.3475 ms at bf16's 989 TFLOP/s, against q, k, v, O, dO
// read once and dQ, dK, dV written once (0.080 ms). The bf16 design does
// 8 products a pair (the statistics' S, and S and dP in both launches).
// The first design (scalar float32 for bf16 too) took 25.232 device ms
// there; this one's time is in PERF.md.
//
// Head dims: compiled for the tile widths 32, 64 and 128; any other even D
// up to 128 runs the next width on rows zero-padded (the scalar kernels
// as they load, the wgmma kernels' TMA boxes past the rows' ends; TMA
// needs rows of a multiple of 16 bytes, so the wrapper first pads a bf16
// D of 12 or 20 to the next multiple of 8), and only columns below D are
// written.
//
// Built with --fmad=false like every source here: no multiply and add is
// contracted but the explicit fmaf.
#include <math_constants.h>
#include <stdint.h>

#include "lm_common.cuh"
#include "tma_wgmma.cuh"

namespace {

using namespace cato;   // the TMA and wgmma helpers (tma_wgmma.cuh)

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

// ---------------------------------------------------------------------------
// bfloat16: wgmma on tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                  // rows a block owns, and a tile's
constexpr int kWgStages = 2;                 // ring depth
constexpr int kWgThreads = 128 + 32;         // a consumer warpgroup + the producer warp

// Shared-memory geometry for the tile width Dp: rows of kCB bf16 (the
// swizzle width), kNCB column blocks a row; two fixed 64-row tiles and a
// ring of kWgStages pairs, each tile on a 1024-byte boundary.
template <int Dp>
struct BwdLayout {
  static constexpr int kCB = Dp < 64 ? Dp : 64;
  static constexpr int kRowBytes = 2 * kCB;             // 64 or 128
  static constexpr int kNCB = Dp / kCB;
  static constexpr uint32_t kTileBytes = kWgRows * Dp * 2;
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;
  static constexpr size_t kSmem = 1024 + (2 + 2 * kWgStages) * kTileBytes;
};

// The K-major descriptor of the 64-row tile at `tile` for the 16 columns
// of step kk of a product over the head dim.
template <int Dp>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using L = BwdLayout<Dp>;
  const uint32_t at = (kk * 16 / L::kCB) * kWgRows * L::kRowBytes +
                      (kk * 16 % L::kCB) * 2;
  return wgmma_desc(tile + at, 16, 8 * L::kRowBytes, L::kSwizzle);
}

// d = A B^T over the head dim (Dp / 16 steps of 16, from zero): A and B
// the 64-row tiles at a_tile and b_tile, both K-major. Issues only: the
// caller fences, commits and waits.
template <int Dp>
__device__ __forceinline__ void mma_rows(float (&d)[32], uint32_t a_tile,
                                         uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < Dp / 16; ++kk)
    wgmma_ss_n64(d, kmajor_desc<Dp>(a_tile, kk), kmajor_desc<Dp>(b_tile, kk),
                 kk > 0);
}

// acc = acc + A B: A (64 x 64) in registers as four 16-column bf16
// fragments, B the 64-row tile at b_tile read MN-major (its rows are the
// contraction), one column block at a time, each block's product from
// zero over 4 steps of 16 rows.
template <int Dp>
__device__ __forceinline__ void mma_add_tile(float (&acc)[Dp / 2],
                                             const uint32_t (&a)[4][4],
                                             uint32_t b_tile) {
  using L = BwdLayout<Dp>;
#pragma unroll
  for (int c = 0; c < L::kNCB; ++c) {
    const uint32_t base = b_tile + c * kWgRows * L::kRowBytes;
    float t[L::kCB / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<L::kCB>(t, a[kk],
                       wgmma_desc(base + kk * 16 * L::kRowBytes,
                                  kWgRows * L::kRowBytes, 8 * L::kRowBytes,
                                  L::kSwizzle),
                       kk > 0);
    wgmma_commit_and_wait();
    fence_regs(t);
#pragma unroll
    for (int i = 0; i < L::kCB / 2; ++i)
      acc[c * L::kCB / 2 + i] = acc[c * L::kCB / 2 + i] + t[i];
  }
}

// A 64 x 64 accumulator rounded to bf16 as four A fragments of 16
// columns: the accumulator's layout is the fragments'.
__device__ __forceinline__ void pack_bf16(const float (&v)[32],
                                          uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const __nv_bfloat162 p2 = __floats2bfloat162_rn(v[i], v[i + 1]);
    a[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&p2);
  }
}

// Rows r and r + 8 of a 64-row block's tile (the wgmma accumulator layout)
// as bf16 pairs of columns below dh.
template <int Dp, bool kPad>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ base,
                                           const float (&acc)[Dp / 2], int r,
                                           int rows, int dh, int cq) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r + 8 * rr;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < Dp / 8; ++c) {
      if (kPad && c * 8 + cq >= dh) continue;
      *reinterpret_cast<__nv_bfloat162*>(base + static_cast<size_t>(row) * dh +
                                         c * 8 + cq) =
          __floats2bfloat162_rn(acc[4 * c + 2 * rr], acc[4 * c + 2 * rr + 1]);
    }
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              uint64_t* fixed) {
  if (threadIdx.x == 0) {
    mbar_init(fixed, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// dQ, one block per (64-row query tile, q head, batch), longest first.
// The producer warp loads Q and dO once, then each key tile twice: K alone
// for the statistics pass, then K and V. The statistics are B6's own (the
// same code, so the same bits as the forward's); their m, 1/l and Delta
// go to `stats` for the dK/dV launch.
template <int Dp, bool kPad>
__global__ void __launch_bounds__(kWgThreads, Dp == 128 ? 1 : 2)
    fa_bwd_dq_wgmma_kernel(
        const __grid_constant__ CUtensorMap tm_q,    // (D, Tq, B * Hq)
        const __grid_constant__ CUtensorMap tm_k,    // (D, Tk, B * Hkv)
        const __grid_constant__ CUtensorMap tm_v,    // (D, Tk, B * Hkv)
        const __grid_constant__ CUtensorMap tm_do,   // (D, Tq, B * Hq)
        const __nv_bfloat16* __restrict__ o,         // (B, Hq, Tq, D)
        const __nv_bfloat16* __restrict__ dout,      // (B, Hq, Tq, D)
        __nv_bfloat16* __restrict__ dq,              // (B, Hq, Tq, D)
        float* __restrict__ stats,   // (3, B * Hq, Tqp): m, 1/l, Delta
        int Hq, int Hkv, int Tq, int Tk, int Tqp, int causal, float scale,
        float scale_log2, int d_arg) {
  using L = BwdLayout<Dp>;
  const int dh = kPad ? d_arg : Dp;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kWgStages], empty[kWgStages], fixed;
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sDO = sQ + L::kTileBytes;
  const uint32_t ring = sDO + L::kTileBytes;   // stage s: K, then V

  const int n_qt = (Tq + kWgRows - 1) / kWgRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * kWgRows;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (Hq / Hkv);
  const int offset = Tk - Tq;
  int k_end = Tk;   // the keys any row of this tile may see
  if (causal) k_end = max(0, min(Tk, min(q0 + kWgRows, Tq) + offset));
  const int n = (k_end + kWgRows - 1) / kWgRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  init_barriers(full, empty, &fixed);

  if (warp == 4) {   // the producer warp
    if (lane == 0) {
      mbar_expect_tx(&fixed, 2 * L::kTileBytes);
      for (int c = 0; c < L::kNCB; ++c) {
        const uint32_t at = c * kWgRows * L::kRowBytes;
        tma_load(sQ + at, &tm_q, &fixed, c * L::kCB, q0, b * Hq + h);
        tma_load(sDO + at, &tm_do, &fixed, c * L::kCB, q0, b * Hq + h);
      }
      for (int j = 0; j < 2 * n; ++j) {
        const int s = j % kWgStages;
        if (j >= kWgStages) mbar_wait(&empty[s], (j / kWgStages - 1) & 1);
        const bool with_v = j >= n;
        const int k0 = (with_v ? j - n : j) * kWgRows;
        mbar_expect_tx(&full[s], (with_v ? 2 : 1) * L::kTileBytes);
        for (int c = 0; c < L::kNCB; ++c) {
          const uint32_t at = 2 * s * L::kTileBytes + c * kWgRows * L::kRowBytes;
          tma_load(ring + at, &tm_k, &full[s], c * L::kCB, k0, b * Hkv + kvh);
          if (with_v)
            tma_load(ring + at + L::kTileBytes, &tm_v, &full[s], c * L::kCB,
                     k0, b * Hkv + kvh);
        }
      }
    }
    return;
  }

  // this thread's rows r0 and r0 + 8; its keys of a tile k0 + 8 i' + cq + e
  const int r0 = q0 + warp * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  // Delta = dO . O, one float32 chain over the columns in order
  float delta[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    float acc = 0.f;
    if (row < Tq) {
      const size_t at = ((static_cast<size_t>(b) * Hq + h) * Tq + row) * dh;
      for (int c = 0; c < dh; ++c)
        acc = acc + cato::to_float(dout[at + c]) * cato::to_float(o[at + c]);
    }
    delta[rr] = acc;
  }

  // pass 1: m and l, B6's online softmax (flash_attention.cu), tile by tile
  float m[2] = {cato::kNegInf, cato::kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(&fixed, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % kWgStages;
    const int k0 = j * kWgRows;
    mbar_wait(&full[s], (j / kWgStages) & 1);
    float sc[32];
    wgmma_fence();
    mma_rows<Dp>(sc, sQ, ring + 2 * s * L::kTileBytes);
    wgmma_commit_and_wait();
    fence_regs(sc);
    const bool whole = k0 + kWgRows <= Tk &&
                       (!causal || k0 + kWgRows - 1 <= q0 + offset);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i % 4) / 2;
      float v = sc[i] * scale_log2;
      if (!whole) {
        const int key = k0 + (i / 4) * 8 + cq + i % 2;
        if (key >= Tk || (causal && key > r0 + 8 * rr + offset)) v = -CUDART_INF_F;
      }
      sc[i] = v;
      mx[rr] = fmaxf(mx[rr], v);
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m_new = fmaxf(m[rr], quad_max(mx[rr]));
      alpha[rr] = exp2f(m[rr] - m_new);
      m[rr] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int rr = (i % 4) / 2;
      const float2 pf = __bfloat1622float2(__floats2bfloat162_rn(
          exp2f(sc[i] - m[rr]), exp2f(sc[i + 1] - m[rr])));
      ps[rr] += pf.x + pf.y;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + quad_sum(ps[rr]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  float rl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) rl[rr] = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
  if (lane % 4 == 0) {
    const size_t n_rows = static_cast<size_t>(gridDim.y) * Hq * Tqp;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      const size_t at = (static_cast<size_t>(b) * Hq + h) * Tqp + row;
      const bool in = row < Tq;
      stats[at] = in ? m[rr] : 0.f;
      stats[n_rows + at] = in ? rl[rr] : 0.f;
      stats[2 * n_rows + at] = in ? delta[rr] : 0.f;
    }
  }

  // pass 2: S, dP, P = exp2(S scale log2(e) - m) / l, dS, dQ += dS K
  float acc[Dp / 2];
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) acc[i] = 0.f;
  for (int j = n; j < 2 * n; ++j) {
    const int s = j % kWgStages;
    const int k0 = (j - n) * kWgRows;
    const uint32_t sK = ring + 2 * s * L::kTileBytes;
    mbar_wait(&full[s], (j / kWgStages) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    mma_rows<Dp>(sc, sQ, sK);
    mma_rows<Dp>(dp, sDO, sK + L::kTileBytes);
    wgmma_commit_and_wait();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i % 4) / 2;
      const int key = k0 + (i / 4) * 8 + cq + i % 2;
      const bool valid =
          key < Tk && (!causal || key <= r0 + 8 * rr + offset);
      const float v = valid ? sc[i] * scale_log2 : -CUDART_INF_F;
      const float p = exp2f(v - m[rr]) * rl[rr];
      dp[i] = (p * (dp[i] - delta[rr])) * scale;
    }
    uint32_t dsa[4][4];
    pack_bf16(dp, dsa);
    mma_add_tile<Dp>(acc, dsa, sK);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_rows<Dp, kPad>(dq + (static_cast<size_t>(b) * Hq + h) * Tq * dh, acc,
                       r0, Tq, dh, cq);
}

// dK and dV, one block per (64-key tile, kv head, batch), first tiles
// first (under the causal mask they see the most rows). The producer warp
// loads K and V once, then Q and dO of each query tile that may see the
// keys, for the group's query heads in order, each head's tiles in order.
// S^T = K Q^T and dP^T = V dO^T are the dQ launch's S and dP transposed
// (each output the same products of depth D, summed in the same order).
template <int Dp, bool kPad>
__global__ void __launch_bounds__(kWgThreads, Dp == 128 ? 1 : 2)
    fa_bwd_dkdv_wgmma_kernel(
        const __grid_constant__ CUtensorMap tm_q,    // (D, Tq, B * Hq)
        const __grid_constant__ CUtensorMap tm_k,    // (D, Tk, B * Hkv)
        const __grid_constant__ CUtensorMap tm_v,    // (D, Tk, B * Hkv)
        const __grid_constant__ CUtensorMap tm_do,   // (D, Tq, B * Hq)
        const float* __restrict__ stats,   // (3, B * Hq, Tqp): m, 1/l, Delta
        __nv_bfloat16* __restrict__ dk,    // (B, Hkv, Tk, D)
        __nv_bfloat16* __restrict__ dv,    // (B, Hkv, Tk, D)
        int Hq, int Hkv, int Tq, int Tk, int Tqp, int causal, float scale,
        float scale_log2, int d_arg) {
  using L = BwdLayout<Dp>;
  const int dh = kPad ? d_arg : Dp;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kWgStages], empty[kWgStages], fixed;
  const uint32_t sK = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + L::kTileBytes;
  const uint32_t ring = sV + L::kTileBytes;   // stage s: Q, then dO

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kWgRows;
  const int g = Hq / Hkv;
  const int offset = Tk - Tq;
  // the first query tile with a row that may see this tile's first key
  const int i_begin = causal ? max(0, k0 - offset) / kWgRows * kWgRows : 0;
  const int n_q = i_begin < Tq ? (Tq - i_begin + kWgRows - 1) / kWgRows : 0;
  const int n = g * n_q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  init_barriers(full, empty, &fixed);

  if (warp == 4) {   // the producer warp
    if (lane == 0) {
      mbar_expect_tx(&fixed, 2 * L::kTileBytes);
      for (int c = 0; c < L::kNCB; ++c) {
        const uint32_t at = c * kWgRows * L::kRowBytes;
        tma_load(sK + at, &tm_k, &fixed, c * L::kCB, k0, b * Hkv + kvh);
        tma_load(sV + at, &tm_v, &fixed, c * L::kCB, k0, b * Hkv + kvh);
      }
      for (int j = 0; j < n; ++j) {
        const int s = j % kWgStages;
        if (j >= kWgStages) mbar_wait(&empty[s], (j / kWgStages - 1) & 1);
        const int head = b * Hq + kvh * g + j / n_q;
        const int i0 = i_begin + (j % n_q) * kWgRows;
        mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        for (int c = 0; c < L::kNCB; ++c) {
          const uint32_t at = 2 * s * L::kTileBytes + c * kWgRows * L::kRowBytes;
          tma_load(ring + at, &tm_q, &full[s], c * L::kCB, i0, head);
          tma_load(ring + at + L::kTileBytes, &tm_do, &full[s], c * L::kCB, i0,
                   head);
        }
      }
    }
    return;
  }

  // this thread's keys r0 and r0 + 8; its query rows of a tile i0 + 8 i' +
  // cq + e
  const int r0 = k0 + warp * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const size_t n_rows = static_cast<size_t>(gridDim.y) * Hq * Tqp;
  float acc_k[Dp / 2], acc_v[Dp / 2];
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  mbar_wait(&fixed, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % kWgStages;
    const int h = kvh * g + j / n_q;
    const int i0 = i_begin + (j % n_q) * kWgRows;
    const uint32_t sQ = ring + 2 * s * L::kTileBytes;
    const uint32_t sDO = sQ + L::kTileBytes;
    mbar_wait(&full[s], (j / kWgStages) & 1);
    float st[32], dpt[32];
    wgmma_fence();
    mma_rows<Dp>(st, sK, sQ);
    mma_rows<Dp>(dpt, sV, sDO);
    wgmma_commit_and_wait();
    fence_regs(st);
    fence_regs(dpt);
    // P^T and dS^T, with the statistics of the 16 query rows this
    // thread's columns hold
    const float* sm = stats + (static_cast<size_t>(b) * Hq + h) * Tqp + i0 + cq;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 mq = *reinterpret_cast<const float2*>(sm + 8 * jj);
      const float2 rq = *reinterpret_cast<const float2*>(sm + n_rows + 8 * jj);
      const float2 dq2 =
          *reinterpret_cast<const float2*>(sm + 2 * n_rows + 8 * jj);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * jj + u;
        const int key = r0 + 8 * (u / 2);
        const int e = u % 2;
        const int q = i0 + 8 * jj + cq + e;
        const bool valid = key < Tk && q < Tq && (!causal || key <= q + offset);
        const float v = valid ? st[i] * scale_log2 : -CUDART_INF_F;
        const float p = exp2f(v - (e ? mq.y : mq.x)) * (e ? rq.y : rq.x);
        st[i] = p;
        dpt[i] = (p * (dpt[i] - (e ? dq2.y : dq2.x))) * scale;
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    pack_bf16(st, pa);
    pack_bf16(dpt, dsa);
    mma_add_tile<Dp>(acc_v, pa, sDO);
    mma_add_tile<Dp>(acc_k, dsa, sQ);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const size_t kv = (static_cast<size_t>(b) * Hkv + kvh) * Tk * dh;
  store_rows<Dp, kPad>(dk + kv, acc_k, r0, Tk, dh, cq);
  store_rows<Dp, kPad>(dv + kv, acc_v, r0, Tk, dh, cq);
}

template <int Dp, bool kPad>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, void* dq, void* dk, void* dv, float* stats,
                 int B, int Hq, int Hkv, int Tq, int Tk, int D, int causal,
                 float scale, cudaStream_t stream) {
  using L = BwdLayout<Dp>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!make_bf16_map(&tm_q, q, Tq, B * Hq, D, L::kCB, kWgRows) ||
      !make_bf16_map(&tm_k, k, Tk, B * Hkv, D, L::kCB, kWgRows) ||
      !make_bf16_map(&tm_v, v, Tk, B * Hkv, D, L::kCB, kWgRows) ||
      !make_bf16_map(&tm_do, dout, Tq, B * Hq, D, L::kCB, kWgRows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cato::allow_shared_memory(
      fa_bwd_dq_wgmma_kernel<Dp, kPad>, L::kSmem);
  if (err == cudaSuccess)
    err = cato::allow_shared_memory(fa_bwd_dkdv_wgmma_kernel<Dp, kPad>,
                                    L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Tqp = (Tq + kWgRows - 1) / kWgRows * kWgRows;
  const float scale_log2 = scale * 1.4426950408889634f;
  using bf = __nv_bfloat16;
  fa_bwd_dq_wgmma_kernel<Dp, kPad>
      <<<dim3(Hq, B, (Tq + kWgRows - 1) / kWgRows), kWgThreads, L::kSmem,
         stream>>>(tm_q, tm_k, tm_v, tm_do, static_cast<const bf*>(o),
                   static_cast<const bf*>(dout), static_cast<bf*>(dq), stats,
                   Hq, Hkv, Tq, Tk, Tqp, causal, scale, scale_log2, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_dkdv_wgmma_kernel<Dp, kPad>
      <<<dim3(Hkv, B, (Tk + kWgRows - 1) / kWgRows), kWgThreads, L::kSmem,
         stream>>>(tm_q, tm_k, tm_v, tm_do, stats, static_cast<bf*>(dk),
                   static_cast<bf*>(dv), Hq, Hkv, Tq, Tk, Tqp, causal, scale,
                   scale_log2, D);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma_d(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* stats, int B, int Hq, int Hkv, int Tq, int Tk,
                   int D, int causal, float scale, cudaStream_t stream) {
  if (D < 8 || D > 128 || D % 8)   // TMA: rows of a multiple of 16 bytes
    return static_cast<int>(cudaErrorInvalidValue);
#define CATO_WGB_LAUNCH(DP, PAD)                                             \
  return launch_wgmma<DP, PAD>(q, k, v, o, dout, dq, dk, dv, stats, B, Hq,  \
                               Hkv, Tq, Tk, D, causal, scale, stream)
  switch (D) {
    case 32: CATO_WGB_LAUNCH(32, false);
    case 64: CATO_WGB_LAUNCH(64, false);
    case 128: CATO_WGB_LAUNCH(128, false);
    default:
      if (D < 32) CATO_WGB_LAUNCH(32, true);
      if (D < 64) CATO_WGB_LAUNCH(64, true);
      CATO_WGB_LAUNCH(128, true);
  }
#undef CATO_WGB_LAUNCH
}

}  // namespace

// Launches on `stream` (two kernels), allocates nothing, does not
// synchronise. `bf16` selects bfloat16 q, k, v, o, dout and gradients and
// the wgmma kernels (q, k, v and dout start on 16-byte boundaries; D a
// multiple of 8 up to 128), else float32 and the scalar kernels (D even,
// 2 to 128); `stats` is float32 scratch of 3 x B x Hq x Tq rounded up to
// 64. Hq is a multiple of Hkv. Returns the first CUDA error of the two
// launches (0 on success), or cudaErrorInvalidValue for a D it does not
// take or if a tensor map cannot be made.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, int B,
    int Hq, int Hkv, int Tq, int Tk, int D, int causal, int bf16,
    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  return bf16 ? launch_wgmma_d(q, k, v, o, dout, dq, dk, dv, st, B, Hq, Hkv,
                               Tq, Tk, D, causal, scale, s)
              : launch_d<float>(q, k, v, o, dout, dq, dk, dv, st, B, Hq, Hkv,
                                Tq, Tk, D, causal, scale, s);
}
