// B7: one-token GQA attention against a KV cache (decode).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py
// `decode_attention_kernel_call` (body `_dec_kernel`), reached through
// src/repro/kernels/ops.py `decode_attention`; it computes what
// src/repro/models/layers.py `decode_attention_xla` computes on the
// reference's model path. For batch b and query head h:
//   out[b, h] = sum_{j < lengths[b]} softmax_j(scale * q[b,h] . k[b,j,h/g])
//               v[b,j,h/g]
// with the TPU kernel's semantics: online softmax in float32 from a running
// max of -1e30, a sequence of length 0 giving 0, output in q's type.
//
// Layout. The TPU grid walks (batch, kv head, cache block) with the cache
// axis innermost, the group's g query heads sharing one pass over each
// block. Here one block per (kv head, batch) holds the group's g query rows
// in registers (each lane D/32 columns of each row) and streams the
// (B, S, Hkv, D) cache in place, strided by Hkv * D between positions: no
// transposed copy. Its 8 warps take positions j = warp, warp + 8, ... up to
// lengths[b] and stop there; a warp reads one position's K and V rows per
// step (coalesced across its lanes), reduces the g dot products with
// shuffles and updates g online-softmax states. The 8 partial states are
// merged through shared memory at the end, rescaled to the common maximum.
//
// Bound on the H100. Decode reads each valid cache entry once and does 4
// FLOPs per element: at (8, 32, 8, 4096, 128) bf16 that is 134 MB for full
// lengths, 0.040 ms at 3.35 TB/s, so bytes bound it. This kernel has only
// B * Hkv blocks (64 at qwen3-8b's decode shape, on 132 SMs) and each warp
// keeps one 256-byte row of K and one of V in flight, so it reaches a small
// share of the card's bandwidth. Splitting the cache axis over more blocks
// (split-S, a second pass merging the partial states) is the step that
// fills the card (a later PR).
#include "lm_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 16;   // g = Hq / Hkv; the wrapper raises above it

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q,          // (B, Hq, D)
    const T* __restrict__ k_cache,    // (B, S, Hkv, D)
    const T* __restrict__ v_cache,    // (B, S, Hkv, D)
    const int* __restrict__ lengths,  // (B,)
    T* __restrict__ out,              // (B, Hq, D)
    int Hq, int Hkv, int S, float scale) {
  constexpr int kCols = D / 32;
  extern __shared__ float smem[];   // kWarps x (g x D) accumulators
  __shared__ float sm_m[kWarps][kMaxGroup], sm_l[kWarps][kMaxGroup];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = min(max(lengths[b], 0), S);
  const T* qp = q + (static_cast<size_t>(b) * Hq + static_cast<size_t>(kvh) * g) * D;

  float qr[kMaxGroup][kCols], m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][kCols];
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) {
    m[r] = cato::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      qr[r][c] = r < g ? cato::to_float(qp[r * D + lane + 32 * c]) : 0.f;
      acc[r][c] = 0.f;
    }
  }

  const size_t pos_stride = static_cast<size_t>(Hkv) * D;
  const size_t base = (static_cast<size_t>(b) * S * Hkv + kvh) * D;
  for (int j = warp; j < n; j += kWarps) {
    const T* kr = k_cache + base + j * pos_stride;
    const T* vr = v_cache + base + j * pos_stride;
    float kv[kCols], vv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      kv[c] = cato::to_float(kr[lane + 32 * c]);
      vv[c] = cato::to_float(vr[lane + 32 * c]);
    }
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) {
      if (r >= g) break;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) s = fmaf(qr[r][c], kv[c], s);
      s = cato::warp_sum(s) * scale;
      const float m_new = fmaxf(m[r], s);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = acc[r][c] * alpha + p * vv[c];
      m[r] = m_new;
    }
  }

  // merge the warps' partial states
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) {
    if (r >= g) break;
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      smem[(warp * g + r) * D + lane + 32 * c] = acc[r][c];
  }
  __syncthreads();
  T* op = out + (static_cast<size_t>(b) * Hq + static_cast<size_t>(kvh) * g) * D;
  for (int i = threadIdx.x; i < g * D; i += kThreads) {
    const int r = i / D;
    float mx = cato::kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm_m[w][r] - mx);
      den += sm_l[w][r] * e;
      num += smem[w * g * D + i] * e;
    }
    op[i] = cato::from_float<T>(den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int Hq, int Hkv, int S, float scale,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * kWarps * (Hq / Hkv) * D;
  cudaError_t err =
      cato::allow_shared_memory(decode_attention_kernel<T, D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_kernel<T, D><<<dim3(Hkv, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), Hq, Hkv, S,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* lengths,
             void* out, int B, int Hq, int Hkv, int S, int D, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, lengths, out, B, Hq, Hkv, S, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, B, Hq, Hkv, S, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, B, Hq, Hkv, S, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise. `bf16`
// selects bfloat16 q and caches (else float32); D is 32, 64 or 128; Hq is
// a multiple of Hkv with Hq / Hkv <= 16. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* out, int B, int Hq, int Hkv, int S, int D,
    int bf16, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  return bf16 ? launch_d<__nv_bfloat16>(q, k_cache, v_cache, len, out, B, Hq,
                                        Hkv, S, D, scale, s)
              : launch_d<float>(q, k_cache, v_cache, len, out, B, Hq, Hkv, S,
                                D, scale, s);
}
