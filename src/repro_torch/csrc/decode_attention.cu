// B7: one-token GQA attention against a KV cache (decode), split over the
// cache axis.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py
// `decode_attention_kernel_call` (body `_dec_kernel`), reached through
// src/repro/kernels/ops.py `decode_attention`; it computes what
// src/repro/models/layers.py `decode_attention_xla` computes on the
// reference's model path. For batch b and query head h:
//   out[b, h] = sum_{j < lengths[b]} softmax_j(scale * q[b,h] . k[b,j,h/g])
//               v[b,j,h/g]
// with the TPU kernel's semantics: softmax in float32 from a running max of
// -1e30, a sequence of length 0 giving 0, output in q's type.
//
// Layout: split-S, two kernels. The TPU grid walks (batch, kv head, cache
// block) with the cache axis innermost. Here the cache axis is cut into
// n_split contiguous splits of split_len positions (a multiple of kTile),
// both from the host's shapes (B, Hkv, S) alone, never from `lengths`, so
// the launch needs no host read and a CUDA graph can capture it.
// `decode_split_kernel` runs one block per (kv head, batch, split): the
// group's g query heads against the split's positions below lengths[b]; a
// split wholly at or past lengths[b] writes the empty state (m = -1e30,
// l = 0, acc = 0). `decode_merge_kernel` then merges each (batch, head)
// row's splits in split order.
//
// Within a split, in this order (repro_torch/kernels/decode_attention.py
// `decode_attention_plain` repeats each step):
//  1. scores: the K rows stream through shared memory in tiles of kTile
//     positions by cp.async, two tiles in flight; a lane holds kVec (8)
//     consecutive columns of a row, read as 16-byte vectors, so D / 8 lanes
//     share a row. A lane's dot product is a chain over its 8 columns (a
//     product, then add by add: `lane_dot`), the row's lanes meet in an
//     xor butterfly (for g = 4, its first two stages as a transpose-reduce:
//     the same tree), and the sum is multiplied by scale. Each add rounds
//     once after an exact bf16 product (an fmaf), or after the rounded
//     float32 product (__fmul_rn then __fadd_rn, which torch repeats where
//     it could not repeat an fmaf of float32 values).
//  2. m = max(-1e30, the split's scores); p = expf(s - m).
//  3. the V rows stream through the same buffers (the first two load
//     during step 2). Position j of the split belongs to stripe
//     j % kStripes (one row group of a warp each); a stripe adds, in
//     position order from 0, l += p and acc += p * v.
//  4. the stripes meet: within a warp in adjacent pairs ((0+1)+(2+3))...,
//     then the warps' sums in warp order. The split writes (acc[D], m, l)
//     in float32 to the workspace (B, Hq, n_split, D + 2).
// The merge: M = max of the splits' m; for each split in order, e =
// expf(m_s - M), L += l_s * e, O += acc_s * e; out = L > 0 ? O / L : 0.
// An empty split adds exactly 0.
//
// Bound on the H100. Decode reads each valid cache entry once and does 4
// FLOPs per element: at qwen3-8b's decode shape (B 8, 32 q and 8 kv heads,
// S 4096, D 128) in bf16, 134 MB for full lengths, 0.040 ms at 3.35 TB/s,
// so bytes bound it. The split gives (Hkv, B, n_split) blocks (1024
// there, about 8 per SM, of which about 5 are resident at once: splits
// past a sequence's length end at once, and short splits keep the SMs
// evenly loaded) and each block keeps up to two 16 KB tiles loading while
// it computes. Tensor cores are not needed: g is 4 or 1
// on the main path.
//
// Head dims. The kernel is compiled for the tile widths Dp = 32, 64 and
// 128 (4, 8 or 16 lanes a row). Any other even D up to 128 (the reduced
// configs' 8, 12, 16 and 20) runs the next width's kernel with its rows
// zero-padded to Dp inside shared memory: the loads fill columns below D
// (16-, 8- or 4-byte cp.async pieces, the widest that divides a row: a
// bf16 row of D 12 or 20 is not 16-byte aligned), the padding is zeroed
// once, and only columns below D reach the workspace. A zero column adds
// an exact 0 to every chain, so the result is bitwise the Dp kernel's on
// the zero-padded inputs, which is what the plain version computes.
#include <type_traits>

#include "lm_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 8;        // columns a lane holds of a row
constexpr int kTile = 64;      // positions a cp.async stage holds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
// a piece of 16, 8 or 4 bytes (the padded rows' loads)
__device__ __forceinline__ void cp_async_piece(void* smem, const void* gmem,
                                               int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 consecutive values (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// A lane's dot product over its kVec columns: the first product, then
// each next one added in order. bf16 values multiply exactly in float32,
// so there an fmaf rounds once, as product-then-add does; float32
// products round, so they are multiplied and added apart (the plain
// version repeats either).
template <typename T>
__device__ __forceinline__ float lane_dot(const float (&a)[kVec],
                                          const float (&b)[kVec]) {
  float c = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int e = 1; e < kVec; ++e) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      c = __fmaf_rn(a[e], b[e], c);
    } else {
      c = __fadd_rn(c, __fmul_rn(a[e], b[e]));
    }
  }
  return c;
}

// Dynamic shared memory of one split block: the two tile buffers, the
// split's g x split_len scores, the warps' partial sums (rows of Dp).
template <typename T, int Dp, int G>
size_t split_smem_bytes(int split_len) {
  return 2 * kTile * Dp * sizeof(T) + sizeof(float) * G * split_len +
         sizeof(float) * kWarps * G * (Dp + 1);
}

// Dp is the tile width; kPad runs a head dim d_arg < Dp on rows padded to
// Dp (else D = Dp), its cache rows loaded in `piece`-byte pieces.
template <typename T, int Dp, int G, bool kPad>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q,          // (B, Hq, D)
    const T* __restrict__ k_cache,    // (B, S, Hkv, D)
    const T* __restrict__ v_cache,    // (B, S, Hkv, D)
    const int* __restrict__ lengths,  // (B,)
    float* __restrict__ ws,           // (B, Hq, n_split, D + 2)
    int Hq, int Hkv, int S, int split_len, int n_split, float scale,
    int d_arg, int piece) {
  constexpr int kLanesPerRow = Dp / kVec;          // 16, 8, 4
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;  // 2, 4, 8
  constexpr int kStripes = kWarps * kRowsPerWarp;  // 8, 16, 32
  static_assert(kTile % kStripes == 0, "a tile holds whole stripe rounds");
  const int D = kPad ? d_arg : Dp;
  // cp.async pieces a row and elements a piece
  const int pieces = kPad ? D * static_cast<int>(sizeof(T)) / piece
                          : Dp * static_cast<int>(sizeof(T)) / 16;
  const int per = kPad ? piece / static_cast<int>(sizeof(T))
                       : 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  float* sc = reinterpret_cast<float*>(smem_raw + 2 * kTile * Dp * sizeof(T));
  float* part = sc + G * split_len;      // kWarps x G x Dp
  float* lpart = part + kWarps * G * Dp; // kWarps x G
  __shared__ float sm_m[G];

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int g = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane % kLanesPerRow;
  const int in_warp = lane / kLanesPerRow;
  const int stripe = warp * kRowsPerWarp + in_warp;
  const int n = min(max(lengths[b], 0), S);
  const int start = split * split_len;
  const int len = min(split_len, n - start);
  const size_t row_stride = static_cast<size_t>(n_split) * (D + 2);
  float* wrow = ws + ((static_cast<size_t>(b) * Hq +
                       static_cast<size_t>(kvh) * g) * n_split + split) *
                          (D + 2);
  if (len <= 0) {
    for (int i = threadIdx.x; i < g * (D + 2); i += kThreads) {
      const int r = i / (D + 2), c = i % (D + 2);
      wrow[r * row_stride + c] = c == D ? cato::kNegInf : 0.f;
    }
    return;
  }
  const size_t pos_stride = static_cast<size_t>(Hkv) * D;
  const size_t base = (static_cast<size_t>(b) * S * Hkv + kvh) * D +
                      static_cast<size_t>(start) * pos_stride;
  const int n_tiles = (len + kTile - 1) / kTile;
  if constexpr (kPad) {
    // the padding columns stay 0: no load writes them
    for (int i = threadIdx.x; i < 2 * kTile * Dp; i += kThreads)
      tiles[i] = cato::from_float<T>(0.f);
    __syncthreads();
  }
  auto load_tile = [&](const T* src, int t) {
    T* dst = tiles + (t & 1) * kTile * Dp;
    const int rows = min(kTile, len - t * kTile);
    for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
      const int row = i / pieces, c = i % pieces;
      const T* from = src + static_cast<size_t>(t * kTile + row) * pos_stride +
                      c * per;
      if constexpr (kPad) {
        cp_async_piece(dst + row * Dp + c * per, from, piece);
      } else {
        cp_async16(dst + row * Dp + c * per, from);
      }
    }
    cp_async_commit();
  };
  // Tiles t and t + 1 are in flight when tile t is waited for; tile t + 2
  // goes into t's buffer once every warp is done with it (`refill`).
  auto arrive = [&](int t) {
    if (t + 1 < n_tiles) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };
  auto refill = [&](const T* src, int t) {
    __syncthreads();
    if (t + 2 < n_tiles) load_tile(src, t + 2);
  };

  // 1. scores
  {
    float qr[G][kVec];
    const T* qp = q + (static_cast<size_t>(b) * Hq +
                       static_cast<size_t>(kvh) * g) * D + slot * kVec;
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r < g && kPad) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          qr[r][e] = slot * kVec + e < D ? cato::to_float(qp[r * D + e]) : 0.f;
      } else if (r < g) {
        load8(qp + r * D, qr[r]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[r][e] = 0.f;
      }
    }
    load_tile(k_cache + base, 0);
    if (n_tiles > 1) load_tile(k_cache + base, 1);
    for (int t = 0; t < n_tiles; ++t) {
      arrive(t);
      const T* tile = tiles + (t & 1) * kTile * Dp;
      const int rows = min(kTile, len - t * kTile);
      // warp-uniform bound: every lane of the warp takes part in the
      // butterfly; a row group past the tile's rows computes on zeros
      for (int row0 = warp * kRowsPerWarp; row0 < rows; row0 += kStripes) {
        const int row = row0 + in_warp;
        const bool valid = row < rows;
        float kv[kVec];
        if (valid) {
          load8(tile + row * Dp + slot * kVec, kv);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kv[e] = 0.f;
        }
        float* out_row = sc + t * kTile + row;
        if (G == 4 && g == 4) {
          // four rows a lane: the first two butterfly stages hand the
          // partner lane the rows it keeps (a transpose-reduce, 3 shuffles
          // where the butterflies take 8); each row's sum is the same xor
          // tree over the same lanes, so the same bits
          float c[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) c[r] = lane_dot<T>(qr[r], kv);
          constexpr int o1 = kLanesPerRow / 2, o2 = kLanesPerRow / 4;
          const bool hi1 = slot & o1, hi2 = slot & o2;
          float k0 = hi1 ? c[2] : c[0], k1 = hi1 ? c[3] : c[1];
          k0 = __fadd_rn(k0, __shfl_xor_sync(kFull, hi1 ? c[0] : c[2], o1));
          k1 = __fadd_rn(k1, __shfl_xor_sync(kFull, hi1 ? c[1] : c[3], o1));
          float k = hi2 ? k1 : k0;
          k = __fadd_rn(k, __shfl_xor_sync(kFull, hi2 ? k0 : k1, o2));
#pragma unroll
          for (int o = o2 / 2; o > 0; o >>= 1)
            k = __fadd_rn(k, __shfl_xor_sync(kFull, k, o));
          const int r = (hi1 ? 2 : 0) + (hi2 ? 1 : 0);
          if (valid && (slot & (o2 - 1)) == 0)
            out_row[r * split_len] = __fmul_rn(k, scale);
        } else {
#pragma unroll
          for (int r = 0; r < G; ++r) {
            if (r >= g) break;
            float c = lane_dot<T>(qr[r], kv);
#pragma unroll
            for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
              c = __fadd_rn(c, __shfl_xor_sync(kFull, c, o));
            if (valid && slot == 0) out_row[r * split_len] = __fmul_rn(c, scale);
          }
        }
      }
      refill(k_cache + base, t);
    }
  }
  // both buffers are free: the first V tiles load while the scores turn
  // into p
  load_tile(v_cache + base, 0);
  if (n_tiles > 1) load_tile(v_cache + base, 1);

  // 2. the split's maximum, then p = exp(s - m) in place
  for (int r = warp; r < g; r += kWarps) {
    float mx = cato::kNegInf;
    for (int i = lane; i < len; i += 32) mx = fmaxf(mx, sc[r * split_len + i]);
    mx = cato::warp_max(mx);
    if (lane == 0) sm_m[r] = mx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * len; i += kThreads) {
    const int r = i / len, j = i % len;
    float* s = sc + r * split_len + j;
    *s = expf(__fsub_rn(*s, sm_m[r]));
  }
  __syncthreads();

  // 3. l and acc per stripe, in position order
  float acc[G][kVec], l[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    arrive(t);
    const T* tile = tiles + (t & 1) * kTile * Dp;
    const int rows = min(kTile, len - t * kTile);
    for (int row = stripe; row < rows; row += kStripes) {
      float vv[kVec];
      load8(tile + row * Dp + slot * kVec, vv);
      const float* pr = sc + t * kTile + row;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r >= g) break;
        const float p = pr[r * split_len];
        l[r] = __fadd_rn(l[r], p);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[r][e] = __fadd_rn(acc[r][e], __fmul_rn(p, vv[e]));
      }
    }
    refill(v_cache + base, t);
  }

  // 4. the stripes meet: adjacent pairs within the warp, then warp order
#pragma unroll
  for (int o = kLanesPerRow; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r >= g) break;
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(kFull, l[r], o));
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[r][e] = __fadd_rn(acc[r][e], __shfl_xor_sync(kFull, acc[r][e], o));
    }
  }
  if (in_warp == 0) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r >= g) break;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        part[(warp * G + r) * Dp + slot * kVec + e] = acc[r][e];
      if (slot == 0) lpart[warp * G + r] = l[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float a = part[r * Dp + d];
    for (int w = 1; w < kWarps; ++w)
      a = __fadd_rn(a, part[(w * G + r) * Dp + d]);
    wrow[r * row_stride + d] = a;
    if (d == 0) {
      float ls = lpart[r];
      for (int w = 1; w < kWarps; ++w) ls = __fadd_rn(ls, lpart[w * G + r]);
      wrow[r * row_stride + D] = sm_m[r];
      wrow[r * row_stride + D + 1] = ls;
    }
  }
}

// One block per (batch, query head) row: its splits merged in split order.
// With `stats` (float32 (B, Hq, 2), or null) the thread of column 0 also
// writes the row's (M, L): the maximum of the splits' maxima and the
// rescaled sum, the softmax statistics that let ranks holding other
// positions of the same row merge their outputs with this one.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ ws,
                                    T* __restrict__ out,
                                    float* __restrict__ stats, int n_split,
                                    int D) {
  const size_t row = blockIdx.x;
  const float* w = ws + row * n_split * (D + 2);
  float mx = cato::kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, w[s * (D + 2) + D]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.f, O = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ws_s = w + s * (D + 2);
      const float e = expf(__fsub_rn(ws_s[D], mx));
      L = __fadd_rn(L, __fmul_rn(ws_s[D + 1], e));
      O = __fadd_rn(O, __fmul_rn(ws_s[d], e));
    }
    out[row * D + d] = cato::from_float<T>(L > 0.f ? __fdiv_rn(O, L) : 0.f);
    if (stats != nullptr && d == 0) {
      stats[2 * row] = mx;
      stats[2 * row + 1] = L;
    }
  }
}

template <typename T, int Dp, int G, bool kPad>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* ws, void* out, float* stats, int B, int Hq, int Hkv, int S,
           int D, int split_len, int n_split, float scale,
           cudaStream_t stream) {
  const size_t bytes = split_smem_bytes<T, Dp, G>(split_len);
  cudaError_t err =
      cato::allow_shared_memory(decode_split_kernel<T, Dp, G, kPad>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the widest cp.async piece that divides a row of D elements
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int piece = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : 4;
  decode_split_kernel<T, Dp, G, kPad>
      <<<dim3(Hkv, B, n_split), kThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lengths, ws, Hq, Hkv, S, split_len,
          n_split, scale, D, piece);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T><<<B * Hq, D, 0, stream>>>(ws, static_cast<T*>(out),
                                                   stats, n_split, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int Dp, bool kPad>
int launch_g(const void* q, const void* k, const void* v, const int* lengths,
             float* ws, void* out, float* stats, int B, int Hq, int Hkv, int S,
             int D, int split_len, int n_split, float scale,
             cudaStream_t stream) {
  return Hq / Hkv <= 4
             ? launch<T, Dp, 4, kPad>(q, k, v, lengths, ws, out, stats, B, Hq,
                                      Hkv, S, D, split_len, n_split, scale,
                                      stream)
             : launch<T, Dp, 16, kPad>(q, k, v, lengths, ws, out, stats, B, Hq,
                                       Hkv, S, D, split_len, n_split, scale,
                                       stream);
}

// D 32, 64 and 128 run their own width; any other even D up to 128 the
// next width, padded
template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* lengths,
             float* ws, void* out, float* stats, int B, int Hq, int Hkv, int S,
             int D, int split_len, int n_split, float scale,
             cudaStream_t stream) {
  if (D < 2 || D > 128 || D % 2)
    return static_cast<int>(cudaErrorInvalidValue);
#define CATO_DECODE_LAUNCH(DP, PAD)                                       \
  return launch_g<T, DP, PAD>(q, k, v, lengths, ws, out, stats, B, Hq, Hkv, \
                              S, D, split_len, n_split, scale, stream)
  switch (D) {
    case 32: CATO_DECODE_LAUNCH(32, false);
    case 64: CATO_DECODE_LAUNCH(64, false);
    case 128: CATO_DECODE_LAUNCH(128, false);
    default:
      if (D < 32) CATO_DECODE_LAUNCH(32, true);
      if (D < 64) CATO_DECODE_LAUNCH(64, true);
      CATO_DECODE_LAUNCH(128, true);
  }
#undef CATO_DECODE_LAUNCH
}

}  // namespace

// Launches the split kernel and the merge on `stream`, allocates nothing,
// does not synchronise and reads nothing back. `bf16` selects bfloat16 q
// and caches (else float32); D is even, 2 to 128; Hq is a multiple of Hkv
// with Hq / Hkv <= 16; q and the caches start on 16-byte boundaries.
// `workspace` is float32 (B, Hq, n_split, D + 2); split_len is a multiple
// of 64 with n_split * split_len >= S. `stats` is null, or float32 (B,
// Hq, 2) for each row's (M, L) (`decode_merge_kernel`). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* workspace, void* out, void* stats, int B,
    int Hq, int Hkv,
    int S, int D, int bf16, int split_len, int n_split, float scale,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* ws = static_cast<float*>(workspace);
  float* st = static_cast<float*>(stats);
  return bf16 ? launch_d<__nv_bfloat16>(q, k_cache, v_cache, len, ws, out, st,
                                        B, Hq, Hkv, S, D, split_len, n_split,
                                        scale, s)
              : launch_d<float>(q, k_cache, v_cache, len, ws, out, st, B, Hq,
                                Hkv, S, D, split_len, n_split, scale, s);
}
