// Helpers shared by the LM kernels: flash_attention.cu (B6),
// decode_attention.cu (B7) and mamba_scan.cu (B8).
//
// Each kernel reads float32 or bfloat16 tensors, computes in float32 and
// writes its input's type, as the TPU kernels do (`astype(jnp.float32)` on
// load, `astype(o_ref.dtype)` on store). Dot products are explicit fmaf
// chains, or, in B6's bf16 kernel, wgmma on the tensor cores: the library
// is built with --fmad=false, so nothing else is contracted.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cato {

// the TPU kernels' masking value and initial running maximum
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` (needed above
// 48 KB; the H100 lets a block use up to 227 KB).
template <typename Kernel>
inline cudaError_t allow_shared_memory(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace cato
