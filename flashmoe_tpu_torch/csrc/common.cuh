// Shared helpers of the port's Hopper kernels: dtype conversion, warp
// reductions, activations and 16-byte cp.async copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fm {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
// round to nearest even, as torch's .to(torch.bfloat16) and JAX's astype
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// activation codes shared with the Python wrappers
enum Act { ACT_RELU = 0, ACT_GELU = 1, ACT_SILU = 2 };

// relu; gelu in its tanh approximation (jax.nn.gelu's default,
// F.gelu(approximate="tanh")); silu = x * sigmoid(x)
__device__ __forceinline__ float act_f(float x, int act) {
  if (act == ACT_RELU) return fmaxf(x, 0.f);
  if (act == ACT_GELU) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  return x / (1.f + expf(-x));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace fm
