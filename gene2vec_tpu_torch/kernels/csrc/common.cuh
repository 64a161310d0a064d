// Shared helpers for the SGNS step kernels (sm_90a, plain C interface,
// loaded with ctypes).  Each C entry point launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define G2V_EXPORT extern "C" __attribute__((visibility("default")))

// jax.nn.sigmoid = 1 / (1 + exp(-x)); jax.nn.softplus = logaddexp(x, 0).
// Full-precision expf/log1pf (the library builds without fast math).
__device__ __forceinline__ float g2v_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float g2v_softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float g2v_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

G2V_EXPORT const char* g2v_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
