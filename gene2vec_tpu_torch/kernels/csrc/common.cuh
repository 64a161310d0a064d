// Shared helpers for the SGNS step kernels (sm_90a, plain C interface,
// loaded with ctypes).  Each C entry point launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
//
// Tables are float32 or bfloat16 (table_dtype); every table element is
// upcast to float32 on load (the reference's .astype(compute_dtype)), so
// all arithmetic and every accumulator stay float32.  The kernels that
// read tables are templated on the element type T (float or
// __nv_bfloat16) and each C entry point takes an int `bf16` choosing the
// instantiation.
#pragma once

#include <cuda_bf16.h>
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

// One table element as float32 (exact for both element types).
__device__ __forceinline__ float g2v_ld(const float* p) { return *p; }
__device__ __forceinline__ float g2v_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Elements per row load: one float, or 8 bfloat16 in one 16-byte load.
// A float row keeps its element-wise load (and so its summation order).
template <typename T>
struct G2vVec {
  static constexpr int kWidth = 1;
};
template <>
struct G2vVec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
};

// Elements [0, kWidth) at p as float32 in registers; for bfloat16, p must
// be 16-byte aligned (a row of D % 8 == 0 elements from an aligned base).
__device__ __forceinline__ void g2v_ld_vec(const float* p, float (&out)[1]) {
  out[0] = *p;
}
__device__ __forceinline__ void g2v_ld_vec(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

// Store kWidth float32 values at p: one float, or 8 as two 16-byte stores
// (p 32-byte aligned: a float32 row of D % 8 == 0 elements, chunk start).
__device__ __forceinline__ void g2v_st_vec(float* p, const float (&x)[1]) { *p = x[0]; }
__device__ __forceinline__ void g2v_st_vec(float* p, const float (&x)[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(x[0], x[1], x[2], x[3]);
  q[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// How many leading elements of a D-wide row load in chunks of kWidth: all
// of them when D is a multiple of the width (every row then starts
// 16-byte aligned), else none (the row loads element-wise).
template <typename T>
__device__ __forceinline__ int g2v_vec_span(int D) {
  constexpr int W = G2vVec<T>::kWidth;
  return (D % W == 0) ? D : 0;
}

// Adds n floats val(0 .. n-1) into row with atomics, the lanes of one warp
// together: float4 atomics on the row's 16-byte aligned middle, scalar
// ones at its ends (accumulator rows are D + 1 floats apart).
template <typename Val>
__device__ __forceinline__ void g2v_add_row(float* row, int n, int lane, Val val) {
  const int head = min(n, static_cast<int>((16 - reinterpret_cast<uintptr_t>(row) % 16) % 16) / 4);
  const int body = (n - head) & ~3;
  if (lane < head) atomicAdd(row + lane, val(lane));
  for (int d = head + 4 * lane; d < head + body; d += 128) {
    atomicAdd(reinterpret_cast<float4*>(row + d),
              make_float4(val(d), val(d + 1), val(d + 2), val(d + 3)));
  }
  const int tail = head + body;
  if (lane < n - tail) atomicAdd(row + tail + lane, val(tail + lane));
}

G2V_EXPORT const char* g2v_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
