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

// A 16-byte chunk of a table row: 4 float32 or 8 bfloat16 elements.  A
// row of D % kElems == 0 elements from a 16-byte aligned table loads in
// such chunks (every row then starts 16-byte aligned).
template <typename T>
struct G2vChunk;
template <>
struct G2vChunk<float> {
  static constexpr int kElems = 4;
};
template <>
struct G2vChunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
};

__device__ __forceinline__ uint4 g2v_ld_chunk(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// A chunk's elements as float32 (exact for both element types).
__device__ __forceinline__ void g2v_chunk_floats(const uint4& raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void g2v_chunk_floats(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

// N (4 or 8) float32 values at p, 16-byte aligned, as float4 loads / stores.
template <int N>
__device__ __forceinline__ void g2v_ld_floats(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
    x[4 * i] = q.x;
    x[4 * i + 1] = q.y;
    x[4 * i + 2] = q.z;
    x[4 * i + 3] = q.w;
  }
}
template <int N>
__device__ __forceinline__ void g2v_st_floats(float* p, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    reinterpret_cast<float4*>(p)[i] =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
}

__host__ __device__ inline bool g2v_aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
