// K12 — streaming scale, out = x * scale over a float32 or bfloat16 tensor.
//
// Replaces: experiments/test_bw.py:39 (pallas_copy_loop), the probe of the
// streaming HBM bandwidth a read-modify-write pass reaches — one block of
// (n, 256) float32 rows per grid step through VMEM, at 25, 100 and 400
// MB, out = x * 1.0000001 — and experiments/test_lane_gather.py:100
// (stream_copy), the same pass over a transposed (256, 24576) table in
// float32 and bfloat16.  On the card the pass is the ceiling for K4's
// finalize.  It is on no path the package runs.
//
// Bound on the H100: bytes.  Each element is read once and written once:
// 8 bytes an element at float32 (100 MB in and out, ~63 us at 3.35
// TB/s), 4 at bfloat16.
//
// Design: a grid-stride loop over 16-byte vectors (4 floats or 8
// bfloat16), a few blocks per multiprocessor, each thread keeping
// independent loads in flight; a scalar loop takes a tail that is not a
// whole vector.  Each element is one float32 multiply (bfloat16 upcast
// exactly, the product rounded to nearest-even bfloat16), which is what
// PyTorch's x * scale computes, so the result is bitwise its plain
// version's at every scale and type.  (At bfloat16, x * 1.0000001 is x:
// the product is within half a bfloat16 ulp, as the Pallas probe's
// weak-typed constant also rounds to 1.0.)
#include <algorithm>

#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T g2v_scale_elem(T x, float s);
template <>
__device__ __forceinline__ float g2v_scale_elem(float x, float s) { return x * s; }
template <>
__device__ __forceinline__ __nv_bfloat16 g2v_scale_elem(__nv_bfloat16 x, float s) {
  return __float2bfloat16_rn(__bfloat162float(x) * s);
}

template <typename T>
__global__ void stream_scale_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                                    size_t n16, const T* __restrict__ xs,
                                    T* __restrict__ outs, size_t n, float scale) {
  constexpr int kPer = 16 / sizeof(T);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = t; i < n16; i += stride) {
    uint4 v = __ldg(x + i);
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < kPer; ++j) e[j] = g2v_scale_elem(e[j], scale);
    out[i] = v;
  }
  for (size_t i = kPer * n16 + t; i < n; i += stride) outs[i] = g2v_scale_elem(xs[i], scale);
}

template <typename T>
int launch(const void* x, void* out, long long n, float scale, int sms, cudaStream_t st) {
  const int threads = 512;
  const size_t n16 = static_cast<size_t>(n) / (16 / sizeof(T));
  const size_t want = (std::max<size_t>(n16, 1) + threads - 1) / threads;
  const int grid = static_cast<int>(std::min<size_t>(want, static_cast<size_t>(sms) * 4));
  stream_scale_kernel<T><<<grid, threads, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), n16, static_cast<const T*>(x),
      static_cast<T*>(out), static_cast<size_t>(n), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out start on 16-byte boundaries (the wrapper checks); bf16 picks
// the element type.
G2V_EXPORT int k12_stream_scale(const void* x, void* out, long long n, float scale, int bf16,
                                int sms, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, out, n, scale, sms, st)
              : launch<float>(x, out, n, scale, sms, st);
}
