// K12 — streaming scale, out = x * 1.0000001 over an (n, 256) float32 tensor.
//
// Replaces: experiments/test_bw.py:39 (pallas_copy_loop), the probe of the
// streaming HBM bandwidth a read-modify-write pass reaches: one block of
// rows per grid step through VMEM, at 25, 100 and 400 MB.  On the card the
// same pass is the ceiling for K4's finalize, a streaming pass over both
// tables.  It is on no path the package runs.
//
// Bound on the H100: bytes.  Each element is read once and written once,
// 8 bytes per element: 100 MB in and out, ~63 us at 3.35 TB/s.
//
// Design: a grid-stride loop over 16-byte vectors (float4), a few blocks
// per multiprocessor, each thread keeping independent loads in flight; a
// scalar loop takes the tail when n * 256 is not a multiple of 4 (never
// for this shape).  The multiply is one float32 rounding, the same as
// x * 1.0000001 in PyTorch, so the result is bitwise its plain version's.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr float kScale = 1.0000001f;

__global__ void stream_scale_kernel(const float4* __restrict__ x,
                                    float4* __restrict__ out, size_t n4,
                                    const float* __restrict__ xs,
                                    float* __restrict__ outs, size_t n) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = t; i < n4; i += stride) {
    float4 v = __ldg(x + i);
    v.x *= kScale;
    v.y *= kScale;
    v.z *= kScale;
    v.w *= kScale;
    out[i] = v;
  }
  for (size_t i = 4 * n4 + t; i < n; i += stride) outs[i] = xs[i] * kScale;
}

}  // namespace

G2V_EXPORT int k12_stream_scale(const float* x, float* out, long long n,
                                int sms, void* stream) {
  if (n <= 0) return 0;
  const int threads = 512;
  const size_t n4 = static_cast<size_t>(n) / 4;
  const size_t want = (std::max<size_t>(n4, 1) + threads - 1) / threads;
  const int grid = static_cast<int>(std::min<size_t>(want, static_cast<size_t>(sms) * 4));
  stream_scale_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n4, x, out,
      static_cast<size_t>(n));
  return static_cast<int>(cudaGetLastError());
}
