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
// Design: a one-shot grid of 256-thread blocks (no grid-stride loop: the
// earlier design's persistent loop ran a few percent behind torch.mul on
// an H100), each thread taking kUnroll 16-byte vectors (4 floats or 8
// bfloat16) a block-width apart, all of its loads issued before any
// store: one vector a thread for float32, four for bfloat16, whose
// conversions give each vector more work to overlap.  Other unrolls and
// the evict-first cache hints timed no better (`kernel_split.py --kernel
// k12` builds them), nor did an L2 prefetch hint or other block sizes.
// The last block also takes the tail that is not a whole vector.  Each
// element is one float32 multiply (bfloat16 upcast exactly, the product
// rounded to nearest-even bfloat16), which is what PyTorch's x * scale
// computes, so the result is bitwise its plain version's at every scale
// and type.  (At bfloat16, x * 1.0000001 is x: the product is within half
// a bfloat16 ulp, as the Pallas probe's weak-typed constant also rounds to
// 1.0.)
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnrollF32 = 1;   // 16-byte vectors a thread, float32
constexpr int kUnrollBf16 = 4;  // ... bfloat16

template <typename T>
constexpr int kUnroll = sizeof(T) == 2 ? kUnrollBf16 : kUnrollF32;

template <typename T>
__device__ __forceinline__ T g2v_scale_elem(T x, float s);
template <>
__device__ __forceinline__ float g2v_scale_elem(float x, float s) { return x * s; }
template <>
__device__ __forceinline__ __nv_bfloat16 g2v_scale_elem(__nv_bfloat16 x, float s) {
  return __float2bfloat16_rn(__bfloat162float(x) * s);
}

template <typename T>
__device__ __forceinline__ uint4 g2v_scale_vec(uint4 v, float s) {
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int j = 0; j < static_cast<int>(16 / sizeof(T)); ++j) e[j] = g2v_scale_elem(e[j], s);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_scale_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, size_t n16,
                    const T* __restrict__ xs, T* __restrict__ outs, size_t n, float scale) {
  constexpr int kPer = 16 / sizeof(T), U = kUnroll<T>;
  const size_t base = static_cast<size_t>(blockIdx.x) * kThreads * U + threadIdx.x;
  uint4 v[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const size_t i = base + static_cast<size_t>(k) * kThreads;
    if (i < n16) v[k] = __ldg(x + i);
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const size_t i = base + static_cast<size_t>(k) * kThreads;
    if (i < n16) out[i] = g2v_scale_vec<T>(v[k], scale);
  }
  if (blockIdx.x + 1 == gridDim.x) {
    for (size_t i = kPer * n16 + threadIdx.x; i < n; i += kThreads) {
      outs[i] = g2v_scale_elem(xs[i], scale);
    }
  }
}

template <typename T>
int launch(const void* x, void* out, long long n, float scale, cudaStream_t st) {
  const size_t n16 = static_cast<size_t>(n) / (16 / sizeof(T));
  const size_t per_block = static_cast<size_t>(kThreads) * kUnroll<T>;
  const size_t grid = std::max<size_t>(1, (n16 + per_block - 1) / per_block);
  if (grid > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  stream_scale_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), n16, static_cast<const T*>(x),
      static_cast<T*>(out), static_cast<size_t>(n), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out start on 16-byte boundaries (the wrapper checks); bf16 picks
// the element type.
G2V_EXPORT int k12_stream_scale(const void* x, void* out, long long n, float scale, int bf16,
                                void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, out, n, scale, st)
              : launch<float>(x, out, n, scale, st);
}
