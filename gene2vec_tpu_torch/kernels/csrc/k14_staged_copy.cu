// K14 — staged copy: out = scale * x, each tile staged through shared
// memory by the Tensor Memory Accelerator, optionally with a block of
// rows taken from a dynamic offset.
//
// Replaces the Pallas staging probes, all (N, D) float32:
//   experiments/test_dma2.py:83 (callh): out = x * 2 in aligned 8-row
//     tiles, (1024, 256);
//   experiments/test_vmem_dma.py:24 (vmem_probe): out = x * 2 with all of
//     x resident in VMEM, a capacity probe at 8-60 MB;
//   experiments/test_feature_matrix.py:35 (calla, scalar-prefetch grid,
//     x * 2), :62 (callb, HBM->VMEM DMA with a semaphore, then copy), :79
//     (callc, scratch staging, x * 2), :96 (calld, scratch and semaphore
//     as kernel arguments, DMA, copy), :114 (calle, direct read of an HBM
//     ref, copy), :132 (callf, SMEM scalar dynamic slice: out[0:8] =
//     x[i:i+8], out[8:] = x[0:N-8]), all (256, 256).
// Hopper's counterpart of make_async_copy plus a DMA semaphore is a bulk
// copy (cp.async.bulk) completing on an mbarrier; scalar prefetch becomes
// a block loading its own index.  Together:
//   out[r] = scale * x[off + r]    for r <  head  (off read from a device
//                                    int32 by the block, clamped so the
//                                    rows lie in x, as dynamic_slice does)
//   out[r] = scale * x[r - head]   for r >= head
// with head = 0 a plain scaled copy (callb-e, callh, vmem_probe), head = N
// a copy from a dynamic row (calla), head = 8 callf.
//
// Bound on the H100: bytes — x read once and out written once (2 * N * D
// * 4 bytes: 0.5 MB for the (256, 256) probes, 16-120 MB for vmem_probe).
//
// Design: a one-shot grid, one tile of tile_rows rows a block; the blocks
// an SM holds at once are the ring, each waiting on its own tile while
// the others' copies are in flight.  Thread 0 initialises an mbarrier for
// one arrival, arms it with the tile's byte count (arrive.expect_tx) and
// issues one bulk copy global -> shared for each contiguous source range
// of the tile (two where the tile straddles head); every thread waits on
// the barrier's phase 0, then scales its 16-byte vectors and stores them
// straight to device memory.  The offset is read only by a block with
// rows below head, and only when 0 < head < N (head = N clamps every
// offset to 0): the earlier design read it in front of every block's
// copy, a device-memory latency before calla's only load.  Tried on an
// H100 and not kept: persistent blocks, two an SM, each walking its tiles
// through a ring of 2-4 slots with one elected thread keeping the next
// loads in flight, the tile sent back by one bulk store (cp.async.bulk
// shared -> global, bulk_group, wait_group.read before a slot's reuse)
// or by the threads' stores.  It was no faster at any size and slower on
// the small probes and at 8, 16 and 60 MB: the resident blocks an SM
// holds already keep loads in flight, and a ring's set-up sits on a small
// probe's critical path.  Tiles run from 8 rows (callh) to the card's
// opt-in shared-memory limit (dynamic shared memory, set with
// cudaFuncSetAttribute above 48 KB).  Bulk copies need
// 16-byte aligned addresses and sizes: the wrapper requires D % 4 == 0
// and aligned bases.  (Every thread staging its own vectors by 16-byte
// cp.async copies, in place of the bulk copy and its barrier, was slower
// on the small probes too.)
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__global__ void staged_copy_kernel(const float* __restrict__ x, float* __restrict__ out, int N,
                                   int D, int tile_rows, int head,
                                   const int* __restrict__ offset, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar_word;
  float* tile = reinterpret_cast<float*>(smem);
  const int r0 = blockIdx.x * tile_rows;
  const int r1 = min(r0 + tile_rows, N);
  const int h1 = min(r1, head);  // rows r0 .. h1 come from the offset
  const uint32_t row_bytes = static_cast<uint32_t>(D) * 4u;
  const int n4 = (r1 - r0) * D / 4;
  const uint32_t bar = smem_addr(&bar_word);
  if (threadIdx.x == 0) {
    // the offset's load in flight while the barrier is set up
    const int raw = r0 < h1 && head < N ? __ldg(offset) : 0;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(static_cast<uint32_t>(r1 - r0) * row_bytes)
                 : "memory");
    const int t0 = max(r0, head);
    if (t0 < r1) {  // the rows past head first: they need no offset
      bulk_load(tile + static_cast<size_t>(t0 - r0) * D, x + static_cast<size_t>(t0 - head) * D,
                static_cast<uint32_t>(r1 - t0) * row_bytes, bar);
    }
    if (r0 < h1) {
      const int off = min(max(raw, 0), N - head);
      bulk_load(tile, x + static_cast<size_t>(off + r0) * D,
                static_cast<uint32_t>(h1 - r0) * row_bytes, bar);
    }
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  wait_phase(bar, 0);
  const float4* src = reinterpret_cast<const float4*>(tile);
  float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(r0) * D);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    float4 v = src[i];
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    dst[i] = v;
  }
}

}  // namespace

// Dynamic shared memory a staged_copy block may use on `device`: the
// card's opt-in limit less the kernel's static shared memory.
G2V_EXPORT int k14_max_tile_bytes(int device, int* bytes) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, staged_copy_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bytes = optin - static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

// x, out: (N, D) float32, 16-byte aligned, D % 4 == 0; offset: a device
// int32 (its first element is read) or null; 0 <= head <= N.
G2V_EXPORT int k14_staged_copy(const float* x, float* out, int N, int D, int tile_rows,
                               int head, const int* offset, float scale, void* stream) {
  if (N == 0) return 0;
  const size_t bytes = static_cast<size_t>(tile_rows) * D * 4;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        staged_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (N + tile_rows - 1) / tile_rows;
  staged_copy_kernel<<<blocks, 256, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, out, N, D, tile_rows, head, offset, scale);
  return static_cast<int>(cudaGetLastError());
}
