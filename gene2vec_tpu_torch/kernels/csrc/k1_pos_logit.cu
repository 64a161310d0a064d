// K1 — positive gather and logit.
//
// Replaces: gene2vec_tpu/sgns/step.py:705-734 (_step_stratified's positive
// side: v = emb[centers], u = ctx[contexts], pos_logit = sum(v*u),
// g_pos = sigmoid(pos_logit) - 1, and the softplus(-pos_logit) loss term).
// The reference moves head/mid rows with one-hot MXU matmuls
// (_dense_slab_gather, step.py:522-558); on the GPU a row gather gives the
// same values, so every example takes the gather.
//
// Bound on the H100: bytes.  The function reads the ids and each distinct
// emb and ctx row once, and writes v and u (which K2-K4 reuse), g_pos and
// the loss as float32: at E = 8192, D = 200 and the step's Zipf ids
// (3,052 + 3,000 distinct rows) that is 18.1 MB, 0.0054 ms at 3.35 TB/s;
// bfloat16 tables (table_dtype="bfloat16") halve the row reads: 15.7 MB,
// 0.0047 ms.  v, u, g_pos and the loss stay float32 (the reference's
// .astype(compute_dtype) on the gathered rows).
//
// Design: a persistent grid (the SM count times the kernel's occupancy)
// of warps, a warp an example at a time, the next example's two ids in
// flight while the current rows move.  When D is a multiple of a 16-byte
// chunk (4 float32 or 8 bfloat16 elements) and at most 256, a lane loads
// its NC chunks of both rows in 16-byte loads, all of them before any is
// used (NC is a compile-time count, so nothing waits on a loop bound),
// stores them to v and u as float4s and sums their products; the dot
// reduces with warp shuffles and lane 0 writes the two scalars.  Other
// widths take an element-wise loop.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 256;  // widths the chunked kernel holds in registers

__device__ __forceinline__ void write_scalars(float s, int e, int lane, float* g_pos,
                                              float* loss_pos) {
  s = g2v_warp_sum(s);
  if (lane == 0) {
    g_pos[e] = g2v_sigmoid(s) - 1.0f;
    loss_pos[e] = g2v_softplus(-s);
  }
}

// D % kElems == 0, D <= 32 * NC * kElems; every row 16-byte aligned.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    pos_logit_chunks_kernel(const T* __restrict__ emb, const T* __restrict__ ctx,
                            const int* __restrict__ centers, const int* __restrict__ contexts,
                            float* __restrict__ v, float* __restrict__ u,
                            float* __restrict__ g_pos, float* __restrict__ loss_pos, int E,
                            int D) {
  constexpr int W = G2vChunk<T>::kElems;
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * kThreads) >> 5;
  const int chunks = D / W;
  int e = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  int c = 0, x = 0;
  if (e < E) {
    c = __ldg(centers + e);
    x = __ldg(contexts + e);
  }
  for (; e < E; e += warps) {
    const T* er = emb + static_cast<size_t>(c) * D;
    const T* cr = ctx + static_cast<size_t>(x) * D;
    uint4 a[NC], b[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int q = lane + 32 * j;
      if (q < chunks) {
        a[j] = g2v_ld_chunk(er + q * W);
        b[j] = g2v_ld_chunk(cr + q * W);
      }
    }
    if (e + warps < E) {  // the next example's ids, in flight with the rows
      c = __ldg(centers + e + warps);
      x = __ldg(contexts + e + warps);
    }
    float* vr = v + static_cast<size_t>(e) * D;
    float* ur = u + static_cast<size_t>(e) * D;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int q = lane + 32 * j;
      if (q < chunks) {
        float fa[W], fb[W];
        g2v_chunk_floats(a[j], fa);
        g2v_chunk_floats(b[j], fb);
        g2v_st_floats(vr + q * W, fa);
        g2v_st_floats(ur + q * W, fb);
#pragma unroll
        for (int i = 0; i < W; ++i) s = fmaf(fa[i], fb[i], s);
      }
    }
    write_scalars(s, e, lane, g_pos, loss_pos);
  }
}

// Any D: lanes stride over the columns, one element at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pos_logit_elems_kernel(const T* __restrict__ emb, const T* __restrict__ ctx,
                           const int* __restrict__ centers, const int* __restrict__ contexts,
                           float* __restrict__ v, float* __restrict__ u,
                           float* __restrict__ g_pos, float* __restrict__ loss_pos, int E,
                           int D) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * kThreads) >> 5;
  for (int e = (blockIdx.x * kThreads + threadIdx.x) >> 5; e < E; e += warps) {
    const T* er = emb + static_cast<size_t>(__ldg(centers + e)) * D;
    const T* cr = ctx + static_cast<size_t>(__ldg(contexts + e)) * D;
    float* vr = v + static_cast<size_t>(e) * D;
    float* ur = u + static_cast<size_t>(e) * D;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float a = g2v_ld(er + d);
      const float b = g2v_ld(cr + d);
      vr[d] = a;
      ur[d] = b;
      s = fmaf(a, b, s);
    }
    write_scalars(s, e, lane, g_pos, loss_pos);
  }
}

// Launches `kernel` on a persistent grid: at most the SM count times its
// occupancy (asked once per kernel), at most one warp an example.
template <typename T, typename Kernel>
int launch(Kernel kernel, int& occupancy, const T* emb, const T* ctx, const int* centers,
           const int* contexts, float* v, float* u, float* g_pos, float* loss_pos, int E, int D,
           cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (occupancy == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) != cudaSuccess ||
        n < 1) {
      n = 1;
    }
    occupancy = n;
  }
  const long long want = (static_cast<long long>(E) * 32 + kThreads - 1) / kThreads;
  const long long blocks =
      std::max(1LL, std::min(want, static_cast<long long>(sms) * occupancy));
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(emb, ctx, centers, contexts, v, u,
                                                            g_pos, loss_pos, E, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pos_logit(const T* emb, const T* ctx, const int* centers, const int* contexts,
                     float* v, float* u, float* g_pos, float* loss_pos, int E, int D,
                     cudaStream_t s) {
  constexpr int W = G2vChunk<T>::kElems;
  constexpr int NC = kMaxD / (32 * W);  // chunks a lane holds: 2 float32, 1 bfloat16
  static int occ_chunks = 0, occ_elems = 0;
  const bool chunked = D % W == 0 && D <= kMaxD && g2v_aligned16(emb) && g2v_aligned16(ctx) &&
                       g2v_aligned16(v) && g2v_aligned16(u);
  if (chunked)
    return launch(pos_logit_chunks_kernel<T, NC>, occ_chunks, emb, ctx, centers, contexts, v, u,
                  g_pos, loss_pos, E, D, s);
  return launch(pos_logit_elems_kernel<T>, occ_elems, emb, ctx, centers, contexts, v, u, g_pos,
                loss_pos, E, D, s);
}

}  // namespace

// bf16: 0 for float32 tables, 1 for bfloat16 tables (emb and ctx alike).
G2V_EXPORT int k1_pos_logit(const void* emb, const void* ctx,
                            const int* centers, const int* contexts, float* v,
                            float* u, float* g_pos, float* loss_pos, int E,
                            int D, int bf16, void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_pos_logit(static_cast<const __nv_bfloat16*>(emb),
                            static_cast<const __nv_bfloat16*>(ctx), centers, contexts, v, u,
                            g_pos, loss_pos, E, D, s);
  return launch_pos_logit(static_cast<const float*>(emb), static_cast<const float*>(ctx),
                          centers, contexts, v, u, g_pos, loss_pos, E, D, s);
}
