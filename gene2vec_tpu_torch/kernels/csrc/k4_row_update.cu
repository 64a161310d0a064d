// K4 — (V, D+1) accumulators and the combiner finalize, both tables.
//
// Replaces: gene2vec_tpu/sgns/step.py:229-263 (_scatter_accumulator,
// _finalize_row_updates) with _row_divisor (:143-172), as used by
// _step_stratified at :800-851: [grad | weight] rows scatter-add by token
// id into a zeroed (V, D+1) float32 accumulator — centers take
// [d_center | 1] into acc_emb, contexts take [g_pos*v | 1] into acc_ctx,
// which already holds K2's head rows and K3's tail blocks — then
// table -= lr * acc[:, :D] / divisor(acc[:, D]), divisor = 1 (sum),
// max(w, 1) (mean) or max(max(w, 1)/32, 1) (capped).
//
// Bound on the H100: bytes.  The finalize visits every row of both tables:
// each reads its (V, D+1) accumulator and reads and writes its (V, D)
// table, ~118 MB at V = 24,447, D = 200, plus ~13 MB of scattered rows —
// ~39 us at 3.35 TB/s.  Visiting all rows is exact: an untouched row has
// acc = 0 and keeps its value (t - lr*0 = t); visiting only touched rows
// would save most of those bytes and is later work.
//
// Design: two launches.  The scatter runs one warp per example, lanes
// striding over D with float atomics (duplicate ids sum in any order).
// The finalize runs one thread per table element, grid y choosing the
// table, with correctly rounded division and multiply so the update is
// t - lr*(a/div) as the reference writes it (no FMA contraction).
#include <algorithm>

#include "common.cuh"

namespace {

__global__ void scatter_kernel(float* __restrict__ acc_emb,
                               float* __restrict__ acc_ctx,
                               const int* __restrict__ centers,
                               const int* __restrict__ contexts,
                               const float* __restrict__ d_center,
                               const float* __restrict__ v,
                               const float* __restrict__ g_pos, int E, int D) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= E) return;  // warp-uniform
  const int D1 = D + 1;
  float* ae = acc_emb + static_cast<size_t>(centers[e]) * D1;
  float* ac = acc_ctx + static_cast<size_t>(contexts[e]) * D1;
  const float* dc = d_center + static_cast<size_t>(e) * D;
  const float* vr = v + static_cast<size_t>(e) * D;
  const float gp = g_pos[e];
  for (int d = lane; d < D; d += 32) {
    atomicAdd(&ae[d], dc[d]);
    atomicAdd(&ac[d], __fmul_rn(gp, vr[d]));
  }
  if (lane == 0) {
    atomicAdd(&ae[D], 1.0f);
    atomicAdd(&ac[D], 1.0f);
  }
}

// combiner: 0 = sum, 1 = mean, 2 = capped (cap 32)
__device__ __forceinline__ float row_divisor(float w, int combiner) {
  w = fmaxf(w, 1.0f);
  if (combiner == 0) return 1.0f;
  if (combiner == 1) return w;
  return fmaxf(w / 32.0f, 1.0f);
}

__global__ void finalize_kernel(float* __restrict__ emb, float* __restrict__ ctx,
                                const float* __restrict__ acc_emb,
                                const float* __restrict__ acc_ctx, float lr,
                                int combiner, int V, int D) {
  float* table = blockIdx.y == 0 ? emb : ctx;
  const float* acc = blockIdx.y == 0 ? acc_emb : acc_ctx;
  const size_t n = static_cast<size_t>(V) * D;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / D;
    const size_t d = i - r * D;
    const float* arow = acc + r * (D + 1);
    const float upd = __fdiv_rn(arow[d], row_divisor(arow[D], combiner));
    table[i] = __fsub_rn(table[i], __fmul_rn(lr, upd));
  }
}

}  // namespace

G2V_EXPORT int k4_row_update(float* emb, float* ctx, float* acc_emb,
                             float* acc_ctx, const int* centers,
                             const int* contexts, const float* d_center,
                             const float* v, const float* g_pos, float lr,
                             int combiner, int E, int V, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  scatter_kernel<<<(E * 32 + threads - 1) / threads, threads, 0, s>>>(
      acc_emb, acc_ctx, centers, contexts, d_center, v, g_pos, E, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(V) * D;
  const int grid = static_cast<int>(
      std::min<size_t>((n + threads - 1) / threads, 132 * 16));
  finalize_kernel<<<dim3(grid, 2), threads, 0, s>>>(emb, ctx, acc_emb, acc_ctx,
                                                     lr, combiner, V, D);
  return static_cast<int>(cudaGetLastError());
}
