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
// The finalize runs one warp per table row, grid y choosing the table: the
// row's divisor once, lanes over its columns, so no element pays an index
// division (one thread per element with a 64-bit division each measured
// the bfloat16 finalize 21-25% over the float32 one), with correctly
// rounded division and multiply so the update is t - lr*(a/div) as the
// reference writes it (no FMA contraction).
//
// Generic entry points (the other noise modes and hierarchical softmax):
// k4_scatter_rows adds [grads[r] | weights[r]] into acc[idx[r]] for R
// rows (_scatter_accumulator, step.py:229-245) and k4_finalize_rows
// finalizes one (rows, D) table against its accumulator
// (_finalize_row_updates, step.py:248-263).  Same warp-per-row scatter and
// finalize as above.
//
// bfloat16 tables (step.py:179-226, 248-263): the finalize reads the table
// element as float32, computes new = t - lr*(a/div) in float32 in the
// reference's order, and writes it back either by stochastic rounding
// (the reference's salted murmur-finalizer hash of the element's flat
// index r*D + c, bit for bit in wrapping uint32 arithmetic: add the low
// 16 hash bits below the bf16 mantissa, truncate) or by round-to-nearest-
// even (__float2bfloat16_rn, XLA's astype).  Each table's two salt words
// come from the caller.  An untouched row (acc = 0) has zero low bits and
// passes through either way.  The bound falls with the table width: 2+2
// bytes of table per element instead of 4+4, plus the float32 accumulator;
// the hash adds ~6 integer operations per element, under that bound.
#include <algorithm>

#include "common.cuh"

namespace {

// How a finalized float32 value goes back into a bfloat16 table: sr = 1
// stochastic rounding with salts (s0, s1), sr = 0 nearest-even.  Ignored
// for a float32 table.
struct WriteBack {
  int sr;
  uint32_t s0, s1;
};

// step.py:206-209, wrapping uint32 arithmetic
__device__ __forceinline__ uint32_t sr_hash(uint32_t flat, uint32_t s0, uint32_t s1) {
  uint32_t h = (flat ^ s0) * 0x9E3779B1u;
  h = (h ^ (h >> 15)) * 0x85EBCA6Bu;
  return (h ^ (h >> 13)) + s1;
}

__device__ __forceinline__ void store(float* t, size_t i, float x, const WriteBack&) {
  t[i] = x;
}

__device__ __forceinline__ void store(__nv_bfloat16* t, size_t i, float x,
                                      const WriteBack& w) {
  if (w.sr) {
    const uint32_t h = sr_hash(static_cast<uint32_t>(i), w.s0, w.s1);
    const uint32_t bits = (__float_as_uint(x) + (h & 0xFFFFu)) & 0xFFFF0000u;
    t[i] = __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
  } else {
    t[i] = __float2bfloat16_rn(x);
  }
}

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

// The finalize of one table: one warp per row (grid-stride over rows),
// the row's divisor read once, lanes striding over its D columns.
template <typename T>
__device__ __forceinline__ void finalize_table(T* __restrict__ table,
                                               const float* __restrict__ acc, float lr,
                                               int combiner, int V, int D,
                                               const WriteBack& wb) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  for (int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < V; r += warps) {
    const float* arow = acc + static_cast<size_t>(r) * (D + 1);
    const float div = row_divisor(arow[D], combiner);
    const size_t base = static_cast<size_t>(r) * D;
    for (int d = lane; d < D; d += 32) {
      const float upd = __fdiv_rn(arow[d], div);
      store(table, base + d, __fsub_rn(g2v_ld(table + base + d), __fmul_rn(lr, upd)), wb);
    }
  }
}

template <typename T>
__global__ void finalize_kernel(T* __restrict__ emb, T* __restrict__ ctx,
                                const float* __restrict__ acc_emb,
                                const float* __restrict__ acc_ctx, float lr,
                                int combiner, int V, int D, WriteBack wb_emb,
                                WriteBack wb_ctx) {
  if (blockIdx.y == 0) {
    finalize_table(emb, acc_emb, lr, combiner, V, D, wb_emb);
  } else {
    finalize_table(ctx, acc_ctx, lr, combiner, V, D, wb_ctx);
  }
}

__global__ void scatter_rows_kernel(float* __restrict__ acc,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ grads,
                                    const float* __restrict__ weights, int R,
                                    int D) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // warp-uniform
  float* ar = acc + static_cast<size_t>(idx[r]) * (D + 1);
  const float* gr = grads + static_cast<size_t>(r) * D;
  for (int d = lane; d < D; d += 32) atomicAdd(&ar[d], gr[d]);
  if (lane == 0) atomicAdd(&ar[D], weights[r]);
}

template <typename T>
__global__ void finalize_rows_kernel(T* __restrict__ table,
                                     const float* __restrict__ acc, float lr,
                                     int combiner, int V, int D, WriteBack wb) {
  finalize_table(table, acc, lr, combiner, V, D, wb);
}

// Blocks of `threads` for one warp per row, at most 16 per multiprocessor.
inline int finalize_grid(int V, int threads) {
  const int rows_per_block = threads / 32;
  return std::min((V + rows_per_block - 1) / rows_per_block, 132 * 16);
}

}  // namespace

G2V_EXPORT int k4_scatter_rows(float* acc, const int* idx, const float* grads,
                               const float* weights, int R, int D,
                               void* stream) {
  if (R == 0) return 0;
  const int threads = 256;
  const long long blocks = (static_cast<long long>(R) * 32 + threads - 1) / threads;
  scatter_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(acc, idx, grads,
                                                             weights, R, D);
  return static_cast<int>(cudaGetLastError());
}

G2V_EXPORT int k4_finalize_rows(void* table, const float* acc, float lr,
                                int combiner, int V, int D, int bf16, int sr,
                                uint32_t s0, uint32_t s1, void* stream) {
  const int threads = 256;
  const size_t n = static_cast<size_t>(V) * D;
  if (n == 0) return 0;
  const int grid = finalize_grid(V, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WriteBack wb{sr, s0, s1};
  if (bf16) {
    finalize_rows_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<__nv_bfloat16*>(table), acc, lr, combiner, V, D, wb);
  } else {
    finalize_rows_kernel<float><<<grid, threads, 0, s>>>(static_cast<float*>(table), acc,
                                                        lr, combiner, V, D, wb);
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 / sr as k4_finalize_rows; (s0e, s1e) salt emb's write-back,
// (s0c, s1c) ctx's.
G2V_EXPORT int k4_row_update(void* emb, void* ctx, float* acc_emb,
                             float* acc_ctx, const int* centers,
                             const int* contexts, const float* d_center,
                             const float* v, const float* g_pos, float lr,
                             int combiner, int E, int V, int D, int bf16, int sr,
                             uint32_t s0e, uint32_t s1e, uint32_t s0c, uint32_t s1c,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (E > 0) {
    scatter_kernel<<<(E * 32 + threads - 1) / threads, threads, 0, s>>>(
        acc_emb, acc_ctx, centers, contexts, d_center, v, g_pos, E, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t n = static_cast<size_t>(V) * D;
  if (n == 0) return 0;
  const int grid = finalize_grid(V, threads);
  const WriteBack we{sr, s0e, s1e}, wc{sr, s0c, s1c};
  if (bf16) {
    finalize_kernel<__nv_bfloat16><<<dim3(grid, 2), threads, 0, s>>>(
        static_cast<__nv_bfloat16*>(emb), static_cast<__nv_bfloat16*>(ctx), acc_emb,
        acc_ctx, lr, combiner, V, D, we, wc);
  } else {
    finalize_kernel<float><<<dim3(grid, 2), threads, 0, s>>>(
        static_cast<float*>(emb), static_cast<float*>(ctx), acc_emb, acc_ctx, lr,
        combiner, V, D, we, wc);
  }
  return static_cast<int>(cudaGetLastError());
}
