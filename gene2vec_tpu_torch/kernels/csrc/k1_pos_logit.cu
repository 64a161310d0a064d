// K1 — positive gather and logit.
//
// Replaces: gene2vec_tpu/sgns/step.py:705-734 (_step_stratified's positive
// side: v = emb[centers], u = ctx[contexts], pos_logit = sum(v*u),
// g_pos = sigmoid(pos_logit) - 1, and the softplus(-pos_logit) loss term).
// The reference moves head/mid rows with one-hot MXU matmuls
// (_dense_slab_gather, step.py:522-558); on the GPU a row gather gives the
// same values, so every example takes the gather.
//
// Bound on the H100: bytes.  2E rows of D floats are gathered and written
// back out as v and u (which K2-K4 reuse), ~2 FLOP per byte-pair read: at
// E = 8192, D = 200 that is ~26 MB, ~8 us at 3.35 TB/s.
//
// bfloat16 tables (table_dtype="bfloat16") halve the table reads: at
// D = 200 the bound falls to ~19 MB, ~6 us.  v, u, g_pos and the loss stay
// float32 (the reference's .astype(compute_dtype) on the gathered rows).
//
// Design: one warp per example.  Lanes stride over the D columns, so each
// gathered row is read as coalesced 128-byte segments and D = 200 (not a
// multiple of 32) is masked by the loop bound; the dot product reduces
// with warp shuffles and lane 0 writes the two per-example scalars.  A
// bfloat16 row loads 8 elements per lane in one 16-byte load (when D is a
// multiple of 8), upcast to float32 in registers, and writes them to v and
// u as two 16-byte stores: element-wise stores at a 32-byte lane stride
// measured 2.7x the float32 kernel's time on the card.
#include "common.cuh"

namespace {

template <typename T>
__global__ void pos_logit_kernel(const T* __restrict__ emb,
                                 const T* __restrict__ ctx,
                                 const int* __restrict__ centers,
                                 const int* __restrict__ contexts,
                                 float* __restrict__ v, float* __restrict__ u,
                                 float* __restrict__ g_pos,
                                 float* __restrict__ loss_pos, int E, int D) {
  constexpr int W = G2vVec<T>::kWidth;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= E) return;  // warp-uniform
  const T* er = emb + static_cast<size_t>(centers[e]) * D;
  const T* cr = ctx + static_cast<size_t>(contexts[e]) * D;
  float* vr = v + static_cast<size_t>(e) * D;
  float* ur = u + static_cast<size_t>(e) * D;
  float s = 0.0f;
  const int span = g2v_vec_span<T>(D);
  for (int d = lane * W; d < span; d += 32 * W) {
    float a[W], b[W];
    g2v_ld_vec(er + d, a);
    g2v_ld_vec(cr + d, b);
    g2v_st_vec(vr + d, a);
    g2v_st_vec(ur + d, b);
#pragma unroll
    for (int j = 0; j < W; ++j) s = fmaf(a[j], b[j], s);
  }
  for (int d = span + lane; d < D; d += 32) {  // rows of D % W != 0
    const float a = g2v_ld(er + d);
    const float b = g2v_ld(cr + d);
    vr[d] = a;
    ur[d] = b;
    s = fmaf(a, b, s);
  }
  s = g2v_warp_sum(s);
  if (lane == 0) {
    g_pos[e] = g2v_sigmoid(s) - 1.0f;
    loss_pos[e] = g2v_softplus(-s);
  }
}

}  // namespace

// bf16: 0 for float32 tables, 1 for bfloat16 tables (emb and ctx alike).
G2V_EXPORT int k1_pos_logit(const void* emb, const void* ctx,
                            const int* centers, const int* contexts, float* v,
                            float* u, float* g_pos, float* loss_pos, int E,
                            int D, int bf16, void* stream) {
  if (E == 0) return 0;
  const int threads = 256;
  const int blocks = (E * 32 + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    pos_logit_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(emb), static_cast<const __nv_bfloat16*>(ctx),
        centers, contexts, v, u, g_pos, loss_pos, E, D);
  } else {
    pos_logit_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(emb), static_cast<const float*>(ctx), centers,
        contexts, v, u, g_pos, loss_pos, E, D);
  }
  return static_cast<int>(cudaGetLastError());
}
