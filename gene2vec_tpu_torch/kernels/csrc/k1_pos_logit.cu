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
// Design: one warp per example.  Lanes stride over the D columns, so each
// gathered row is read as coalesced 128-byte segments and D = 200 (not a
// multiple of 32) is masked by the loop bound; the dot product reduces
// with warp shuffles and lane 0 writes the two per-example scalars.
#include "common.cuh"

namespace {

__global__ void pos_logit_kernel(const float* __restrict__ emb,
                                 const float* __restrict__ ctx,
                                 const int* __restrict__ centers,
                                 const int* __restrict__ contexts,
                                 float* __restrict__ v, float* __restrict__ u,
                                 float* __restrict__ g_pos,
                                 float* __restrict__ loss_pos, int E, int D) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= E) return;  // warp-uniform
  const float* er = emb + static_cast<size_t>(centers[e]) * D;
  const float* cr = ctx + static_cast<size_t>(contexts[e]) * D;
  float* vr = v + static_cast<size_t>(e) * D;
  float* ur = u + static_cast<size_t>(e) * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float a = er[d];
    const float b = cr[d];
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

G2V_EXPORT int k1_pos_logit(const float* emb, const float* ctx,
                            const int* centers, const int* contexts, float* v,
                            float* u, float* g_pos, float* loss_pos, int E,
                            int D, void* stream) {
  const int threads = 256;
  const int blocks = (E * 32 + threads - 1) / threads;
  pos_logit_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      emb, ctx, centers, contexts, v, u, g_pos, loss_pos, E, D);
  return static_cast<int>(cudaGetLastError());
}
