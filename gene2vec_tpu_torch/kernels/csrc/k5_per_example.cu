// K5a — per-example noise (gensim's estimator: K alias draws per example).
//
// Replaces: gene2vec_tpu/sgns/step.py:97-130 (sgns_loss_and_grads, its
// noise half) and the noise scatter of _step_per_example (:289-334):
//   neg_logit[e, k] = v[e] . ctx[negs[e, k]],  mask = negs[e, k] != context,
//   loss_neg[e]     = sum_k mask * softplus(neg_logit),
//   g_neg           = sigmoid(neg_logit) * mask,
//   d_center[e]     = g_pos[e]*u[e] + sum_k g_neg[e, k] * ctx[negs[e, k]],
//   acc[negs[e, k]] += [g_neg[e, k] * v[e] | mask].
// The positives and the finalize go through K4's generic entry points.
//
// Bound on the H100: bytes.  The (E, K, D) gather of noise rows (33 MB
// at E = 8192, K = 5, D = 200), v and u (13 MB), d_center out (6.6 MB)
// and E*K scattered (D+1)-float accumulator rows (~33 MB, each read and
// written once by its atomics) — ~110 MB, ~33 us at 3.35 TB/s.
//
// Design: one warp per example.  Lanes stride over D; each noise row is
// read as coalesced 128-byte segments for its dot (warp shuffle sum),
// then read again (from L1/L2) for d_center while the scatter adds
// g_neg*v into its accumulator row with float atomics.  The K draws'
// g_neg and ids sit in shared memory, K per warp.  A masked draw (the
// draw hit the positive) contributes zeros and is skipped.  The noise rows
// are the only table reads: a bfloat16 ctx (T) loads element-wise and
// upcasts to float32, halving the gather's bytes.
#include "common.cuh"

namespace {

template <typename T>
__global__ void per_example_kernel(const float* __restrict__ v,
                                   const float* __restrict__ u,
                                   const float* __restrict__ g_pos,
                                   const int* __restrict__ contexts,
                                   const int* __restrict__ negs,
                                   const T* __restrict__ ctx,
                                   float* __restrict__ loss_neg,
                                   float* __restrict__ d_center,
                                   float* __restrict__ acc, int E, int K, int D) {
  extern __shared__ float g2v_k5_smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * warps + warp;
  if (e >= E) return;  // warp-uniform; no block-wide barrier below
  float* gk = g2v_k5_smem + warp * K;
  int* nk = reinterpret_cast<int*>(g2v_k5_smem + warps * K) + warp * K;
  const float* vr = v + static_cast<size_t>(e) * D;
  const int c = contexts[e];
  float loss = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int n = negs[static_cast<size_t>(e) * K + k];
    const T* cr = ctx + static_cast<size_t>(n) * D;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(vr[d], g2v_ld(cr + d), s);
    s = g2v_warp_sum(s);  // every lane holds the sum
    const float mask = (n != c) ? 1.0f : 0.0f;
    loss += mask * g2v_softplus(s);
    if (lane == 0) {
      gk[k] = g2v_sigmoid(s) * mask;
      nk[k] = n;
    }
  }
  __syncwarp();
  if (lane == 0) loss_neg[e] = loss;
  const float gp = g_pos[e];
  const int D1 = D + 1;
  for (int d = lane; d < D; d += 32) {
    float sum = 0.0f;
    for (int k = 0; k < K; ++k) {
      sum = fmaf(gk[k], g2v_ld(ctx + static_cast<size_t>(nk[k]) * D + d), sum);
    }
    const size_t o = static_cast<size_t>(e) * D + d;
    d_center[o] = __fadd_rn(__fmul_rn(gp, u[o]), sum);
    const float vd = vr[d];
    for (int k = 0; k < K; ++k) {
      if (nk[k] != c) {
        atomicAdd(&acc[static_cast<size_t>(nk[k]) * D1 + d], __fmul_rn(gk[k], vd));
      }
    }
  }
  if (lane == 0) {
    for (int k = 0; k < K; ++k) {
      if (nk[k] != c) atomicAdd(&acc[static_cast<size_t>(nk[k]) * D1 + D], 1.0f);
    }
  }
}

}  // namespace

template <typename T>
int launch_per_example(const float* v, const float* u, const float* g_pos,
                       const int* contexts, const int* negs, const T* ctx,
                       float* loss_neg, float* d_center, float* acc_ctx, int E,
                       int K, int D, cudaStream_t stream) {
  const int threads = 256, warps = threads / 32;
  const size_t smem = static_cast<size_t>(warps) * K * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        per_example_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  per_example_kernel<T><<<(E + warps - 1) / warps, threads, smem, stream>>>(
      v, u, g_pos, contexts, negs, ctx, loss_neg, d_center, acc_ctx, E, K, D);
  return static_cast<int>(cudaGetLastError());
}

G2V_EXPORT int k5_per_example(const float* v, const float* u, const float* g_pos,
                              const int* contexts, const int* negs,
                              const void* ctx, float* loss_neg, float* d_center,
                              float* acc_ctx, int E, int K, int D, int bf16,
                              void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_per_example(v, u, g_pos, contexts, negs,
                              static_cast<const __nv_bfloat16*>(ctx), loss_neg,
                              d_center, acc_ctx, E, K, D, s);
  return launch_per_example(v, u, g_pos, contexts, negs, static_cast<const float*>(ctx),
                            loss_neg, d_center, acc_ctx, E, K, D, s);
}
