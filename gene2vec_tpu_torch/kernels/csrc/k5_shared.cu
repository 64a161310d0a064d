// K5b — the shared grouped noise pool.
//
// Replaces: gene2vec_tpu/sgns/step.py:337-442 (_step_shared): G groups of
// E/G examples, each against its own P/G slice of a pool of P alias draws:
//   neg_logit = (G, E/G, D) x (G, D, P/G),  mask = pool id != context,
//   scale = K*G/P,  loss += scale * sum(mask * softplus(neg_logit)),
//   g_neg = scale * sigmoid(neg_logit) * mask,
//   d_center = g_pos*u + g_neg @ u_pool,
//   acc[pool ids, :D] += g_neg^T @ v_g,
//   acc[pool ids,  D] += scale * sum_e mask   (float32 count).
//
// Bound on the H100: operations.  Three G x (E/G) x (P/G) x D products:
// with auto sizing (G = E/32, P/G = 128) 3 * 2 * E * 128 * D = 1.26 GFLOP
// at E = 8192, D = 200 — ~19 us at the 67 TFLOP/s float32 peak — against
// ~40 MB of traffic (the pool rows read twice, v and u, the pool rows'
// accumulator rows, ~12 us).  A bfloat16 ctx halves the pool rows' reads;
// the bound stays operations.
//
// Design: K3's structure (noise_gemm.cuh) with each group's contiguous
// block replaced by its P/G gathered pool rows: the GEMM tiles read ctx
// through the pool's row ids, and phase 3 adds each slot's payload into
// its pool row with atomics (a row drawn twice gets both).
#include "noise_gemm.cuh"

G2V_EXPORT int k5_shared(const float* v, const float* u, const float* g_pos,
                         const int* contexts, const void* ctx, const int* pool,
                         float scale, float* g_scratch, int* hits,
                         float* loss_neg, float* d_center, float* acc_ctx, int E,
                         int D, int G, int S, int splits, int bf16, void* stream) {
  g2v::NoiseParams p{};
  p.v = v;
  p.u = u;
  p.g_pos = g_pos;
  p.contexts = contexts;
  p.ctx = ctx;
  p.ids = pool;
  p.g = g_scratch;
  p.hits = hits;
  p.loss = loss_neg;
  p.d_center = d_center;
  p.acc = acc_ctx;
  p.kneg = scale;
  p.D = D;
  p.S = S;
  p.Eg = E / G;
  p.splits = splits;
  p.init_center = 1;
  return g2v::launch_noise_as<g2v::Slab::kPool>(
      p, G, bf16, static_cast<cudaStream_t>(stream));
}
