// K5b — the shared grouped noise pool.
//
// Replaces: gene2vec_tpu/sgns/step.py:337-442 (_step_shared): G groups of
// E/G examples, each against its own P/G slice of a pool of P alias draws:
//   neg_logit = (G, E/G, D) x (G, D, P/G),  mask = pool id != context,
//   scale = K*G/P,  loss += scale * sum(mask * softplus(neg_logit)),
//   g_neg = scale * sigmoid(neg_logit) * mask,
//   d_center = g_pos*u + g_neg @ u_pool,
//   acc[pool ids, :D] += g_neg^T @ v_g,
//   acc[pool ids,  D] += scale * (E/G - hits)   (exact integer hits).
// This is K2/K3's algebra (noise_tc.cuh) with a gathered slab and w = 1.
//
// Bound on the H100: bytes.  ~51 MB at E = 8192, D = 200 with auto sizing
// (G = E/32, P/G = 128, ~12,900 distinct pool rows): v and u read,
// d_center written, the pool's distinct rows read and their accumulator
// rows read and written once — ~15 us (~46 MB, ~14 us, bfloat16).  The
// three G x (E/G) x (P/G) x D products, 2 * E * 128 * D = 0.42 GFLOP
// each, take three TF32 passes each (two for the logits and d_center on
// bfloat16 tables): 3.8 GFLOP, ~8 us at the 495 TFLOP/s dense TF32 peak
// (2.9 GFLOP, ~6 us, bfloat16).  The float32 SIMT route's bound, 1.26
// GFLOP at 67 TFLOP/s, was ~19 us.
//
// Design: noise_tc.cuh's two launches, 3xTF32 mma.sync.  The slab is the
// group's P/G pool rows, staged by cp.async row by row through the pool's
// ids (16-byte copies where D * sizeof(T) allows); the mask compares the
// pool id with the context.  With E/G <= 32 (the auto layout's 32) a
// launch-1 block owns two groups, one a 32-row half of its 64-row tile,
// each half against its own staged chunk, so that no tile row idles.
// Launch 2 adds each slot's payload into its pool row with atomics: a
// row drawn twice, in one group or in several, gets both.
#include "noise_tc.cuh"

G2V_EXPORT int k5_shared(const float* v, const float* u, const float* g_pos,
                         const int* contexts, const void* ctx, const int* pool,
                         float scale, float* g_scratch, int* hits, float* loss_neg,
                         float* d_center, float* acc_ctx, int E, int D, int G, int S,
                         int Sp, int splits, int bf16, void* stream) {
  g2v::tc::Params p{};
  p.v = v;
  p.u = u;
  p.g_pos = g_pos;
  p.contexts = contexts;
  p.ctx = ctx;
  p.w = nullptr;  // every pool slot weighs scale
  p.ids = pool;
  p.g = g_scratch;
  p.hits = hits;
  p.loss = loss_neg;
  p.d_center = d_center;
  p.acc = acc_ctx;
  p.kneg = scale;
  p.D = D;
  p.S = S;
  p.Sp = Sp;
  p.Eg = G ? E / G : 0;
  p.pair = p.Eg <= 32;
  p.splits = splits;
  p.init_center = 1;
  return g2v::tc::launch_as<true>(p, G, bf16, static_cast<cudaStream_t>(stream));
}
