// K2 — exact noise head.
//
// Replaces: gene2vec_tpu/sgns/step.py:736-746 (head logits, mask, g_head,
// loss_head), :782-786 (d_center = g_pos*u + g_head @ ctx[:H]) and
// :828-831 (acc[:H, :D] += g_head^T v; acc[:H, D] += K*q*sum(mask)).
//
// Bound on the H100: operations.  Three E x H x D products, 3 * 2*E*H*D =
// 2.5 GFLOP at E = 8192, H = 256, D = 200 — ~38 us at the 67 TFLOP/s
// float32 (non-tensor-core) peak — against ~20 MB of traffic (~6 us).  A
// bfloat16 ctx halves the head slab's ~0.2 MB; the bound stays operations.
//
// Design: the three phases of noise_gemm.cuh with one group (start 0,
// S = H, w = q).  A simple SIMT tiled GEMM per phase, full float32 FMA (no
// TF32: the reference and the plain version are float32).  The (E, H)
// g_head matrix goes through device memory between phases (8 MB here);
// phase 3 reduces over all E examples into only H rows, so it is split over
// E (grid z) to put enough blocks on the card.
#include "noise_gemm.cuh"

G2V_EXPORT int k2_noise_head(const float* v, const float* u, const float* g_pos,
                             const int* contexts, const void* ctx,
                             const float* q, float kneg, float* g_scratch,
                             int* hits, float* loss_head, float* d_center,
                             float* acc_ctx, int E, int D, int H, int splits,
                             int bf16, void* stream) {
  g2v::NoiseParams p;
  p.v = v;
  p.u = u;
  p.g_pos = g_pos;
  p.contexts = contexts;
  p.ctx = ctx;
  p.w = q;
  p.blocks = nullptr;
  p.g = g_scratch;
  p.hits = hits;
  p.loss = loss_head;
  p.d_center = d_center;
  p.acc = acc_ctx;
  p.kneg = kneg;
  p.D = D;
  p.S = H;
  p.Eg = E;
  p.head = 0;
  p.vn = H;
  p.splits = splits;
  p.init_center = 1;
  return g2v::launch_noise_as<g2v::Slab::kContiguous>(
      p, 1, bf16, static_cast<cudaStream_t>(stream));
}
