// K2 — exact noise head.
//
// Replaces: gene2vec_tpu/sgns/step.py:736-746 (head logits, mask, g_head,
// loss_head), :782-786 (d_center = g_pos*u + g_head @ ctx[:H]) and
// :828-831 (acc[:H, :D] += g_head^T v; acc[:H, D] += K*q*sum(mask)).
//
// Bound on the H100: operations on the tensor cores.  Three E x H x D
// products, 2*E*H*D = 0.84 GFLOP each at E = 8192, H = 256, D = 200, each
// in three TF32 passes (two where one operand is a bfloat16 table row,
// exact in tf32): 7.5 GFLOP on float32 tables, ~15 us at the 495 TFLOP/s
// dense TF32 peak (5.9 GFLOP, ~12 us, on bfloat16 tables), against ~20 MB
// of traffic (~6 us).  The float32 SIMT route's bound, 2.5 GFLOP at 67
// TFLOP/s, is ~38 us.
//
// Design: noise_tc.cuh with one group (start 0, S = H, w = q): launch 1
// gives each block 64 examples and stages the head's 256 rows once, in
// four 64-row chunks, for both the logit and the d_center products on
// 3xTF32 mma.sync; launch 2 contracts g_head^T v over E, cut into
// example ranges so that about one block runs per SM.
#include "noise_tc.cuh"

G2V_EXPORT int k2_noise_head(const float* v, const float* u, const float* g_pos,
                             const int* contexts, const void* ctx,
                             const float* q, float kneg, float* g_scratch,
                             int* hits, float* loss_head, float* d_center,
                             float* acc_ctx, int E, int D, int H, int Hp, int splits,
                             int bf16, void* stream) {
  g2v::tc::Params p{};
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
  p.Sp = Hp;
  p.Eg = E;
  p.vn = H;
  p.splits = splits;
  p.init_center = 1;
  return g2v::tc::launch_as<false>(p, 1, bf16, static_cast<cudaStream_t>(stream));
}
