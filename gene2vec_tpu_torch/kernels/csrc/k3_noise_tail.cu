// K3 — stratified tail blocks.
//
// Replaces: gene2vec_tpu/sgns/step.py:748-777 (per-group block draw
// start_g = min(head + blocks[g]*S, V - S), tail logits, K*tail_w weight,
// mask, g_tail, loss_tail), :785 (d_center += g_tail @ block), :833-847
// and _aggregate_tail_blocks (:598-627), which sum each group's (S, D+1)
// payload [g_tail^T v_g | K*tail_w*sum(mask)] per block through an
// (nb, G) one-hot matmul before adding it to the accumulator.  Here each
// group's payload is added straight into acc rows start_g..start_g+S
// with atomics: no (nb, G) one-hot.
//
// Bound on the H100: operations.  Three G x (E/G) x S x D products,
// 3 * 2*E*S*D = 5.0 GFLOP at E = 8192, S = 512, D = 200 — ~75 us at the
// 67 TFLOP/s float32 peak — against ~50 MB of traffic (~15 us).  A
// bfloat16 ctx halves the drawn blocks' bytes; the bound stays operations.
//
// Design: the three phases of noise_gemm.cuh with one group per grid z
// slice; each block reads its group's drawn block id and clamps the start
// itself.  Two groups may draw the same block and the clamped last block
// overlaps its neighbour, so phase 3 adds with atomics.
#include "noise_gemm.cuh"

G2V_EXPORT int k3_noise_tail(const float* v, const int* contexts,
                             const void* ctx, const float* tail_w,
                             const int* blocks, float kneg, float* g_scratch,
                             int* hits, float* loss_tail, float* d_center,
                             float* acc_ctx, int E, int D, int G, int S,
                             int head, int vn, int splits, int bf16, void* stream) {
  g2v::NoiseParams p;
  p.v = v;
  p.u = nullptr;
  p.g_pos = nullptr;
  p.contexts = contexts;
  p.ctx = ctx;
  p.w = tail_w;
  p.blocks = blocks;
  p.g = g_scratch;
  p.hits = hits;
  p.loss = loss_tail;
  p.d_center = d_center;
  p.acc = acc_ctx;
  p.kneg = kneg;
  p.D = D;
  p.S = S;
  p.Eg = E / G;
  p.head = head;
  p.vn = vn;
  p.splits = splits;
  p.init_center = 0;
  return g2v::launch_noise_as<g2v::Slab::kContiguous>(
      p, G, bf16, static_cast<cudaStream_t>(stream));
}
