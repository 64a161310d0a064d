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
// Bound on the H100: operations on the tensor cores.  Three
// G x (E/G) x S x D products, 2*E*S*D = 1.7 GFLOP each at E = 8192,
// S = 512, D = 200, each in three TF32 passes (two where one operand is a
// bfloat16 table row): 15.1 GFLOP on float32 tables, ~30 us at the 495
// TFLOP/s dense TF32 peak (11.7 GFLOP, ~24 us, on bfloat16 tables),
// against ~50 MB of traffic (~15 us).  The float32 SIMT route's bound,
// 5.0 GFLOP at 67 TFLOP/s, is ~75 us.
//
// Design: noise_tc.cuh with one group a grid row; each block reads its
// group's drawn block id and clamps the start itself.  Launch 1 gives
// each block 64 of a group's 256 examples and stages the group's 512 slab
// rows once, in eight 64-row chunks, for both the logit and the d_center
// products on 3xTF32 mma.sync — 128 blocks at the default shapes.  Two
// groups may draw the same block and the clamped last block overlaps its
// neighbour, so launch 2 adds the payloads with atomics.
#include "noise_tc.cuh"

G2V_EXPORT int k3_noise_tail(const float* v, const int* contexts,
                             const void* ctx, const float* tail_w,
                             const int* blocks, float kneg, float* g_scratch,
                             int* hits, float* loss_tail, float* d_center,
                             float* acc_ctx, int E, int D, int G, int S, int Sp,
                             int head, int vn, int splits, int bf16, void* stream) {
  g2v::tc::Params p{};
  p.v = v;
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
  p.Sp = Sp;
  p.Eg = G ? E / G : 0;
  p.head = head;
  p.vn = vn;
  p.splits = splits;
  p.init_center = 0;
  return g2v::tc::launch_as<false>(p, G, bf16, static_cast<cudaStream_t>(stream));
}
