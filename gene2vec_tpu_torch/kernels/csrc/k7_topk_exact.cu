// K7 — exact cosine top-k.
//
// Replaces: gene2vec_tpu/serve/engine.py:43-59 (_topk_cosine, the jitted
// serve_topk_exact program): qn = q / max(|q|, 1e-12); scores = qn . U^T
// over the (V, D) float32 unit matrix; rows >= valid set to -inf;
// lax.top_k(scores, kb).
//
// Bound on the H100: at serving batch sizes, bytes for B <= ~16 (the
// table, V*D*4 = 19.6 MB at V = 24,447, D = 200, ~5.8 us at 3.35 TB/s)
// and float32 operations above that (2*B*V*D: 0.63 GFLOP at B = 64,
// ~9.3 us at 67 TFLOP/s).
//
// Design (topk_common.cuh): tiles of T rows; one block scores a tile for
// up to 8 queries — a thread per row, float4 loads of the row, one sum
// per query in registers — so each row is read once per 8 queries; the
// tile's scores stay in shared memory, are sorted, and only each tile's
// top-kb leaves the block.  Merge passes reduce the tiles.  The queries
// are normalized inside each block in a fixed order, so every tile sees
// the same qn.
#include "topk_common.cuh"

namespace {

struct ExactScorer {
  const float* unit;
  const float* queries;
  int D;
  int valid;

  size_t query_bytes() const { return static_cast<size_t>(D) * 4; }

  __device__ void load_queries(unsigned char* qmem, int q0, int nq) const {
    g2v_stage_queries_f32(queries, q0, nq, D, true, reinterpret_cast<float*>(qmem));
  }

  __device__ void score_row(const unsigned char* qmem, int, int nq, int r, int* keys,
                            int stride) const {
    float acc[G2V_QB_MAX];
    g2v_thread_dots_f32(unit + static_cast<size_t>(r) * D,
                        reinterpret_cast<const float*>(qmem), nq, D, acc);
#pragma unroll
    for (int j = 0; j < G2V_QB_MAX; ++j) {
      if (j < nq) keys[j * stride] = g2v_key(r >= valid ? -INFINITY : acc[j]);
    }
  }
};

}  // namespace

G2V_EXPORT int k7_topk_exact(const float* unit, const float* queries, int V, int D,
                             int B, int valid, int kb, int T, int QB, int* ka, int* ia,
                             int* kb_buf, int* ib, float* out_scores, int* out_rows,
                             void* stream) {
  ExactScorer sc{unit, queries, D, valid};
  return g2v_run_topk(sc, G2vIdentity{}, V, B, QB, T, kb, ka, ia, kb_buf, ib,
                      out_scores, out_rows, static_cast<cudaStream_t>(stream));
}
