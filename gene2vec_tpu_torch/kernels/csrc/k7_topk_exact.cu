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
// ~9.3 us at 67 TFLOP/s; TF32 stays off, so not the tensor cores).
//
// Design (topk_common.cuh): about one block per SM, each over a chunk of
// rows and every query of the batch (up to 64).  The chunk's rows reach
// shared memory in double-buffered tiles of 64 rows by 16-byte cp.async
// copies from every thread, into padded rows (so eight rows read at one
// column hit distinct banks); each tile is scored for all queries from shared memory
// by 4 x 4 register micro-tiles of float32 FMAs, so each row leaves
// device memory once per call.  The scores stay in shared memory; a warp
// radix select keeps each query's top-kb of the chunk, and the final
// launch selects across chunks, sorts the kb survivors and writes them.
// The queries are normalized inside each block in a fixed order, so every
// block sees the same qn.
#include "topk_common.cuh"

namespace {

struct ExactScorer {
  G2vStaging st;
  const float* unit;
  const float* queries;
  int D;
  int valid;
  int qstride;  // floats per staged query row

  __device__ void load_queries(unsigned char* qmem, int q0, int nq, int QG) const {
    g2v_stage_queries_f32(queries, q0, nq, D, qstride, g2v_simt_query_rows(QG), true,
                          reinterpret_cast<float*>(qmem));
  }

  __device__ void copy_rows(unsigned char* tile, int r, int rows) const {
    g2v_copy_rows(unit, D, r, rows, st.tstride, tile);
  }

  __device__ void score_tile(const unsigned char* tile, const unsigned char* qmem, int nq, int r,
                             int rows, int TR, int* keys, int kstride) const {
    g2v_simt_tile<float>(tile, st.tstride, reinterpret_cast<const float*>(qmem), qstride, nq, D,
                         rows, TR, r, valid, keys, kstride);
  }
};

}  // namespace

// CH rows a chunk, QG queries a block, TR rows a tile, `slot` pairs a
// chunk's run, `stride` pairs each query's region of the scratch buffers
// (ka/ia: runs; kb/ib: long-list survivors).
G2V_EXPORT int k7_topk_exact(const float* unit, const float* queries, int V, int D, int B,
                             int valid, int kb, int CH, int QG, int TR, int slot, int stride,
                             int* ka, int* ia, int* kb_buf, int* ib, float* out_scores,
                             int* out_rows, void* stream) {
  const int mode = D % 4 == 0 && reinterpret_cast<uintptr_t>(unit) % 16 == 0
                       ? G2V_STAGE_CP_ASYNC
                       : G2V_STAGE_COPY;
  // rows of D rounded up to 4 floats, padded (tile and queries alike)
  const int tstride = g2v_padded_stride(4 * ((D + 3) & ~3));
  const int qstride = tstride / 4;
  ExactScorer sc{{reinterpret_cast<const unsigned char*>(unit), 4 * D, tstride, mode}, unit,
                 queries, D, valid, qstride};
  const int query_bytes = g2v_simt_query_rows(QG) * qstride * 4;
  return g2v_run_staged(sc, query_bytes, V, B, QG, CH, TR, kb, slot, stride, ka, ia, kb_buf,
                        ib, out_scores, out_rows, static_cast<cudaStream_t>(stream));
}
