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
// block sees the same qn.  Rows too wide for a 32-row tile beside one
// query (D >= 800) are staged as d-slices of DS columns, each slice's
// float32 partial added to the last before the select.
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

  __device__ void copy_rows(unsigned char* tile, int r, int rows, int d0, int ds) const {
    g2v_copy_rows(unit, D, r, rows, st.tstride, tile, d0, ds);
  }

  __device__ void score_tile(const unsigned char* tile, const unsigned char* qmem, int nq, int r,
                             int rows, int TR, int d0, int ds, int part, int* keys,
                             int kstride) const {
    g2v_simt_tile<float>(tile, st.tstride, reinterpret_cast<const float*>(qmem), qstride, nq, ds,
                         rows, TR, r, valid, d0, part, keys, kstride);
  }
};

}  // namespace

// CH rows a chunk, QG queries a block, TR rows a tile, DS columns a
// d-slice (0: whole rows), `slot` pairs a chunk's run, `stride` pairs each
// query's region of the scratch buffers (ka/ia: runs; kb/ib: long-list
// survivors).
G2V_EXPORT int k7_topk_exact(const float* unit, const float* queries, int V, int D, int B,
                             int valid, int kb, int CH, int QG, int TR, int DS, int slot,
                             int stride, int* ka, int* ia, int* kb_buf, int* ib,
                             float* out_scores, int* out_rows, void* stream) {
  const int mode = D % 4 == 0 && reinterpret_cast<uintptr_t>(unit) % 16 == 0
                       ? G2V_STAGE_CP_ASYNC
                       : G2V_STAGE_COPY;
  const int slice = DS > 0 ? DS : D;
  // rows of a slice (and queries of D) rounded up to 4 floats, padded
  const int tstride = g2v_padded_stride(4 * ((slice + 3) & ~3));
  const int qstride = g2v_padded_stride(4 * ((D + 3) & ~3)) / 4;
  ExactScorer sc{{reinterpret_cast<const unsigned char*>(unit), 4 * D, tstride, mode, slice, 4},
                 unit, queries, D, valid, qstride};
  const int query_bytes = g2v_simt_query_rows(QG) * qstride * 4;
  return g2v_run_staged(sc, query_bytes, V, B, QG, CH, TR, kb, slot, stride, ka, ia, kb_buf,
                        ib, out_scores, out_rows, static_cast<cudaStream_t>(stream));
}
