// K8 — int8 compressed-domain scan with the approximate top-rb.
//
// Replaces: gene2vec_tpu/serve/ann.py:397-426 (_quantize_queries,
// _approx_scores) and the scan of make_quant_kernel (:476-497, the jitted
// serve_topk_quant program up to its rescore): per-row symmetric int8
// queries (scale max(max|q|/127, 1e-12), rint, clip +-127), the
// int8 x int8 -> int32 dot against the int8 table, the rescale
// float(acc) * qs * scale[row], rows >= valid at -inf, lax.top_k(.., rb).
//
// Bound on the H100: bytes — the int8 table plus its scales,
// V*(D+4) = 5.0 MB at V = 24,447, D = 200 (~1.5 us at 3.35 TB/s); the
// int8 operations (2*B*V*D) are far under the int8 tensor-core rate.
//
// Design: the staged structure of K7 (topk_common.cuh) with int8 tensor
// cores.  Each block quantizes its queries into shared memory with
// correctly rounded divisions (rows zero past D up to a multiple of 32:
// a zero adds exactly 0), takes its chunk's rows in double-buffered tiles
// of 64 rows — one TMA bulk copy a tile, the rows as stored — and scores
// every query against each tile with mma.sync m16n8k32 s8 x s8 -> s32.
// The int32 sums are exact and the rescale runs in the reference's order
// without contraction, so the approximate scores are bitwise the
// reference's.  Selection as K7's.
//
// A bf16 table (build_index(quant_dtype="bf16")) takes the same staged
// structure with K7's SIMT scorer: the query is rounded to bf16, each
// bf16 x bf16 product is exact in float32 and the sum accumulates in
// float32, as the reference's preferred_element_type=f32 dot — equal to
// the plain version up to the order of the float32 sum.
//
// Rows too wide for a 32-row tile beside one query (int8 D >= 2728,
// bfloat16 D >= 1520) are staged as d-slices of DS columns (a multiple of
// 32), by 16-byte cp.async copies or element by element; each slice adds
// its exact int32 sum (bfloat16: its float32 partial) to the last before
// the rescale and the select.
#include "topk_common.cuh"

namespace {

struct QuantScorer {
  G2vStaging st;
  const float* qn;
  const signed char* table;
  const float* scale;
  int D;
  int valid;
  int qstride;  // bytes per staged query row
  int qg;       // the block's query group: the scales follow its rows

  __host__ __device__ static int query_rows(int QG) { return (QG + 15) & ~15; }

  __device__ const float* scales(const unsigned char* qmem, int QG) const {
    return reinterpret_cast<const float*>(qmem + static_cast<size_t>(query_rows(QG)) * qstride);
  }

  __device__ void load_queries(unsigned char* qmem, int q0, int nq, int QG) const {
    g2v_stage_queries_int8(qn, q0, nq, D, qstride, query_rows(QG),
                           reinterpret_cast<signed char*>(qmem),
                           const_cast<float*>(scales(qmem, QG)));
  }

  __device__ void copy_rows(unsigned char* tile, int r, int rows, int d0, int ds) const {
    g2v_copy_rows(table, D, r, rows, st.tstride, tile, d0, ds);
  }

  __device__ void score_tile(const unsigned char* tile, const unsigned char* qmem, int nq, int r,
                             int rows, int TR, int d0, int ds, int part, int* keys,
                             int kstride) const {
    g2v_imma_tile(tile, st.tstride, reinterpret_cast<const signed char*>(qmem), qstride,
                  scales(qmem, qg), scale, nq, ds, rows, TR, r, valid, d0, part, keys, kstride);
  }
};

struct Bf16Scorer {
  G2vStaging st;
  const float* qn;
  const __nv_bfloat16* table;
  int D;
  int valid;
  int qstride;  // floats per staged query row

  __device__ void load_queries(unsigned char* qmem, int q0, int nq, int QG) const {
    g2v_stage_queries_bf16(qn, q0, nq, D, qstride, g2v_simt_query_rows(QG),
                           reinterpret_cast<float*>(qmem));
  }

  __device__ void copy_rows(unsigned char* tile, int r, int rows, int d0, int ds) const {
    g2v_copy_rows(table, D, r, rows, st.tstride, tile, d0, ds);
  }

  __device__ void score_tile(const unsigned char* tile, const unsigned char* qmem, int nq, int r,
                             int rows, int TR, int d0, int ds, int part, int* keys,
                             int kstride) const {
    g2v_simt_tile<__nv_bfloat16>(tile, st.tstride, reinterpret_cast<const float*>(qmem),
                                 qstride, nq, ds, rows, TR, r, valid, d0, part, keys, kstride);
  }
};

}  // namespace

// table_bf16 = 0: `table` is int8 with per-row `scale`; 1: bfloat16.
// CH, QG, TR, DS, slot, stride and the scratch buffers as k7_topk_exact's.
G2V_EXPORT int k8_quant_scan(const float* qn, const void* table, const float* scale,
                             int table_bf16, int V, int D, int B, int valid, int rb, int CH,
                             int QG, int TR, int DS, int slot, int stride, int* ka, int* ia,
                             int* kb, int* ib, float* out_scores, int* out_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* base = static_cast<const unsigned char*>(table);
  const bool aligned = reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const int slice = DS > 0 ? DS : D;
  if (table_bf16) {
    const int mode = D % 8 == 0 && aligned ? G2V_STAGE_CP_ASYNC : G2V_STAGE_COPY;
    const int tstride = g2v_padded_stride(2 * ((slice + 3) & ~3));
    const int qstride = g2v_padded_stride(4 * ((D + 3) & ~3)) / 4;
    Bf16Scorer sc{{base, 2 * D, tstride, mode, slice, 2}, qn,
                  static_cast<const __nv_bfloat16*>(table), D, valid, qstride};
    return g2v_run_staged(sc, g2v_simt_query_rows(QG) * qstride * 4, V, B, QG, CH, TR, rb, slot,
                          stride, ka, ia, kb, ib, out_scores, out_rows, st);
  }
  // whole tiles as stored when rows are 4-byte multiples (the fragments'
  // 32-bit loads), else rows copied into 16-byte multiples; d-slices by
  // cp.async where rows are 16-byte multiples, into padded rows
  int mode, tstride;
  if (DS > 0) {
    mode = D % 16 == 0 && aligned ? G2V_STAGE_CP_ASYNC : G2V_STAGE_COPY;
    tstride = g2v_padded_stride(slice);
  } else {
    const bool tma = D % 4 == 0 && aligned;
    mode = tma ? G2V_STAGE_TMA : G2V_STAGE_COPY;
    tstride = tma ? D : (D + 15) & ~15;
  }
  const int qstride = g2v_padded_stride((D + 31) & ~31);
  QuantScorer sc{{base, D, tstride, mode, slice, 1}, qn,
                 static_cast<const signed char*>(table),
                 scale, D, valid, qstride, QG};
  const int query_bytes = QuantScorer::query_rows(QG) * (qstride + 4);
  return g2v_run_staged(sc, query_bytes, V, B, QG, CH, TR, rb, slot, stride, ka, ia, kb, ib,
                        out_scores, out_rows, st);
}
