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
// Design: the K7 tile structure (topk_common.cuh) with an int8 scorer:
// each block quantizes its queries into shared memory with correctly
// rounded divisions, a thread per table row sums int8 products exactly in
// int32 (dp4a over 4-byte words), and the rescale runs in the reference's
// order without contraction — so the approximate scores are bitwise the
// reference's.  IMMA tensor-core tiles come later.
//
// A bf16 table (build_index(quant_dtype="bf16")) takes the same tile
// structure with a bf16 scorer: the query is rounded to bf16, each
// bf16 x bf16 product is exact in float32 and the sum accumulates in
// float32, as the reference's preferred_element_type=f32 dot — equal to
// the plain version up to the order of the float32 sum.
#include "topk_common.cuh"

namespace {

struct QuantScorer {
  const float* qn;
  const signed char* table;
  const float* scale;
  int D;
  int valid;

  size_t query_bytes() const { return g2v_int8_query_bytes(D); }

  __device__ const float* scales(const unsigned char* qmem, int nq) const {
    return reinterpret_cast<const float*>(qmem + ((nq * D + 3) & ~3));
  }

  __device__ void load_queries(unsigned char* qmem, int q0, int nq) const {
    g2v_stage_queries_int8(qn, q0, nq, D, reinterpret_cast<signed char*>(qmem),
                           const_cast<float*>(scales(qmem, nq)));
  }

  __device__ void score_row(const unsigned char* qmem, int, int nq, int r, int* keys,
                            int stride) const {
    int acc[G2V_QB_MAX];
    g2v_thread_dots_int8(table + static_cast<size_t>(r) * D,
                         reinterpret_cast<const signed char*>(qmem), nq, D, acc);
    const float* qs = scales(qmem, nq);
    const float s_row = scale[r];
#pragma unroll
    for (int j = 0; j < G2V_QB_MAX; ++j) {
      if (j < nq) {
        keys[j * stride] = g2v_key(r >= valid ? -INFINITY : g2v_rescale(acc[j], qs[j], s_row));
      }
    }
  }
};

struct Bf16Scorer {
  const float* qn;
  const __nv_bfloat16* table;
  int D;
  int valid;

  size_t query_bytes() const { return static_cast<size_t>(D) * 4; }

  __device__ void load_queries(unsigned char* qmem, int q0, int nq) const {
    g2v_stage_queries_bf16(qn, q0, nq, D, reinterpret_cast<float*>(qmem));
  }

  __device__ void score_row(const unsigned char* qmem, int, int nq, int r, int* keys,
                            int stride) const {
    float acc[G2V_QB_MAX];
    g2v_thread_dots_bf16(table + static_cast<size_t>(r) * D,
                         reinterpret_cast<const float*>(qmem), nq, D, acc);
#pragma unroll
    for (int j = 0; j < G2V_QB_MAX; ++j) {
      if (j < nq) keys[j * stride] = g2v_key(r >= valid ? -INFINITY : acc[j]);
    }
  }
};

}  // namespace

// table_bf16 = 0: `table` is int8 with per-row `scale`; 1: bfloat16.
G2V_EXPORT int k8_quant_scan(const float* qn, const void* table, const float* scale,
                             int table_bf16, int V, int D, int B, int valid, int rb,
                             int T, int QB, int* ka, int* ia, int* kb, int* ib,
                             float* out_scores, int* out_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_bf16) {
    Bf16Scorer sc{qn, static_cast<const __nv_bfloat16*>(table), D, valid};
    return g2v_run_topk(sc, G2vIdentity{}, V, B, QB, T, rb, ka, ia, kb, ib, out_scores,
                        out_rows, st);
  }
  QuantScorer sc{qn, static_cast<const signed char*>(table), scale, D, valid};
  return g2v_run_topk(sc, G2vIdentity{}, V, B, QB, T, rb, ka, ia, kb, ib, out_scores,
                      out_rows, st);
}
