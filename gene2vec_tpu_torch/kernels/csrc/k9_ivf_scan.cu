// K9 — IVF probe and int8 candidate scan with the approximate top-r.
//
// Replaces: gene2vec_tpu/serve/ann.py:429-449 (_gathered_approx) and the
// probe of make_ivf_kernel (:550-571, the jitted serve_topk_ivf program up
// to its rescore): cs = qn . C^T over the (C, D) centroids,
// lax.top_k(cs, nprobe); cand = lists[probe] (-1 padded), ok = cand >= 0
// and cand < valid, pos = ok ? cand : 0; the int8 dot of the quantized
// query with table_q[pos] rescaled by qs * scale[pos]; masked candidates
// at -inf; lax.top_k(.., r) over the nprobe*L candidate positions and
// ri = pos[top positions].
//
// Bound on the H100: bytes — the centroids (C*D*4 = 0.5 MB at C = 625,
// D = 200) and, per query, the probed lists' ids, int8 rows and scales
// (nprobe*L*(D+8) = 0.2 MB at nprobe = 8, L = 128).
//
// Design: two runs of the tiled selection (topk_common.cuh).  The probe
// scores the centroids for up to 8 queries a block (float32, a thread per
// centroid) and keeps the top-nprobe.  The scan gives each query blocks
// of its own, one tile of candidate positions each: a thread reads the
// candidate id from the probed list, gathers its int8 row and scale and
// sums exactly in int32 (dp4a), with the K8 rescale — so the approximate
// scores are bitwise the reference's.  Ties order by candidate position,
// as lax.top_k orders the reference's (B, N) candidate matrix.
#include "topk_common.cuh"

namespace {

struct CentroidScorer {
  const float* centroids;
  const float* qn;
  int D;

  size_t query_bytes() const { return static_cast<size_t>(D) * 4; }

  __device__ void load_queries(unsigned char* qmem, int q0, int nq) const {
    g2v_stage_queries_f32(qn, q0, nq, D, false, reinterpret_cast<float*>(qmem));
  }

  __device__ void score_row(const unsigned char* qmem, int, int nq, int r, int* keys,
                            int stride) const {
    float acc[G2V_QB_MAX];
    g2v_thread_dots_f32(centroids + static_cast<size_t>(r) * D,
                        reinterpret_cast<const float*>(qmem), nq, D, acc);
#pragma unroll
    for (int j = 0; j < G2V_QB_MAX; ++j) {
      if (j < nq) keys[j * stride] = g2v_key(acc[j]);
    }
  }
};

// Candidate position p of query b -> its row id (or -1 / masked).
struct Candidates {
  const int* lists;
  const int* probe;   // (B, nprobe) centroid ids
  int nprobe;
  int L;
  int valid;

  __device__ int row(int b, int p) const {
    const int c = probe[b * nprobe + p / L];
    const int id = lists[static_cast<size_t>(c) * L + p % L];
    return (id >= 0 && id < valid) ? id : -1;
  }

  __device__ int operator()(int b, int p) const {
    const int id = row(b, p);
    return id >= 0 ? id : 0;
  }
};

struct CandidateScorer {
  Candidates cand;
  const float* qn;
  const signed char* table;
  const float* scale;
  int D;

  size_t query_bytes() const { return g2v_int8_query_bytes(D); }

  __device__ const float* scales(const unsigned char* qmem) const {
    return reinterpret_cast<const float*>(qmem + ((D + 3) & ~3));
  }

  __device__ void load_queries(unsigned char* qmem, int q0, int nq) const {
    g2v_stage_queries_int8(qn, q0, nq, D, reinterpret_cast<signed char*>(qmem),
                           const_cast<float*>(scales(qmem)));
  }

  // one query a block (QB = 1): row p is candidate position p of query q0
  __device__ void score_row(const unsigned char* qmem, int q0, int, int p, int* keys,
                            int) const {
    const int id = cand.row(q0, p);
    if (id < 0) {
      keys[0] = g2v_key(-INFINITY);
      return;
    }
    int acc[G2V_QB_MAX];
    g2v_thread_dots_int8(table + static_cast<size_t>(id) * D,
                         reinterpret_cast<const signed char*>(qmem), 1, D, acc);
    keys[0] = g2v_key(g2v_rescale(acc[0], scales(qmem)[0], scale[id]));
  }
};

}  // namespace

G2V_EXPORT int k9_ivf_scan(const float* qn, const float* centroids, const int* lists,
                           const signed char* table, const float* scale, int C, int L,
                           int V, int D, int B, int nprobe, int valid, int r, int Tc,
                           int QBc, int Tn, int* cka, int* cia, int* ckb, int* cib,
                           int* nka, int* nia, int* nkb, int* nib, float* probe_scores,
                           int* probe, float* out_scores, int* out_rows, void* stream) {
  (void)V;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CentroidScorer cs{centroids, qn, D};
  int err = g2v_run_topk(cs, G2vIdentity{}, C, B, QBc, Tc, nprobe, cka, cia, ckb, cib,
                         probe_scores, probe, st);
  if (err) return err;
  Candidates cand{lists, probe, nprobe, L, valid};
  CandidateScorer sc{cand, qn, table, scale, D};
  return g2v_run_topk(sc, cand, nprobe * L, B, 1, Tn, r, nka, nia, nkb, nib, out_scores,
                      out_rows, st);
}
