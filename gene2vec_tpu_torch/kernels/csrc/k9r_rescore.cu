// K9r — exact rescore tail, and the row gather on its own.
//
// Replaces: gene2vec_tpu/serve/ann.py:452-467 (_rescore_topk, the tail of
// the jitted serve_topk_quant and serve_topk_ivf programs): ok =
// approx_ok (here: the approximate score is finite — list padding and rows
// >= valid carry -inf), pos = ok ? ri : 0, the float32 unit rows
// unit[pos] dotted exactly with qn, masked candidates at -inf,
// lax.top_k(.., k) and pos taken along.
//
// k9r_row_gather is the gather loop alone, out[i] = table[idx[i]], the
// counterpart of the Pallas row-gather probes
// (experiments/test_pallas_gather.py:31 pallas_gather, a VMEM dynamic
// gather of (32768, 256) f32/bf16 rows; experiments/test_dma2.py:95
// make_gather, a DMA ring gathering E of (24576, 256) f32 rows) and the
// GGIPNN table lookup.  On the TPU a dynamic row index needs a DMA per
// row or a VMEM-resident table; on the H100 rows load straight from
// device memory (or L2), with no staging.
//
// Bound on the H100: bytes — the r candidate rows of each query,
// B*r*D*4 (at most 64 * 2048 * 800 B = 105 MB; 6.5 MB at B = 64, r = 128,
// most of it L2 hits since the 19.6 MB table fits in the 50 MB L2); the
// row gather moves E rows in and E rows out.
//
// Design: the chunked selection of topk_common.cuh with one query a block
// (candidates are per query) and a thread per candidate, which gathers
// its row with float4 loads and takes the float32 dot.  Ties order by
// candidate position, as the reference's top_k over its (B, r) matrix.
//
// The row gather: the one-warp-a-row design (8 rows a block, E/8 blocks
// in waves, each warp's id load and row load two dependent round trips)
// reached 48-59% of its bytes bound on the H100 at E = 32,768.  Now a
// persistent grid (the SM count times the kernel's occupancy) of warps
// that each take a row at a time: the next row's id is loaded before
// this row's words, and every word of the row is loaded (read-only path)
// before any is stored (streaming stores).  Words are 16 bytes when the
// row width and both pointers allow, else 4, else 2.  (Four rows a warp
// with the same loads measured no faster at E = 32,768 and slower at the
// few-hundred-row GGIPNN lookups.)
#include <algorithm>

#include "topk_common.cuh"

namespace {

struct RescoreMap {
  const int* ri;
  const float* approx;
  int r;

  __device__ int row(int b, int p) const {
    const size_t i = static_cast<size_t>(b) * r + p;
    return isfinite(approx[i]) ? ri[i] : -1;
  }

  __device__ int operator()(int b, int p) const {
    const int id = row(b, p);
    return id >= 0 ? id : 0;
  }
};

struct RescoreScorer {
  RescoreMap cand;
  const float* qn;
  const float* unit;
  int D;

  size_t query_bytes() const { return static_cast<size_t>(D) * 4; }

  __device__ void load_queries(unsigned char* qmem, int q0, int nq) const {
    g2v_stage_queries_f32(qn, q0, nq, D, D, nq, false, reinterpret_cast<float*>(qmem));
  }

  __device__ void score_row(const unsigned char* qmem, int q0, int, int p, int* keys,
                            int) const {
    const int id = cand.row(q0, p);
    if (id < 0) {
      keys[0] = g2v_key(-INFINITY);
      return;
    }
    float acc[G2V_QB_MAX];
    g2v_thread_dots_f32<true>(unit + static_cast<size_t>(id) * D,
                        reinterpret_cast<const float*>(qmem), 1, D, acc);
    keys[0] = g2v_key(acc[0]);
  }
};

constexpr int kGatherThreads = 128;
constexpr int kGatherWords = 2;  // words a lane loads of a row before storing

// A persistent grid, a warp a row at a time; lanes over the row's words
// of type W, kGatherWords each loaded before any is stored.
template <class W>
__global__ void __launch_bounds__(kGatherThreads)
    row_gather_kernel(const W* __restrict__ table, const int* __restrict__ idx,
                      W* __restrict__ out, int E, int words) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * kGatherThreads) >> 5;
  int e = (blockIdx.x * kGatherThreads + threadIdx.x) >> 5;
  int id = e < E ? __ldg(idx + e) : 0;
  for (; e < E; e += warps) {
    const int cur = id;
    if (e + warps < E) id = __ldg(idx + e + warps);  // in flight while this row moves
    const W* src = table + static_cast<size_t>(cur) * words;
    W* dst = out + static_cast<size_t>(e) * words;
    for (int w0 = 0; w0 < words; w0 += 32 * kGatherWords) {
      W v[kGatherWords];
#pragma unroll
      for (int k = 0; k < kGatherWords; ++k) {
        const int w = w0 + 32 * k + lane;
        if (w < words) v[k] = __ldg(src + w);
      }
#pragma unroll
      for (int k = 0; k < kGatherWords; ++k) {
        const int w = w0 + 32 * k + lane;
        if (w < words) __stcs(dst + w, v[k]);
      }
    }
  }
}

// Resident blocks a multiprocessor holds of one instantiation (once per
// library: internal linkage).
template <class W>
int gather_occupancy() {
  static int blocks = 0;
  if (blocks == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, row_gather_kernel<W>, kGatherThreads,
                                                      0) != cudaSuccess ||
        n < 1) {
      n = 1;
    }
    blocks = n;
  }
  return blocks;
}

template <class W>
int launch_gather(const void* table, const int* idx, void* out, int E, int words,
                  cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (static_cast<long long>(E) + kGatherThreads / 32 - 1) /
                         (kGatherThreads / 32);
  const long long blocks =
      std::max(1LL, std::min(want, static_cast<long long>(sms) * gather_occupancy<W>()));
  row_gather_kernel<W><<<static_cast<unsigned>(blocks), kGatherThreads, 0, st>>>(
      static_cast<const W*>(table), idx, static_cast<W*>(out), E, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Chunks of CH candidates, one query a block; runs of `slot` pairs,
// `stride` pairs a query in each scratch buffer.
G2V_EXPORT int k9r_rescore(const float* qn, const float* unit, const int* ri,
                           const float* approx, int V, int D, int B, int r, int k, int CH,
                           int slot, int stride, int* ka, int* ia, int* kb, int* ib,
                           float* out_scores, int* out_rows, void* stream) {
  (void)V;
  RescoreMap cand{ri, approx, r};
  RescoreScorer sc{cand, qn, unit, D};
  return g2v_run_topk(sc, cand, r, B, 1, CH, k, slot, stride, ka, ia, kb, ib, out_scores,
                      out_rows, static_cast<cudaStream_t>(stream));
}

// Row width in bytes; 16-byte words when the width and both pointers
// allow, else 4-byte, else 2-byte words (bf16 rows of odd width).
G2V_EXPORT int k9r_row_gather(const void* table, const int* idx, void* out, int E,
                              int row_bytes, void* stream) {
  if (E == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto aligned = [&](unsigned a) {
    return row_bytes % a == 0 && reinterpret_cast<uintptr_t>(table) % a == 0 &&
           reinterpret_cast<uintptr_t>(out) % a == 0;
  };
  if (aligned(16)) return launch_gather<uint4>(table, idx, out, E, row_bytes / 16, st);
  if (aligned(4)) return launch_gather<unsigned>(table, idx, out, E, row_bytes / 4, st);
  return launch_gather<unsigned short>(table, idx, out, E, row_bytes / 2, st);
}
