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
// Design: one launch a call (topk_common.cuh g2v_list_select).  A block,
// or a cluster of blocks that split the list, a query: the query's
// approximate scores and candidate ids are read once, coalesced; the
// candidates whose approximate score is finite are kept in position order;
// a group of lanes scores a row from 16-byte loads (4-byte where the width
// or address does not allow), G2V_LIST_ROWS rows a group in flight, each
// lane summing its words in order and the group's lanes by a shuffle tree
// (a tree of lane sums: less rounding at D = 1,024-1,520 than one running
// sum or four interleaved partials); the leader selects the top-k and
// sorts it in the same launch.  Lists past what a block holds take the
// chunked route (runs, then g2v_final).  Ties order by candidate
// position, as the reference's top_k over its (B, r) matrix.
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

// Candidate position p of query b -> its row, or -1 (approximate score
// not finite: list padding or a row >= valid).
struct RescoreSource {
  const int* ri;
  const float* approx;
  int r;

  int src_bytes() const { return 0; }
  __device__ void stage(int, int*) const {}
  __device__ int id(int b, const int*, int p) const {
    const size_t i = static_cast<size_t>(b) * r + p;
    return isfinite(__ldg(approx + i)) ? __ldg(ri + i) : -1;
  }
};

// float32 unit rows in words W (float4 or float): float32 sums.
template <class W>
struct UnitRows {
  using Word = W;
  using QWord = W;
  using Acc = float;
  const float* unit;
  int D;
  int words;
  const float* q;

  __device__ const W* row(int id) const {
    return reinterpret_cast<const W*>(unit + static_cast<size_t>(id) * D);
  }
  __device__ W qword(int w) const { return reinterpret_cast<const W*>(q)[w]; }
  __device__ float aux(int) const { return 1.0f; }
  __device__ void add(const float4& x, const float4& qv, float& acc) const {
    acc = fmaf(qv.x, x.x, acc);
    acc = fmaf(qv.y, x.y, acc);
    acc = fmaf(qv.z, x.z, acc);
    acc = fmaf(qv.w, x.w, acc);
  }
  __device__ void add(const float& x, const float& qv, float& acc) const {
    acc = fmaf(qv, x, acc);
  }
  __device__ float score(float acc, float) const { return acc; }
};

template <class W>
struct UnitQuery {
  const float* qn;
  const float* unit;
  int D;

  size_t query_bytes() const { return 4 * static_cast<size_t>(D); }

  __device__ void stage(int b, unsigned char* qmem) const {
    g2v_stage_queries_f32(qn, b, 1, D, D, 1, false, reinterpret_cast<float*>(qmem));
  }
  __device__ UnitRows<W> bound(const unsigned char* qmem) const {
    return UnitRows<W>{unit, D, D / static_cast<int>(sizeof(W) / 4),
                       reinterpret_cast<const float*>(qmem)};
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

// route 0: clusters of nseg blocks of S candidates a query (one launch);
// route 1: chunks of S candidates, runs of `slot` pairs, `stride` pairs a
// query in ka/ia/kb/ib, aux B * r ints (two launches).  `lanes` lanes a
// row, rows in words of word_bytes (16 or 4).
G2V_EXPORT int k9r_rescore(const float* qn, const float* unit, const int* ri,
                           const float* approx, int D, int B, int r, int k, int route, int S,
                           int nseg, int lanes, int word_bytes, int slot, int stride, int* ka,
                           int* ia, int* kb, int* ib, int* aux, float* out_scores,
                           int* out_rows, void* stream) {
  const RescoreSource src{ri, approx, r};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (word_bytes == 16) {
    return g2v_launch_list(src, UnitQuery<float4>{qn, unit, D}, route, r, B, S, nseg, k, lanes,
                           slot, stride, ka, ia, kb, ib, aux, out_scores, out_rows, st);
  }
  return g2v_launch_list(src, UnitQuery<float>{qn, unit, D}, route, r, B, S, nseg, k, lanes,
                         slot, stride, ka, ia, kb, ib, aux, out_scores, out_rows, st);
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
