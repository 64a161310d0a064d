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
// D = 200) and, per query, the probed lists' ids and the real candidates'
// int8 rows and scales (~39 of a list's 128 slots are real at V = 24,447).
//
// Design: two launches a call.
// 1. The probe (k9_probe_kernel): a thread-block cluster a group of QG
//    queries, whose blocks split the centroids.  A block stages its
//    centroid rows in shared memory (16-byte cp.async copies into padded
//    rows; double-buffered tiles where one tile does not hold them all)
//    beside the group's queries, and each thread scores QPT queries
//    against one staged row from registers: each score one in-order fmaf
//    chain over d = 0 .. D-1 from 0.0f, the order of a matrix product's
//    single running sum.  Each block then ranks its own centroids for each
//    query (by counting) and sends its top-nprobe to the block that
//    selects for that query (distributed shared memory), which selects and
//    sorts the top-nprobe of those (the lower centroid first among equal
//    scores, as lax.top_k): no scores or runs reach device memory.
// 2. The scan (topk_common.cuh g2v_list_select): a block, or a cluster of
//    blocks that split the list, a query.  The query's nprobe lists are
//    read once, coalesced; only the real ids (>= 0 and < valid) are kept,
//    in position order, so no warp spends time on list padding (~69% of
//    the positions at the default geometry).  A group of lanes scores a
//    row from 8-byte words (4-byte, or bytes, where the width or address
//    does not allow) with dp4a in int32 — exact in any order — and the
//    K8 rescale, so the approximate scores are bitwise the reference's;
//    the leader selects the top-r and sorts it in the same launch.
// Lists past what a block holds take the chunked route: the scan writes
// runs and g2v_final selects (three launches).
//
// A bf16 table takes the same scan with a bf16 scorer (query rounded to
// bf16, exact bf16 products, float32 sums: each lane's in word order, then
// a shuffle tree over the lanes), as K8's.
#include "topk_common.cuh"

// build knobs for kernel_split.py (1 in a normal build): the scan launch;
// the probe's dots (0: every score 0); the probe's select (0: none)
#ifndef K9_SCAN
#define K9_SCAN 1
#endif
#ifndef K9_PROBE_DOTS
#define K9_PROBE_DOTS 1
#endif
#ifndef K9_PROBE_SELECT
#define K9_PROBE_SELECT 1
#endif

namespace {

constexpr int kProbeThreads = 256;

// Scores of QPT queries against the staged centroid rows: one thread a
// (row, query group) pair, the chain of each score in d order.
template <int QPT>
__global__ void __launch_bounds__(kProbeThreads)
k9_probe_kernel(const float* __restrict__ qn, const float* __restrict__ cent, int C, int D, int B,
                int QG, int Sc, int CL, int nprobe, int TR, int tstride, int cp,
                int* __restrict__ probe) {
  extern __shared__ __align__(16) unsigned char g2v_smem[];
  __shared__ G2vSelect sm;
  const int rank = static_cast<int>(g2v_cluster_rank());
  const int q0 = (blockIdx.x / CL) * QG, nq = min(QG, B - q0);
  const int c0 = rank * Sc, nc = max(0, min(Sc, C - c0));
  const int Dq = (D + 3) & ~3;
  const int QGp = (QG + QPT - 1) / QPT * QPT;
  const int nj = (QG + CL - 1) / CL;  // queries a block selects for
  const int K1 = min(nprobe, Sc);     // candidates a block sends for each query
  int P = 1;
  while (P < nprobe) P <<= 1;
  const auto up = [](size_t x) { return (x + 15) & ~static_cast<size_t>(15); };
  const size_t tile_bytes = up(static_cast<size_t>(TR) * tstride);
  const int nbuf = TR >= Sc ? 1 : 2;  // one tile holds every row: no second buffer
  unsigned char* tiles = g2v_smem;
  float* qs = reinterpret_cast<float*>(tiles + nbuf * tile_bytes);
  int* sk = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(qs) +
                                   up(4 * static_cast<size_t>(QGp) * Dq));
  int* ck = sk + QG * Sc;         // nj x CL x K1 candidates (key) of the queries it selects for
  int* cc = ck + nj * CL * K1;    // ... and their centroids
  int* pk = cc + nj * CL * K1;    // 3 x P for the sort
  const int ntile = (nc + TR - 1) / TR;
  // tile t into buffer t & 1: 16-byte cp.async copies into the padded rows
  // (cp; one commit group a tile), else element by element, zero past D
  const auto stage = [&](int t) {
    unsigned char* dst = tiles + static_cast<size_t>(t & 1) * tile_bytes;
    const int r = c0 + t * TR, rows = min(TR, nc - t * TR);
    if (cp) {
      const int cpr = D / 4;  // 16-byte chunks a row
      for (int c = threadIdx.x; c < rows * cpr; c += blockDim.x) {
        const int i = c / cpr, k = c - i * cpr;
        g2v_cp_async16(dst + static_cast<size_t>(i) * tstride + 16 * k,
                       cent + static_cast<size_t>(r + i) * D + 4 * k);
      }
      return;
    }
    for (int c = threadIdx.x; c < rows * Dq; c += blockDim.x) {
      const int i = c / Dq, d = c - i * Dq;
      reinterpret_cast<float*>(dst + static_cast<size_t>(i) * tstride)[d] =
          d < D ? cent[static_cast<size_t>(r + i) * D + d] : 0.0f;
    }
  };
  const auto commit = [&]() {
    if (cp) asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  G2V_MARK(1, 0);
  if (CL > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (ntile > 0) stage(0);
  commit();
  if (ntile > 1) stage(1);
  commit();  // possibly empty: group t always holds tile t
  g2v_stage_queries_f32(qn, q0, nq, D, Dq, QGp, false, qs);
  const int ngq = QGp / QPT, nd4 = K9_PROBE_DOTS ? Dq / 4 : 0;
  for (int t = 0; t < ntile; ++t) {
    if (cp) asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // groups <= t done
    __syncthreads();  // the tile (and, at t = 0, the queries) in place
    if (t == 0) G2V_MARK(1, 1);
    const int rows = min(TR, nc - t * TR);
    const unsigned char* tile = tiles + static_cast<size_t>(t & 1) * tile_bytes;
    for (int it = threadIdx.x; it < rows * ngq; it += blockDim.x) {
      const int row = it % rows, g = it / rows;
      const float4* x = reinterpret_cast<const float4*>(tile + static_cast<size_t>(row) * tstride);
      const float4* q = reinterpret_cast<const float4*>(qs + static_cast<size_t>(g * QPT) * Dq);
      float acc[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) acc[j] = 0.0f;
      // two register sets in turn: one step's loads in flight during the
      // other's FMAs, with no copies between them
      float4 xa, xb, qa[QPT], qb[QPT];
      const auto load = [&](int d4, float4& xv, float4 (&qv)[QPT]) {
        xv = x[d4];
#pragma unroll
        for (int j = 0; j < QPT; ++j) qv[j] = q[j * (Dq / 4) + d4];
      };
      // column by column across the queries: neighbouring FMAs are of
      // different chains, each chain still in d order
      const auto fma4 = [&](const float4& xv, const float4 (&qv)[QPT]) {
#pragma unroll
        for (int j = 0; j < QPT; ++j) acc[j] = fmaf(qv[j].x, xv.x, acc[j]);
#pragma unroll
        for (int j = 0; j < QPT; ++j) acc[j] = fmaf(qv[j].y, xv.y, acc[j]);
#pragma unroll
        for (int j = 0; j < QPT; ++j) acc[j] = fmaf(qv[j].z, xv.z, acc[j]);
#pragma unroll
        for (int j = 0; j < QPT; ++j) acc[j] = fmaf(qv[j].w, xv.w, acc[j]);
      };
      if (nd4 > 0) load(0, xa, qa);
      int d4 = 0;
      for (; d4 + 1 < nd4; d4 += 2) {
        load(d4 + 1, xb, qb);
        fma4(xa, qa);
        if (d4 + 2 < nd4) load(d4 + 2, xa, qa);
        fma4(xb, qb);
      }
      if (d4 < nd4) fma4(xa, qa);
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        if (g * QPT + j < nq) sk[(g * QPT + j) * Sc + t * TR + row] = g2v_key(acc[j]);
      }
    }
    __syncthreads();  // every thread is done with this buffer
    if (t + 2 < ntile) stage(t + 2);
    commit();
  }
  if (ntile == 0) __syncthreads();
  G2V_MARK(1, 2);
  // each block's top-K1 of its centroids for each query (a select without
  // a sort), sentinels past them, to the block that selects for the query
  if (CL > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  G2V_MARK(1, 6);
  const auto slot_of = [&](int j) { return ((j / CL) * CL + rank) * K1; };
  const auto send = [&](int j, int s, int key, int c) {
    const int owner = j % CL;
    (CL > 1 ? g2v_cluster_map(ck, owner) : ck)[slot_of(j) + s] = key;
    (CL > 1 ? g2v_cluster_map(cc, owner) : cc)[slot_of(j) + s] = c;
  };
  if (nc <= G2V_RANK_MAX) {  // every query's centroids ranked at once, by counting
    for (int it = threadIdx.x; it < (K9_PROBE_SELECT ? nq : 0) * nc; it += blockDim.x) {
      const int j = it / nc, i = it - j * nc;
      const int* keys = sk + j * Sc;
      const int k = keys[i];
      int r = 0;
#pragma unroll 4
      for (int a = 0; a < nc; ++a) r += g2v_before(keys[a], c0 + a, k, c0 + i);
      if (r < K1) send(j, r, k, c0 + i);
    }
  } else {
    for (int j = 0; j < (K9_PROBE_SELECT ? nq : 0); ++j) {
      const int* keys = sk + j * Sc;
      g2v_dense_topk(keys, [&](int i) { return c0 + i; }, nc, K1, false, &sm, pk, pk + P,
                     pk + 2 * P, [&](int s, int i) { send(j, s, keys[i], c0 + i); });
    }
  }
  for (int it = threadIdx.x; it < (K9_PROBE_SELECT ? nq : 0) * K1; it += blockDim.x) {
    const int j = it / K1, s = it - j * K1;
    if (s >= nc) send(j, s, INT_MIN, INT_MAX - (slot_of(j) + s));  // below every centroid
  }
  G2V_MARK(1, 3);
  if (CL > 1) {
    g2v_cluster_sync();
  } else {
    __syncthreads();
  }
  G2V_MARK(1, 4);
  // the top-nprobe of each query this block selects for, sorted
  for (int j = rank, jj = 0; j < (K9_PROBE_SELECT ? nq : 0); j += CL, ++jj) {
    const int* keys = ck + jj * CL * K1;
    const int* cent_of = cc + jj * CL * K1;
    int* out = probe + static_cast<size_t>(q0 + j) * nprobe;
    g2v_dense_topk(keys, [&](int i) { return cent_of[i]; }, CL * K1, nprobe, true, &sm, pk,
                   pk + P, pk + 2 * P, [&](int r, int i) {
                     if (keys[i] != INT_MIN) out[r] = cent_of[i];
                   });
    __syncthreads();  // the sort buffers are reused
  }
  G2V_MARK(1, 5);
}

// Candidate position p of query b -> its row id, or -1 (padding or >= valid).
struct ListSource {
  const int* lists;
  const int* probe;  // (B, nprobe) centroid ids
  int nprobe;
  int L;
  int valid;

  int src_bytes() const { return 4 * nprobe; }

  __device__ void stage(int b, int* smem) const {
    for (int s = threadIdx.x; s < nprobe; s += blockDim.x) smem[s] = probe[b * nprobe + s];
  }

  __device__ int id(int, const int* smem, int p) const {
    const int s = p / L;
    const int row = __ldg(lists + static_cast<size_t>(smem[s]) * L + (p - s * L));
    return (row >= 0 && row < valid) ? row : -1;
  }
};

// int8 rows in words W (uint2, unsigned or signed char): exact int32 sums.
template <class W>
struct Int8Rows {
  using Word = W;
  using QWord = W;
  using Acc = int;
  const signed char* table;
  const float* scale;
  int D;
  int words;
  const W* qw;  // the quantized query as words (zero past D)
  float qs;

  __device__ const W* row(int id) const {
    return reinterpret_cast<const W*>(table + static_cast<size_t>(id) * D);
  }
  __device__ W qword(int w) const { return qw[w]; }
  __device__ float aux(int id) const { return __ldg(scale + id); }
  __device__ void add(const uint2& x, const uint2& q, int& acc) const {
    acc = __dp4a(static_cast<int>(x.x), static_cast<int>(q.x), acc);
    acc = __dp4a(static_cast<int>(x.y), static_cast<int>(q.y), acc);
  }
  __device__ void add(const unsigned& x, const unsigned& q, int& acc) const {
    acc = __dp4a(static_cast<int>(x), static_cast<int>(q), acc);
  }
  __device__ void add(const signed char& x, const signed char& q, int& acc) const {
    acc += static_cast<int>(x) * static_cast<int>(q);
  }
  __device__ float score(int acc, float sc) const { return g2v_rescale(acc, qs, sc); }
};

template <class W>
struct Int8Query {
  const float* qn;
  const signed char* table;
  const float* scale;
  int D;

  __host__ __device__ int stride() const { return (D + 15) & ~15; }  // bytes of the query
  size_t query_bytes() const { return stride() + 16; }

  __device__ void stage(int b, unsigned char* qmem) const {
    g2v_stage_query_int8_block(qn + static_cast<size_t>(b) * D, D, stride(),
                               reinterpret_cast<signed char*>(qmem),
                               reinterpret_cast<float*>(qmem + stride()));
  }
  __device__ Int8Rows<W> bound(const unsigned char* qmem) const {
    return Int8Rows<W>{table, scale, D, D / static_cast<int>(sizeof(W)),
                       reinterpret_cast<const W*>(qmem),
                       *reinterpret_cast<const float*>(qmem + stride())};
  }
};

// bf16 rows in words W (uint4: 8 values, unsigned: 2, unsigned short: 1):
// exact bf16 products, float32 sums.
template <int N>
struct Floats {
  float v[N];
};

template <class W>
struct Bf16Rows {
  static constexpr int kVals = sizeof(W) / 2;
  using Word = W;
  using QWord = Floats<kVals>;
  using Acc = float;
  const __nv_bfloat16* table;
  int D;
  int words;
  const float* q;  // the query rounded to bf16, as floats

  __device__ const W* row(int id) const {
    return reinterpret_cast<const W*>(table + static_cast<size_t>(id) * D);
  }
  __device__ QWord qword(int w) const {
    QWord out;
#pragma unroll
    for (int i = 0; i < kVals; ++i) out.v[i] = q[kVals * w + i];
    return out;
  }
  __device__ float aux(int) const { return 1.0f; }
  // a 32-bit word's two values, the first in its low half
  __device__ void add2(unsigned u, const float* qv, float& acc) const {
    acc = fmaf(qv[0], __uint_as_float(u << 16), acc);
    acc = fmaf(qv[1], __uint_as_float(u & 0xffff0000u), acc);
  }
  __device__ void add(const uint4& x, const QWord& qv, float& acc) const {
    add2(x.x, qv.v, acc);
    add2(x.y, qv.v + 2, acc);
    add2(x.z, qv.v + 4, acc);
    add2(x.w, qv.v + 6, acc);
  }
  __device__ void add(const unsigned& x, const QWord& qv, float& acc) const {
    add2(x, qv.v, acc);
  }
  __device__ void add(const unsigned short& x, const QWord& qv, float& acc) const {
    acc = fmaf(qv.v[0], __uint_as_float(static_cast<unsigned>(x) << 16), acc);
  }
  __device__ float score(float acc, float) const { return acc; }
};

template <class W>
struct Bf16Query {
  const float* qn;
  const __nv_bfloat16* table;
  int D;

  size_t query_bytes() const { return 4 * static_cast<size_t>(D); }

  __device__ void stage(int b, unsigned char* qmem) const {
    g2v_stage_queries_bf16(qn, b, 1, D, D, 1, reinterpret_cast<float*>(qmem));
  }
  __device__ Bf16Rows<W> bound(const unsigned char* qmem) const {
    return Bf16Rows<W>{table, D, D / Bf16Rows<W>::kVals, reinterpret_cast<const float*>(qmem)};
  }
};

template <class Q>
int scan(const ListSource& src, const Q& q, int route, int n, int B, int S, int nseg, int r,
         int lanes, int slot, int stride, int* ka, int* ia, int* kb, int* ib, int* aux,
         float* out_scores, int* out_rows, cudaStream_t st) {
  return g2v_launch_list(src, q, route, n, B, S, nseg, r, lanes, slot, stride, ka, ia, kb, ib,
                         aux, out_scores, out_rows, st);
}

template <int QPT>
int probe_launch(const float* qn, const float* centroids, int C, int D, int B, int QG, int Sc,
                 int CL, int nprobe, int TR, int tstride, int cp, size_t smem, int* probe,
                 cudaStream_t st) {
  int err = g2v_smem_attr(k9_probe_kernel<QPT>, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(CL * ((B + QG - 1) / QG));
  cfg.blockDim = dim3(kProbeThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, k9_probe_kernel<QPT>, qn, centroids, C, D, B,
                                            QG, Sc, CL, nprobe, TR, tstride, cp, probe));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table_bf16 = 0: `table` is int8 with per-row `scale`; 1: bfloat16.
// The probe: clusters of CLc blocks, each block Sc centroids in tiles of
// TR rows (tstride bytes each; 16-byte cp.async copies when cp), for QG
// queries scored QPT at a time; probe receives (B, nprobe) centroid ids.
// The scan (n = nprobe * L positions a query): route 0, clusters of nseg
// blocks of S positions a query; route 1, chunks of S positions, runs of
// `slot` pairs, `stride` pairs a query in ka/ia/kb/ib, aux B * n ints;
// `lanes` lanes a row, rows in words of word_bytes.
G2V_EXPORT int k9_ivf_scan(const float* qn, const float* centroids, const int* lists,
                           const void* table, const float* scale, int table_bf16, int C, int L,
                           int D, int B, int nprobe, int valid, int r, int QG, int QPT, int Sc,
                           int CLc, int TR, int tstride, int cp, int probe_smem, int route,
                           int S, int nseg, int lanes, int word_bytes, int slot, int stride,
                           int* probe, int* ka, int* ia, int* kb, int* ib, int* aux,
                           float* out_scores, int* out_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t psmem = static_cast<size_t>(probe_smem);
  int err = QPT == 4   ? probe_launch<4>(qn, centroids, C, D, B, QG, Sc, CLc, nprobe, TR,
                                           tstride, cp, psmem, probe, st)
            : QPT == 2 ? probe_launch<2>(qn, centroids, C, D, B, QG, Sc, CLc, nprobe, TR,
                                           tstride, cp, psmem, probe, st)
                       : probe_launch<1>(qn, centroids, C, D, B, QG, Sc, CLc, nprobe, TR,
                                           tstride, cp, psmem, probe, st);
  if (err || !K9_SCAN) return err;
  const ListSource src{lists, probe, nprobe, L, valid};
  const int n = nprobe * L;
  const auto go = [&](const auto& q) {
    return scan(src, q, route, n, B, S, nseg, r, lanes, slot, stride, ka, ia, kb, ib, aux,
                out_scores, out_rows, st);
  };
  if (table_bf16) {
    const auto* t = static_cast<const __nv_bfloat16*>(table);
    if (word_bytes == 16) return go(Bf16Query<uint4>{qn, t, D});
    if (word_bytes == 4) return go(Bf16Query<unsigned>{qn, t, D});
    return go(Bf16Query<unsigned short>{qn, t, D});
  }
  const auto* t = static_cast<const signed char*>(table);
  if (word_bytes == 8) return go(Int8Query<uint2>{qn, t, scale, D});
  if (word_bytes == 4) return go(Int8Query<unsigned>{qn, t, scale, D});
  return go(Int8Query<signed char>{qn, t, scale, D});
}
