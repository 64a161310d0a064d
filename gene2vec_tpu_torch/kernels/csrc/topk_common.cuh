// Top-k selection shared by the serving kernels K7, K8, K9, K9r.
//
// K7 and K8 score all n table rows for each of B queries and return each
// query's top-`keep` (score, id) in selection order, in two launches:
//
// 1. Scan.  Rows are cut into chunks of CH rows (CH <= 512); one block
//    scores one chunk for a group of queries and keeps the scores as
//    int32 keys in shared memory.  The block stages the chunk's rows into
//    shared memory asynchronously (double-buffered tiles of TR rows: one
//    TMA bulk copy a tile on an mbarrier for int8 rows, 16-byte cp.async
//    copies into padded rows for float32 and bf16) and scores every query
//    of the batch against each staged tile (g2v_staged_select), so a row
//    leaves device memory once per call.  Rows too wide for even a
//    32-row tile beside one query are staged as d-slices of a tile: each
//    slice's partial score (float32, or the exact int32 sum) waits in the
//    key's place until the last slice adds its own and makes the key.
//    Then the block selects each query's top-min(keep, CH) of the chunk by
//    a radix select (no sort), all queries side by side, and writes them,
//    in no particular order, to the query's run in device memory.
// 2. Final (g2v_final).  One block per query selects the top-keep of its
//    runs by the same radix select, sorts only those survivors
//    (next_pow2(keep) pairs, bitonic, in shared memory), and writes the
//    scores and the ids the caller wants.  Lists longer than G2V_SORT_MAX
//    sort in G2V_SORT_MAX runs that the block then merges pairwise in
//    device memory along the merge path, still in the same launch.
// The (B, n) score matrix never reaches device memory.
//
// K9's scan and K9r score per-query candidate lists: one block or cluster
// a query selects and sorts in one launch (g2v_list_select, the last
// section); lists past what that holds take the chunked runs and
// g2v_final.
//
// Order: lax.top_k's — value descending, +0 ahead of -0, -inf last, the
// lower row first among equal values.  A score's key is its int32 bits ^
// ((bits >> 31) & 0x7fffffff), whose signed order is that total order;
// the select ranks the 64-bit g2v_ord(key, row), which adds the row as
// the tie-break.  Runs are padded with the sentinel (INT_MIN, INT_MAX),
// whose ord is below every real entry's; the runs hold at least keep real
// entries, so a sentinel is never selected.
//
// Radix select: a few bits of the ord a pass, from the top (4 in the scan
// block, a 16-bin histogram for each query, after a pass that skips the
// bits all its entries share; 8 in the final block, a 256-bin histogram
// for each warp).  A pass counts the digits of the
// entries that match the prefix found so far and takes the bin in which
// the count from the top reaches the number still needed.  It stops once
// every entry of that bin is needed: the survivors are then exactly the
// entries whose ord, shifted, is >= the prefix.
#pragma once

#include <cuda_bf16.h>

#include <climits>
#include <cmath>

#include "common.cuh"

#define G2V_TOPK_THREADS 256
#define G2V_FINAL_THREADS 1024
// most queries a staged block scores
#define G2V_QG_MAX 64
// most survivors the final block sorts in shared memory at once
#define G2V_SORT_MAX 8192
// the scan block's select state: 3 double words, 16 bins and 4 words for
// each of up to 64 queries (g2v_block_select_runs)
#define G2V_SELECT_BYTES (G2V_QG_MAX * (3 * 8 + 4 * 20))

__device__ __forceinline__ int g2v_key(float s) {
  const int b = __float_as_int(s);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// The key map is its own inverse.
__device__ __forceinline__ float g2v_unkey(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ bool g2v_before(int ka, int ia, int kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Selection order as one unsigned number: larger goes first.
__device__ __forceinline__ unsigned long long g2v_ord(int key, int row) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(key) ^ 0x80000000u) << 32) |
         static_cast<unsigned>(~row);
}

// Sorts n (a power of two) pairs in shared memory into selection order.
// Every thread of the block must call it; it synchronises before and
// after.
__device__ void g2v_bitonic(int* key, int* idx, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int lo = 2 * stride * (t / stride) + (t % stride);
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;  // this run ends in selection order
        const int kl = key[lo], il = idx[lo], kh = key[hi], ih = idx[hi];
        if (up ? g2v_before(kh, ih, kl, il) : g2v_before(kl, il, kh, ih)) {
          key[lo] = kh; idx[lo] = ih;
          key[hi] = kl; idx[hi] = il;
        }
      }
    }
  }
  __syncthreads();
}

// -- radix select ---------------------------------------------------------

// One warp finds the highest bin b of a 256-bin histogram at which the
// count from the top reaches `need` (<= the total): returns b, with the
// count of the bins above it in *before and its own in *count.  Every
// lane gets the same answer.
__device__ __forceinline__ int g2v_find_bin(const int* hist, int need, int* before, int* count) {
  const int lane = threadIdx.x & 31;
  int c[8];
  int s = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    c[u] = hist[255 - 8 * lane - u];
    s += c[u];
  }
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int excl = incl - s;
  const int src = __ffs(__ballot_sync(0xffffffffu, excl < need && need <= incl)) - 1;
  int bin = 0, bef = 0, cnt = 0;
  if (lane == src) {
    int cum = excl;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (cnt == 0 && cum + c[u] >= need) {
        bin = 255 - 8 * lane - u;
        bef = cum;
        cnt = c[u];
      }
      cum += c[u];
    }
  }
  *before = __shfl_sync(0xffffffffu, bef, src);
  *count = __shfl_sync(0xffffffffu, cnt, src);
  return __shfl_sync(0xffffffffu, bin, src);
}

// The threshold of the first `keep` (1 <= keep <= n) of n entries in
// selection order, found by the whole block (every thread calls it and
// gets the answer); ord(i) is entry i's g2v_ord.  Entry i is among them
// iff (ord(i) >> *shift_out) >= the returned prefix.  Each pass counts 8
// bits, from the top, into per-warp 256-bin histograms (lanes contend
// only within a warp), which the block sums.  hist: 256 shared ints a
// warp and 256 more; bc: 3 shared ints.
template <class Ord>
__device__ unsigned long long g2v_block_threshold(const Ord& ord, int n, int keep, int* hist,
                                                  int* bc, int* shift_out) {
  const int nwarps = blockDim.x >> 5;
  int* own = hist + (threadIdx.x >> 5) * 256;
  int* total = hist + nwarps * 256;
  unsigned long long prefix = 0;
  int shift = 64, need = keep;
  while (shift > 0) {
    const int hi = shift;  // the bits from `hi` up are fixed by prefix
    shift -= 8;
    for (int b = threadIdx.x; b < nwarps * 256; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned long long x = ord(i);
      if (hi == 64 || (x >> hi) == prefix) atomicAdd(&own[(x >> shift) & 255], 1);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < 256; b += blockDim.x) {
      int c = 0;
      for (int w = 0; w < nwarps; ++w) c += hist[w * 256 + b];
      total[b] = c;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      int before, count;
      const int bin = g2v_find_bin(total, need, &before, &count);
      if (threadIdx.x == 0) {
        bc[0] = bin;
        bc[1] = before;
        bc[2] = count;
      }
    }
    __syncthreads();
    prefix = (prefix << 8) | static_cast<unsigned>(bc[0]);
    need -= bc[1];
    const int count = bc[2];
    __syncthreads();  // bc and hist are rewritten by the next pass
    if (count == need) break;
  }
  *shift_out = shift;
  return prefix;
}

// The scan block's select: for each of its nq queries, the top-min(keep,
// nrows) of the chunk's keys (keys + q * kstride, rows r0 + i) go to the
// query's run (out + base0 + q * stride) in no order, padded with the
// sentinel to `slot` pairs.  The queries are selected side by side: each
// has GT = blockDim / next_pow2(nq) threads and a 16-bin histogram.  A
// first pass finds the bits every entry of a query shares (an AND and an
// OR of their ords); then every pass takes the next 4 bits of each open
// query's threshold, until each query's last bin is wholly needed.  Every
// thread of the block calls it.  sel: shared scratch of G2V_SELECT_BYTES.
__device__ void g2v_block_select_runs(const int* keys, int kstride, int nq, int nrows, int r0,
                                      int keep, int slot, size_t base0, int stride, char* sel,
                                      int* __restrict__ okey, int* __restrict__ oidx) {
  int nqp = 1;
  while (nqp < nq) nqp <<= 1;
  const int GT = max(1, static_cast<int>(blockDim.x) / nqp);
  const int q = threadIdx.x / GT, g = threadIdx.x % GT;
  const bool mine = q < nq;
  const int m = min(keep, nrows);
  if (m == nrows) {  // every row survives: copy the keys, coalesced
    for (int t = threadIdx.x; t < nq * slot; t += blockDim.x) {
      const int j = t / slot, i = t - j * slot;
      const size_t o = base0 + static_cast<size_t>(j) * stride + i;
      okey[o] = i < nrows ? keys[j * kstride + i] : INT_MIN;
      oidx[o] = i < nrows ? r0 + i : INT_MAX;
    }
    return;
  }
  unsigned long long* prefix = reinterpret_cast<unsigned long long*>(sel);  // nq
  unsigned long long* all_and = prefix + nq;                                // nq
  unsigned long long* any_or = all_and + nq;                                // nq
  int* hist = reinterpret_cast<int*>(any_or + nq);                          // nq x 16
  int* need = hist + nq * 16;                                               // nq
  int* shift = need + nq;    // nq: the digit a pass counts
  int* fin = shift + nq;     // nq: the final shift, -1 while open
  int* fill = fin + nq;      // nq
  const int* kq = keys + static_cast<size_t>(mine ? q : 0) * kstride;
  const auto ord = [&](int i) { return g2v_ord(kq[i], r0 + i); };
  for (int j = threadIdx.x; j < nq; j += blockDim.x) {
    all_and[j] = ~0ull;
    any_or[j] = 0;
    need[j] = m;
    fin[j] = -1;
    fill[j] = 0;
  }
  __syncthreads();
  if (mine) {
    unsigned long long a = ~0ull, o = 0;
#pragma unroll 4
    for (int i = g; i < nrows; i += GT) {
      const unsigned long long x = ord(i);
      a &= x;
      o |= x;
    }
    atomicAnd(&all_and[q], a);
    atomicOr(&any_or[q], o);
  }
  __syncthreads();
  if (mine && g == 0) {  // start at the nibble of the highest bit that differs
    const int top = 63 - __clzll(all_and[q] ^ any_or[q]);
    const int sh = top & ~3;
    shift[q] = sh;
    prefix[q] = sh >= 60 ? 0 : all_and[q] >> (sh + 4);
  }
  while (true) {
    for (int j = threadIdx.x; j < nq * 16; j += blockDim.x) hist[j] = 0;
    __syncthreads();
    const bool open = mine && fin[q] < 0;
    if (open) {
      const unsigned long long pre = prefix[q];
      const int sh = shift[q];
#pragma unroll 4
      for (int i = g; i < nrows; i += GT) {
        const unsigned long long x = ord(i);
        if (sh >= 60 || (x >> (sh + 4)) == pre) atomicAdd(&hist[q * 16 + ((x >> sh) & 15)], 1);
      }
    }
    __syncthreads();
    if (open && g == 0) {
      int before = 0, b = 15;
      while (before + hist[q * 16 + b] < need[q]) before += hist[q * 16 + b--];
      prefix[q] = (prefix[q] << 4) | static_cast<unsigned>(b);
      need[q] -= before;
      if (hist[q * 16 + b] == need[q] || shift[q] == 0) {
        fin[q] = shift[q];
      } else {
        shift[q] -= 4;
      }
    }
    if (__syncthreads_and(!open || g != 0 || fin[q] >= 0)) break;
  }
  if (mine) {
    int* ok = okey + base0 + static_cast<size_t>(q) * stride;
    int* oi = oidx + base0 + static_cast<size_t>(q) * stride;
    const int sq = fin[q];
    const unsigned long long pre = prefix[q];
    for (int i = g; i < nrows; i += GT) {
      if ((ord(i) >> sq) >= pre) {
        const int p = atomicAdd(&fill[q], 1);
        if (p < m) {  // exactly m pass; the guard keeps a fault in bounds
          ok[p] = kq[i];
          oi[p] = r0 + i;
        }
      }
    }
    for (int i = m + g; i < slot; i += GT) {
      ok[i] = INT_MIN;
      oi[i] = INT_MAX;
    }
  }
}

// -- launch 2: the final select, sort and write -----------------------------

// IdMap interface: __device__ int operator()(int b, int row) const.
struct G2vIdentity {
  __device__ int operator()(int, int row) const { return row; }
};

// Merge-path step: output position j (< la + lb) of the merge of sorted
// runs A (la pairs) and B (lb pairs): the number a of A's pairs among the
// first j outputs is found by a binary search, then the pair at j.
__device__ __forceinline__ void g2v_merge_at(const int* ak, const int* ai, int la, const int* bk,
                                             const int* bi, int lb, int j, int* k, int* r) {
  int lo = max(0, j - lb), hi = min(j, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (g2v_before(ak[mid], ai[mid], bk[j - mid - 1], bi[j - mid - 1])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int a = lo, b = j - lo;
  const bool take_a = a < la && (b >= lb || g2v_before(ak[a], ai[a], bk[b], bi[b]));
  *k = take_a ? ak[a] : bk[b];
  *r = take_a ? ai[a] : bi[b];
}

// One block per query (blockIdx.x): the top-keep of the query's N run
// entries (rk/ri + q * stride), sorted, unkeyed and mapped into out_s /
// out_i (B x keep).  sk/si (+ q * stride) hold the survivors of a list
// longer than G2V_SORT_MAX, and rk/ri then serve as the merge's second
// buffer (stride >= keep).  Dynamic shared memory: 2 * P ints, P =
// next_pow2(min(keep, G2V_SORT_MAX)).
template <class Map>
__global__ void __launch_bounds__(G2V_FINAL_THREADS)
g2v_final(int* rk, int* ri, int* sk, int* si, int N, int stride, int keep, Map map,
          float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char g2v_smem[];
  __shared__ int hist[(G2V_FINAL_THREADS / 32 + 1) * 256];
  __shared__ int bc[3];
  __shared__ int fill;
  const int q = blockIdx.x;
  int* kin = rk + static_cast<size_t>(q) * stride;
  int* iin = ri + static_cast<size_t>(q) * stride;
  const auto ord = [&](int i) { return g2v_ord(kin[i], iin[i]); };
  int shift;
  const unsigned long long prefix = g2v_block_threshold(ord, N, keep, hist, bc, &shift);
  const bool in_smem = keep <= G2V_SORT_MAX;
  int P = 1;
  while (P < min(keep, G2V_SORT_MAX)) P <<= 1;
  int* tk = reinterpret_cast<int*>(g2v_smem);
  int* ti = tk + P;
  int* ck = in_smem ? tk : sk + static_cast<size_t>(q) * stride;
  int* ci = in_smem ? ti : si + static_cast<size_t>(q) * stride;
  if (threadIdx.x == 0) fill = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int k = kin[i], r = iin[i];
    if ((g2v_ord(k, r) >> shift) >= prefix) {
      const int p = atomicAdd(&fill, 1);
      if (p < keep) {  // exactly keep pass; the guard keeps a fault in bounds
        ck[p] = k;
        ci[p] = r;
      }
    }
  }
  float* os = out_s + static_cast<size_t>(q) * keep;
  int* oi = out_i + static_cast<size_t>(q) * keep;
  if (in_smem) {
    for (int i = keep + threadIdx.x; i < P; i += blockDim.x) {
      tk[i] = INT_MIN;
      ti[i] = INT_MAX;
    }
    g2v_bitonic(tk, ti, P);
    for (int i = threadIdx.x; i < keep; i += blockDim.x) {
      os[i] = g2v_unkey(tk[i]);
      oi[i] = map(q, ti[i]);
    }
    return;
  }
  // long lists: sort runs of G2V_SORT_MAX in shared memory, then merge
  // pairs of runs between the two device buffers
  __syncthreads();
  for (int c0 = 0; c0 < keep; c0 += G2V_SORT_MAX) {
    const int len = min(G2V_SORT_MAX, keep - c0);
    for (int i = threadIdx.x; i < G2V_SORT_MAX; i += blockDim.x) {
      tk[i] = i < len ? ck[c0 + i] : INT_MIN;
      ti[i] = i < len ? ci[c0 + i] : INT_MAX;
    }
    g2v_bitonic(tk, ti, G2V_SORT_MAX);
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      ck[c0 + i] = tk[i];
      ci[c0 + i] = ti[i];
    }
    __syncthreads();
  }
  int *ak = ck, *ai = ci, *bk = kin, *bi = iin;
  for (int L = G2V_SORT_MAX; L < keep; L <<= 1) {
    const bool last = 2 * L >= keep;
    for (int i = threadIdx.x; i < keep; i += blockDim.x) {
      const int a0 = i / (2 * L) * (2 * L);
      const int la = min(L, keep - a0);
      const int lb = max(0, min(L, keep - a0 - L));
      int k, r;
      g2v_merge_at(ak + a0, ai + a0, la, ak + a0 + la, ai + a0 + la, lb, i - a0, &k, &r);
      if (last) {
        os[i] = g2v_unkey(k);
        oi[i] = map(q, r);
      } else {
        bk[i] = k;
        bi[i] = r;
      }
    }
    __syncthreads();
    int* t = ak; ak = bk; bk = t;
    t = ai; ai = bi; bi = t;
  }
}

static inline int g2v_next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Opts a kernel in to `bytes` of dynamic shared memory; past 8 KB always,
// since a kernel's static shared memory counts against the 48 KB default.
template <class K>
static int g2v_smem_attr(K kernel, size_t bytes) {
  if (bytes <= 8 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// Launch 2 over runs of `slot` pairs from nchunks chunks.  Scratch: ka/ia
// the runs, kb/ib the long-list survivors, each B * stride ints.
template <class Map>
static int g2v_launch_final(const Map& map, int B, int nchunks, int slot, int stride, int keep,
                            int* ka, int* ia, int* kb, int* ib, float* out_scores,
                            int* out_ids, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(g2v_next_pow2(min(keep, G2V_SORT_MAX))) * 4;
  int err = g2v_smem_attr(g2v_final<Map>, smem);
  if (err) return err;
  // a short list takes four warps, whose passes (histograms cleared and
  // summed, barriers) cost less; longer ones take all 32, whose many loads
  // in flight a pass needs more
  const int N = nchunks * slot;
  const int threads = N <= 256 ? 128 : G2V_FINAL_THREADS;
  g2v_final<Map><<<B, threads, smem, stream>>>(ka, ia, kb, ib, N, stride, keep, map,
                                               out_scores, out_ids);
  return static_cast<int>(cudaGetLastError());
}

// -- query staging --------------------------------------------------------------

// Block-wide staging of f32 query rows q0..q0+nq-1 into qs_out: rows of
// `stride` floats, rows [nq, rows_out) and columns [D, stride) zero;
// optionally normalized (q / max(|q|, 1e-12), the norm summed in a fixed
// order: each lane of warp j strides the row of query j, then a shuffle
// tree, and the same warp divides the row), so every block that stages a
// query gets the same qn.  The loads are unrolled so that many are in
// flight at once.
__device__ void g2v_stage_queries_f32(const float* __restrict__ q, int q0, int nq, int D,
                                      int stride, int rows_out, bool normalize, float* qs_out) {
#pragma unroll 8
  for (int i = threadIdx.x; i < rows_out * stride; i += blockDim.x) {
    const int j = i / stride, d = i - j * stride;
    qs_out[i] = (j < nq && d < D) ? __ldg(q + static_cast<size_t>(q0 + j) * D + d) : 0.0f;
  }
  if (!normalize) return;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < nq; j += blockDim.x >> 5) {
    float* row = qs_out + j * stride;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(row[d], row[d], s);
    const float norm = fmaxf(__fsqrt_rn(g2v_warp_sum(s)), 1e-12f);
    for (int d = lane; d < D; d += 32) row[d] = __fdiv_rn(row[d], norm);
  }
}

// Staging of int8 queries: each normalized f32 query is quantized per row
// as the reference's _quantize_queries — scale max(max|q| / 127, 1e-12),
// rint (half to even), clip to +-127.  XLA folds the division by the
// constant 127 into a product with fl(1/127), so the scale is that
// correctly rounded product; q / scale is the correctly rounded
// __fdiv_rn.  The int8 values and scales are bitwise the reference's.
// Layout: rows of `stride` int8 (rows [nq, rows_out) and columns [D,
// stride) zero: a zero adds exactly 0 to an int32 dot), scales apart.
__device__ void g2v_stage_queries_int8(const float* __restrict__ qn, int q0, int nq, int D,
                                       int stride, int rows_out, signed char* qq,
                                       float* qscale) {
  for (int i = threadIdx.x; i < rows_out * stride; i += blockDim.x) {
    const int j = i / stride;
    if (j >= nq || i - j * stride >= D) qq[i] = 0;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < nq; j += blockDim.x >> 5) {
    const float* row = qn + static_cast<size_t>(q0 + j) * D;
    float m = 0.0f;
#pragma unroll 8
    for (int d = lane; d < D; d += 32) m = fmaxf(m, fabsf(__ldg(row + d)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float s = fmaxf(__fmul_rn(m, 1.0f / 127.0f), 1e-12f);
#pragma unroll 8
    for (int d = lane; d < D; d += 32) {
      const float v = rintf(__fdiv_rn(__ldg(row + d), s));
      qq[j * stride + d] = static_cast<signed char>(fminf(fmaxf(v, -127.0f), 127.0f));
    }
    if (lane == 0) qscale[j] = s;
  }
}

// One normalized f32 query quantized as g2v_stage_queries_int8 does, by
// the whole block: the max |q| (order-free) by warp shuffles and one
// barrier, then every column at once.  qq: `stride` bytes (zero past D).
__device__ void g2v_stage_query_int8_block(const float* __restrict__ row, int D, int stride,
                                           signed char* qq, float* qscale) {
  __shared__ float wmax[32];
  float m = 0.0f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) m = fmaxf(m, fabsf(__ldg(row + d)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) m = fmaxf(m, wmax[w]);
  const float s = fmaxf(__fmul_rn(m, 1.0f / 127.0f), 1e-12f);
  for (int d = threadIdx.x; d < stride; d += blockDim.x) {
    const float v = d < D ? rintf(__fdiv_rn(__ldg(row + d), s)) : 0.0f;
    qq[d] = static_cast<signed char>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
  if (threadIdx.x == 0) *qscale = s;
}

// float(acc) * qs * scale, in that order, each product correctly rounded
// (no contraction) — the reference's rescale.
__device__ __forceinline__ float g2v_rescale(int acc, float qs, float scale) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), qs), scale);
}

// Staging of bf16-table queries: each normalized f32 query rounded to
// bfloat16 (round to nearest even, as the reference's astype) and held as
// float, rows of `stride` floats (rows [nq, rows_out) and columns [D,
// stride) zero).
__device__ void g2v_stage_queries_bf16(const float* __restrict__ qn, int q0, int nq, int D,
                                       int stride, int rows_out, float* qs_out) {
#pragma unroll 8
  for (int i = threadIdx.x; i < rows_out * stride; i += blockDim.x) {
    const int j = i / stride, d = i - j * stride;
    qs_out[i] = (j < nq && d < D)
        ? __bfloat162float(__float2bfloat16_rn(__ldg(qn + static_cast<size_t>(q0 + j) * D + d)))
        : 0.0f;
  }
}

// -- launch 1, staged tiles (K7, K8) ----------------------------------------

__device__ __forceinline__ uint32_t g2v_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void g2v_bulk_load(void* dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(g2v_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void g2v_wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// How a table's rows reach shared memory: G2V_STAGE_TMA, the whole tile
// (its rows as stored, tstride == row_bytes) in one TMA bulk copy on an
// mbarrier; G2V_STAGE_CP_ASYNC, 16-byte cp.async copies by every thread
// into rows of tstride bytes (row_bytes a multiple of 16, 16-byte aligned
// rows); G2V_STAGE_COPY, element by element, zero-padding each row to
// tstride (any width or alignment).
#define G2V_STAGE_TMA 0
#define G2V_STAGE_CP_ASYNC 1
#define G2V_STAGE_COPY 2

struct G2vStaging {
  const unsigned char* base;  // the table
  int row_bytes;              // one row in device memory
  int tstride;                // one staged row (of a d-slice) in shared memory
  int mode;                   // G2V_STAGE_* (TMA only with whole rows)
  int slice;                  // elements of a row a d-slice stages: D for whole rows
  int elem;                   // bytes an element
};

// Score parts: a d-slice's partial starts a score (first), finishes it
// into a key (last), or both (whole rows).
#define G2V_PART_FIRST 1
#define G2V_PART_LAST 2

__device__ __forceinline__ void g2v_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(g2v_smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Host side: shared memory rows of `row_bytes` at least, 16-byte
// multiples, a word stride = 4 mod 8 so that eight rows read at one
// column fall in eight distinct 16-byte bank groups.
static inline int g2v_padded_stride(int bytes) {
  int s = (bytes + 15) & ~15;
  if ((s / 4) % 8 == 0) s += 16;
  return s;
}

static inline size_t g2v_tile_bytes(int TR, int tstride) {
  return (static_cast<size_t>(TR) * tstride + 32 + 127) & ~static_cast<size_t>(127);
}

// Float32 or bfloat16 table rows for the SIMT scorer: 4 elements from
// shared memory as floats.
__device__ __forceinline__ float4 g2v_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 g2v_ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Block-wide zero-padded copy of `rows` table rows (the ds elements of T
// from column d0 of row r on) into a tile of tstride-byte rows: the
// staging of a table whose rows cannot be bulk-copied.
template <class T>
__device__ void g2v_copy_rows(const T* __restrict__ table, int D, int r, int rows, int tstride,
                              unsigned char* tile, int d0, int ds) {
  const int per_row = tstride / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int j = i / per_row, d = i - j * per_row;
    reinterpret_cast<T*>(tile + static_cast<size_t>(j) * tstride)[d] =
        d < ds ? table[static_cast<size_t>(r + j) * D + d0 + d] : T(0.0f);
  }
}

// Where query q's score against tile row `row` goes: a partial (float32
// bits, or int32) kept in its key's place, or, at the last part, the key.
__device__ __forceinline__ void g2v_put_score(int* key, float acc, int part, bool masked) {
  if (!(part & G2V_PART_FIRST)) acc += __int_as_float(*key);
  *key = part & G2V_PART_LAST ? g2v_key(masked ? -INFINITY : acc) : __float_as_int(acc);
}

// SIMT scoring of a staged tile (rows of T, tstride bytes each, zero past
// D) against nq staged f32 queries (rows of qstride floats, zero past nq
// up to g2v_simt_query_rows and past D): the 256 threads cut the (query,
// row) plane into QPT x 4 micro-tiles — TQ query groups x TR / 4 row
// groups — and, where fewer query groups than 64 / QPT are needed, the
// width D into KS slices summed by a shuffle tree.  Each thread reads
// float4s of QPT queries and 4 rows a step (the next step's while this
// one's FMAs run) and makes 16 QPT FMAs: 8 queries a thread (a full
// batch) load 12 float4s for 128 FMAs, 4 load 8 for 64.  keys[q * kstride
// + i] = the key of query q against tile row i (row r + i; -inf at or
// past `valid`).  A d-slice tile holds columns d0 .. d0 + D of the rows
// (D its width), scored against the queries' same columns; `part` says
// where its partial goes (g2v_put_score).
template <class T, int QPT>
__device__ void g2v_simt_tile_q(const unsigned char* tile, int tstride, const float* qs,
                                int qstride, int nq, int D, int rows, int TR, int r, int valid,
                                int d0, int part, int* keys, int kstride) {
  int TQ = 1;
  while (TQ < 64 / QPT && QPT * TQ < nq) TQ <<= 1;
  const int RT = TR / 4;
  const int KS = G2V_TOPK_THREADS / (TQ * RT);
  const int tid = threadIdx.x;
  const int ks = tid % KS, rt = (tid / KS) % RT, tq = tid / (KS * RT);
  float acc[QPT][4];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  const int D4 = (D + 3) >> 2;
  const float* qrow = qs + static_cast<size_t>(QPT * tq) * qstride + d0;
  const T* xrow = reinterpret_cast<const T*>(tile + static_cast<size_t>(rt) * tstride);
  const int xstep = RT * tstride / static_cast<int>(sizeof(T));  // elements between its rows
  float4 qv[QPT], xv[4];
  const auto load = [&](int d4, float4 (&qd)[QPT], float4 (&xd)[4]) {
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      qd[i] = *reinterpret_cast<const float4*>(qrow + i * qstride + 4 * d4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) xd[j] = g2v_ld4(xrow + j * xstep + 4 * d4);
  };
  if (ks < D4) load(ks, qv, xv);
  for (int d4 = ks; d4 < D4; d4 += KS) {
    float4 qn[QPT], xn[4];
    const bool more = d4 + KS < D4;
    if (more) load(d4 + KS, qn, xn);
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(qv[i].x, xv[j].x, acc[i][j]);
        acc[i][j] = fmaf(qv[i].y, xv[j].y, acc[i][j]);
        acc[i][j] = fmaf(qv[i].z, xv[j].z, acc[i][j]);
        acc[i][j] = fmaf(qv[i].w, xv[j].w, acc[i][j]);
      }
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < QPT; ++i) qv[i] = qn[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xn[j];
    }
  }
  for (int o = KS >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
    }
  }
  if (ks != 0) return;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = QPT * tq + i, row = rt + RT * j;
      if (q < nq && row < rows) {
        g2v_put_score(keys + q * kstride + row, acc[i][j], part, r + row >= valid);
      }
    }
  }
}

template <class T>
__device__ void g2v_simt_tile(const unsigned char* tile, int tstride, const float* qs,
                              int qstride, int nq, int D, int rows, int TR, int r, int valid,
                              int d0, int part, int* keys, int kstride) {
  if (nq > 32) {
    g2v_simt_tile_q<T, 8>(tile, tstride, qs, qstride, nq, D, rows, TR, r, valid, d0, part, keys,
                          kstride);
  } else {
    g2v_simt_tile_q<T, 4>(tile, tstride, qs, qstride, nq, D, rows, TR, r, valid, d0, part, keys,
                          kstride);
  }
}

// int8 tensor-core scoring of a staged tile: rows of tstride bytes (only
// the first D of each row count: the queries are zero past D, so
// whatever lies beyond adds exactly 0) against nq staged int8 queries
// (rows of qstride bytes, zero past D up to the next multiple of 32 and
// past nq up to the next multiple of 16).  mma.sync m16n8k32 s8 x s8 ->
// s32: warp w takes the tile's 8-row slab w % (TR / 8) and every
// (8 / (TR / 8))-th 16-query slab; the int32 sums are exact and the
// rescale is the reference's, so the scores are bitwise.  A d-slice tile
// (columns d0 .. d0 + D, d0 a multiple of 32) keeps its exact int32 sums
// in the keys' place until the last slice rescales their total.
__device__ void g2v_imma_tile(const unsigned char* tile, int tstride, const signed char* qq,
                              int qstride, const float* qscale, const float* __restrict__ scale,
                              int nq, int D, int rows, int TR, int r, int valid, int d0, int part,
                              int* keys, int kstride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NT = TR / 8, WPN = (G2V_TOPK_THREADS / 32) / NT;
  const int nt = warp % NT;
  const int MT = (nq + 15) >> 4, Dk = (D + 31) & ~31;
  const unsigned char* brow = tile + static_cast<size_t>(8 * nt + g) * tstride + 4 * t;
  for (int m = warp / NT; m < MT; m += WPN) {
    int c[4] = {0, 0, 0, 0};
    const signed char* alo = qq + static_cast<size_t>(16 * m + g) * qstride + d0 + 4 * t;
    const signed char* ahi = alo + 8 * qstride;
    for (int k0 = 0; k0 < Dk; k0 += 32) {
      const int a0 = *reinterpret_cast<const int*>(alo + k0);
      const int a1 = *reinterpret_cast<const int*>(ahi + k0);
      const int a2 = *reinterpret_cast<const int*>(alo + k0 + 16);
      const int a3 = *reinterpret_cast<const int*>(ahi + k0 + 16);
      const int b0 = *reinterpret_cast<const int*>(brow + k0);
      const int b1 = *reinterpret_cast<const int*>(brow + k0 + 16);
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
          "{%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = 16 * m + g + 8 * (e >> 1), row = 8 * nt + 2 * t + (e & 1);
      if (q < nq && row < rows) {
        const int rg = r + row;
        int* key = keys + q * kstride + row;
        const int sum = part & G2V_PART_FIRST ? c[e] : c[e] + *key;
        *key = part & G2V_PART_LAST
                   ? g2v_key(rg >= valid ? -INFINITY
                                         : g2v_rescale(sum, qscale[q], __ldg(scale + rg)))
                   : sum;
      }
    }
  }
}

// Staged scorer interface (one struct per kernel, passed by value):
//   G2vStaging st;                                   how rows are staged
//   __device__ void load_queries(unsigned char* qmem, int q0, int nq, int QG) const;
//   __device__ void copy_rows(unsigned char* tile, int r, int rows, int d0, int ds) const;
//       the block-wide staging in G2V_STAGE_COPY mode (columns d0 .. d0 + ds)
//   __device__ void score_tile(const unsigned char* tile, const unsigned char* qmem,
//                              int nq, int r, int rows, int TR, int d0, int ds, int part,
//                              int* keys, int kstride) const;
// Grid: chunks of CH rows x query groups of QG.  Shared memory: two tiles
// of tile_bytes, the queries (query_bytes), QG x CH keys, the warps'
// histograms.  A block stages tiles t and t + 1 ahead of scoring: the
// copy of tile t + 2 starts once tile t is scored, so copies overlap
// scoring; all QG queries score each tile while it is in shared memory.
// With d-slices (kSliced: st.slice < the row's elements) a stage is one
// slice of a tile, the slices of a tile in turn, its keys summed across
// them; whole rows compile with one slice, each score first and last.
template <class S, bool kSliced>
__global__ void __launch_bounds__(G2V_TOPK_THREADS)
g2v_staged_select(S sc, int n, int B, int QG, int CH, int TR, int tile_bytes, int query_bytes,
                  int keep, int slot, int stride, int* __restrict__ okey,
                  int* __restrict__ oidx) {
  extern __shared__ __align__(16) unsigned char g2v_smem[];
  __shared__ __align__(8) unsigned long long bars[2];
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QG;
  const int nq = min(QG, B - q0);
  const int r0 = chunk * CH;
  const int nrows = min(CH, n - r0);
  const int ntile = (nrows + TR - 1) / TR;
  const int lane = threadIdx.x & 31;
  const G2vStaging st = sc.st;
  const int width = st.row_bytes / st.elem;          // D
  const int nsl = kSliced ? (width + st.slice - 1) / st.slice : 1;  // d-slices a tile
  const int nunits = ntile * nsl;
  unsigned char* qmem = g2v_smem + 2 * static_cast<size_t>(tile_bytes);
  int* keys = reinterpret_cast<int*>(qmem + query_bytes);
  char* sel = reinterpret_cast<char*>(keys + static_cast<size_t>(QG) * CH);
  const bool tma = st.mode == G2V_STAGE_TMA, cp = st.mode == G2V_STAGE_CP_ASYNC;
  if (tma && threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(g2v_smem_addr(&bars[b])),
                   "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stages unit u (tile u / nsl, its d-slice u % nsl) into buffer u & 1;
  // cp.async copies then form one group
  const auto stage = [&](int u) {
    unsigned char* dst = g2v_smem + static_cast<size_t>(u & 1) * tile_bytes;
    const int t = u / nsl, d0 = (u % nsl) * st.slice, ds = min(st.slice, width - d0);
    const int r = r0 + t * TR, rows = min(TR, nrows - t * TR);
    const unsigned char* src =
        st.base + static_cast<size_t>(r) * st.row_bytes + static_cast<size_t>(d0) * st.elem;
    if (cp) {
      const int cpr = (ds * st.elem) >> 4;
      for (int c = threadIdx.x; c < rows * cpr; c += blockDim.x) {
        const int i = c / cpr, k = c - i * cpr;
        g2v_cp_async16(dst + static_cast<size_t>(i) * st.tstride + 16 * k,
                       src + static_cast<size_t>(i) * st.row_bytes + 16 * k);
      }
      return;
    }
    if (!tma) {
      sc.copy_rows(dst, r, rows, d0, ds);
      return;
    }
    if (threadIdx.x >= 32) return;
    const uint32_t bar = g2v_smem_addr(&bars[t & 1]);
    const uint32_t bytes = static_cast<uint32_t>(rows) * st.row_bytes;
    const uint32_t bulk = bytes & ~15u;
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(bulk)
                   : "memory");
      if (bulk) g2v_bulk_load(dst, src, bulk, bar);
    }
    for (uint32_t i = bulk + lane; i < bytes; i += 32) dst[i] = src[i];  // < 16 bytes
  };
  const auto commit = [&]() {
    if (cp) asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0);
  commit();
  if (nunits > 1) stage(1);
  commit();  // possibly empty: group g always holds unit g
  sc.load_queries(qmem, q0, nq, QG);
  for (int u = 0; u < nunits; ++u) {
    const int t = u / nsl, sl = u % nsl;
    if (tma) g2v_wait_phase(g2v_smem_addr(&bars[u & 1]), (u >> 1) & 1);
    if (cp) asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // groups <= u done
    __syncthreads();  // the tile (and, at u = 0, the queries) in place
    const int part = !kSliced ? G2V_PART_FIRST | G2V_PART_LAST
                              : (sl == 0 ? G2V_PART_FIRST : 0) |
                                    (sl == nsl - 1 ? G2V_PART_LAST : 0);
    sc.score_tile(g2v_smem + static_cast<size_t>(u & 1) * tile_bytes, qmem, nq, r0 + t * TR,
                  min(TR, nrows - t * TR), TR, sl * st.slice, min(st.slice, width - sl * st.slice),
                  part, keys + t * TR, CH);
    __syncthreads();  // every thread is done with this buffer
    if (u + 2 < nunits) stage(u + 2);
    commit();
  }
  if (tma && threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(g2v_smem_addr(&bars[b]))
                   : "memory");
    }
  }
  g2v_block_select_runs(keys, CH, nq, nrows, r0, keep, slot,
                        static_cast<size_t>(q0) * stride + static_cast<size_t>(chunk) * slot,
                        stride, sel, okey, oidx);
}

// Runs the staged scan, then the final launch: two launches a call.
// Returns a cudaError_t.
template <class S>
static int g2v_run_staged(const S& sc, int query_bytes, int n, int B, int QG, int CH, int TR,
                          int keep, int slot, int stride, int* ka, int* ia, int* kb, int* ib,
                          float* out_scores, int* out_ids, cudaStream_t stream) {
  const int nchunks = (n + CH - 1) / CH;
  const int tile_bytes = static_cast<int>(g2v_tile_bytes(TR, sc.st.tstride));
  const size_t smem = 2 * static_cast<size_t>(tile_bytes) + query_bytes +
                      static_cast<size_t>(QG) * CH * 4 + G2V_SELECT_BYTES;
  const auto kernel = sc.st.slice < sc.st.row_bytes / sc.st.elem ? g2v_staged_select<S, true>
                                                                  : g2v_staged_select<S, false>;
  int err = g2v_smem_attr(kernel, smem);
  if (err) return err;
  kernel<<<dim3(nchunks, (B + QG - 1) / QG), G2V_TOPK_THREADS, smem, stream>>>(
      sc, n, B, QG, CH, TR, tile_bytes, query_bytes, keep, slot, stride, ka, ia);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return g2v_launch_final(G2vIdentity{}, B, nchunks, slot, stride, keep, ka, ia, kb, ib,
                          out_scores, out_ids, stream);
}

// Rows of staged f32 queries for QG queries: 4 x the next power of two
// of ceil(QG / 4), as far as the SIMT scorer's query groups read (for
// QG > 32 that is 64, which 8 x the next power of two of ceil(QG / 8)
// also is).
__host__ __device__ inline int g2v_simt_query_rows(int QG) {
  int tq = 1;
  while (4 * tq < QG) tq <<= 1;
  return 4 * tq;
}

// -- one query's candidate list in one block or cluster (K9's scan, K9r) ----
//
// K9's scan and K9r score per-query candidate lists (probed inverted
// lists; the approximate top-r) whose rows are scattered in the table.
// A query's list of n candidate positions is cut into segments of S
// positions.  A block takes one segment: it loads the segment's candidate
// ids once, coalesced, keeps only the real ones (dropping list padding
// and masked rows) in position order in shared memory, then scores those
// rows with a group of `lanes` lanes a row — neighbouring lanes on
// neighbouring words, G2V_LIST_ROWS rows a group at once, every word of
// them loaded before any is used — and sums each row's lanes with
// shuffles.  Then either
// - (kRuns false) the query's segments are the blocks of one thread-block
//   cluster (or one block): each sends its own top-min(keep, S) (key,
//   position, id) — a select without a sort — to the leader's shared
//   memory (distributed shared memory), and the leader packs them, selects
//   the top-keep and sorts it in the same launch; or
// - (kRuns true, lists past what a cluster holds) each segment is a chunk
//   of the chunked selection: the block writes its top-min(keep, S) to the
//   query's run for g2v_final, the second launch.
// A kept candidate's tie is its candidate position: lax.top_k's order over
// the reference's (B, n) candidate matrix.  Selects of up to G2V_RANK_MAX
// entries rank them by counting, larger ones take the radix threshold.
// Past the real candidates the output holds -inf with row 0, as the
// reference's masked positions.

#define G2V_LIST_THREADS 256
// most blocks a query's cluster holds (the portable cluster size)
#define G2V_LIST_CLUSTER_MAX 8
// rows a lane group scores at once, and words a lane loads of each
#define G2V_LIST_ROWS 4
#define G2V_LIST_WORDS 4
// entries at most that a select ranks by counting (one pass, no barrier);
// more take the radix threshold and, for a sorted result, the bitonic sort
#define G2V_RANK_MAX G2V_LIST_THREADS
// build knobs for kernel_split.py (1 in a normal build): the select after
// the scores; the row loads (0 scores each row by its id alone); the
// compaction (0 keeps no candidate)
#ifndef G2V_LIST_COMPACT
#define G2V_LIST_COMPACT 1
#endif
#ifndef G2V_LIST_SELECT
#define G2V_LIST_SELECT 1
#endif
#ifndef G2V_LIST_LOADS
#define G2V_LIST_LOADS 1
#endif
// build knob for kernel_split.py (0 in a normal build): each block's
// first thread stamps clock64() at its phase boundaries into
// g2v_trace_buf[kernel][block][phase] (kernel 0: the list select, 1: K9's
// probe), which g2v_trace_read copies out
#ifndef G2V_TRACE
#define G2V_TRACE 0
#endif
#define G2V_TRACE_BLOCKS 1024
#define G2V_TRACE_PHASES 8
#if G2V_TRACE
__device__ long long g2v_trace_buf[2][G2V_TRACE_BLOCKS][G2V_TRACE_PHASES];
#define G2V_MARK(kernel, phase)                                                      \
  do {                                                                               \
    const int blk_ = blockIdx.x + gridDim.x * blockIdx.y;                            \
    if (threadIdx.x == 0 && blk_ < G2V_TRACE_BLOCKS) {                               \
      g2v_trace_buf[kernel][blk_][phase] = clock64();                                \
    }                                                                                \
  } while (0)
G2V_EXPORT int g2v_trace_read(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g2v_trace_buf, sizeof(g2v_trace_buf)));
}
G2V_EXPORT int g2v_trace_clear() {
  void* p = nullptr;
  const int err = static_cast<int>(cudaGetSymbolAddress(&p, g2v_trace_buf));
  return err ? err : static_cast<int>(cudaMemset(p, 0, sizeof(g2v_trace_buf)));
}
#else
#define G2V_MARK(kernel, phase) \
  do {                          \
  } while (0)
#endif

// One query's select state (block-wide).
struct G2vSelect {
  unsigned long long all_and, any_or;
  int hist[256];
  int bc[3];
  int fill;
};

// hist[bin] += 1 for this lane (bin 256: none), the lanes running
// together that share a bin adding once: entries crowd a few bins in a
// select's first passes, and same-address shared-memory atomics
// serialize.
__device__ __forceinline__ void g2v_count_bin(int* hist, int bin) {
  const unsigned peers = __match_any_sync(__activemask(), bin);
  if (bin < 256 && __ffs(peers) - 1 == static_cast<int>(threadIdx.x & 31)) {
    atomicAdd(&hist[bin], __popc(peers));
  }
}

// A slot of `*fill` for each lane with `take`, one atomic for the lanes
// running together; -1 for the others.
__device__ __forceinline__ int g2v_take_slot(int* fill, bool take) {
  const unsigned act = __activemask();
  const unsigned mask = __ballot_sync(act, take);
  if (!take) return -1;
  const int lane = threadIdx.x & 31, leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(fill, __popc(mask));
  base = __shfl_sync(mask, base, leader);
  return base + __popc(mask & ((1u << lane) - 1));
}

// The threshold of the first `keep` (< the count) of the entries that
// `each` visits, in selection order: entry (key, tie) is among them iff
// (g2v_ord(key, tie) >> *hi_out) >= the returned prefix.  `each(f)` calls
// f(key, tie) for every entry this thread owns, the same ones each call;
// ties are distinct.  A first pass finds the bits every entry shares (an
// AND and an OR of the ords); each further pass counts the next 8 bits of
// the entries that match the prefix so far into one 256-bin histogram and
// takes the bin in which the count from the top reaches the number still
// needed, until every entry of that bin is needed.  Every thread calls it.
template <class Each>
__device__ unsigned long long g2v_list_threshold(const Each& each, int keep, G2vSelect* sm,
                                                 int* hi_out) {
  if (threadIdx.x == 0) {
    sm->all_and = ~0ull;
    sm->any_or = 0ull;
  }
  __syncthreads();
  unsigned long long a = ~0ull, o = 0ull;
  each([&](int k, int t) {
    const unsigned long long x = g2v_ord(k, t);
    a &= x;
    o |= x;
  });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a &= __shfl_xor_sync(0xffffffffu, a, off);
    o |= __shfl_xor_sync(0xffffffffu, o, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAnd(&sm->all_and, a);
    atomicOr(&sm->any_or, o);
  }
  __syncthreads();
  int hi = 64 - __clzll(sm->all_and ^ sm->any_or);  // bits [hi, 64) are shared
  unsigned long long prefix = hi >= 64 ? 0ull : sm->all_and >> hi;
  int need = keep;
  while (true) {
    const int lo = max(0, hi - 8), width = hi - lo;
    for (int b = threadIdx.x; b < 256; b += blockDim.x) sm->hist[b] = 0;
    __syncthreads();
    each([&](int k, int t) {
      const unsigned long long x = g2v_ord(k, t);
      const bool in = hi >= 64 || (x >> hi) == prefix;
      g2v_count_bin(sm->hist, in ? static_cast<int>((x >> lo) & ((1u << width) - 1)) : 256);
    });
    __syncthreads();
    if (threadIdx.x < 32) {
      int before, count;
      const int bin = g2v_find_bin(sm->hist, need, &before, &count);
      if (threadIdx.x == 0) {
        sm->bc[0] = bin;
        sm->bc[1] = before;
        sm->bc[2] = count;
      }
    }
    __syncthreads();
    prefix = (prefix << width) | static_cast<unsigned>(sm->bc[0]);
    need -= sm->bc[1];
    const int count = sm->bc[2];
    hi = lo;
    // bc is next written after the next pass's barriers, which every
    // thread reaches only once it has read it here
    if (count == need || hi == 0) break;
  }
  *hi_out = hi;
  return prefix;
}

// Sorts n (a power of two) triples (key, tie, idx) in shared memory into
// selection order by (key, tie), idx riding along.  Every thread of the
// block calls it; it synchronises before and after.
__device__ void g2v_bitonic3(int* key, int* tie, int* idx, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int lo = 2 * stride * (t / stride) + (t % stride);
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const int kl = key[lo], tl = tie[lo], kh = key[hi], th = tie[hi];
        if (up ? g2v_before(kh, th, kl, tl) : g2v_before(kl, tl, kh, th)) {
          const int il = idx[lo];
          key[lo] = kh; tie[lo] = th; idx[lo] = idx[hi];
          key[hi] = kl; tie[hi] = tl; idx[hi] = il;
        }
      }
    }
  }
  __syncthreads();
}

// The first min(keep, n) of n entries (key[i], tie(i); ties distinct) in
// selection order: out(r, i) once for each, r its rank where `sorted`,
// else a distinct slot < min(keep, n).  Up to G2V_RANK_MAX entries are
// ranked by counting the entries before each (a few neighbouring lanes an
// entry; one pass, no barrier); more take the radix threshold, then
// (sorted) a sort of the survivors in sk/st/sg (room for
// next_pow2(min(keep, n)) each).  Every thread calls it.
template <class Tie, class Out>
__device__ void g2v_dense_topk(const int* key, const Tie& tie, int n, int keep, bool sorted,
                               G2vSelect* sm, int* sk, int* st, int* sg, const Out& out) {
  const int ns = min(keep, n);
  if (ns == 0) return;
  if (!sorted && n <= keep) {  // every entry, in any order
    for (int i = threadIdx.x; i < n; i += blockDim.x) out(i, i);
    return;
  }
  if (n <= G2V_RANK_MAX) {  // `parts` neighbouring lanes an entry, each counting a span
    int parts = 1;
    while (parts < 8 && 2 * parts * n <= static_cast<int>(blockDim.x)) parts <<= 1;
    const int span = (n + parts - 1) / parts;
    const int i = threadIdx.x / parts, q = threadIdx.x % parts;
    int rank = 0;
    if (i < n) {
      const int k = key[i], t = tie(i);
      const int j1 = min(n, (q + 1) * span);
#pragma unroll 4
      for (int j = q * span; j < j1; ++j) rank += g2v_before(key[j], tie(j), k, t);
    }
    for (int o = parts >> 1; o > 0; o >>= 1) rank += __shfl_xor_sync(0xffffffffu, rank, o);
    if (i < n && q == 0 && rank < keep) out(rank, i);
    return;
  }
  const auto each = [&](auto f) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) f(key[i], tie(i));
  };
  unsigned long long prefix = 0;
  int hi = 0;
  if (n > keep) prefix = g2v_list_threshold(each, keep, sm, &hi);
  if (threadIdx.x == 0) sm->fill = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = key[i], t = tie(i);
    const int s = g2v_take_slot(&sm->fill, n <= keep || (g2v_ord(k, t) >> hi) >= prefix);
    if (s >= 0 && s < ns) {  // exactly ns pass; the guard keeps a fault in bounds
      if (sorted) {
        sk[s] = k;
        st[s] = t;
        sg[s] = i;
      } else {
        out(s, i);
      }
    }
  }
  if (!sorted) return;
  __syncthreads();
  if (ns <= G2V_RANK_MAX) {  // each survivor's rank by counting those before it
    for (int a = threadIdx.x; a < ns; a += blockDim.x) {
      const int k = sk[a], t = st[a];
      int rank = 0;
      for (int j = 0; j < ns; ++j) rank += g2v_before(sk[j], st[j], k, t);
      out(rank, sg[a]);
    }
    return;
  }
  int P = 1;
  while (P < ns) P <<= 1;
  for (int a = ns + threadIdx.x; a < P; a += blockDim.x) {
    sk[a] = INT_MIN;
    st[a] = INT_MAX;
    sg[a] = -1;
  }
  g2v_bitonic3(sk, st, sg, P);
  for (int a = threadIdx.x; a < ns; a += blockDim.x) out(a, sg[a]);
}

// Block-wide, order-keeping compaction of the candidate positions [p0,
// p1): cand(p) is the row of position p, or -1 where it is padding or
// masked.  The rows go to ids[0 ..) in position order; returns their
// count (to every thread).  Each thread takes G2V_COMPACT neighbouring
// positions a round, all loaded before any is used.  scan: 32 ints.
#define G2V_COMPACT 4
template <class Cand>
__device__ int g2v_compact(const Cand& cand, int p0, int p1, int* ids, int* scan) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  int base = 0;
  for (int r0 = p0; r0 < p1; r0 += G2V_COMPACT * blockDim.x) {
    int id[G2V_COMPACT];
    int c = 0;
#pragma unroll
    for (int e = 0; e < G2V_COMPACT; ++e) {
      const int p = r0 + G2V_COMPACT * threadIdx.x + e;
      id[e] = p < p1 ? cand(p) : -1;
    }
#pragma unroll
    for (int e = 0; e < G2V_COMPACT; ++e) c += id[e] >= 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) scan[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nw; ++w) {
      const int x = scan[w];
      before += w < warp ? x : 0;
      total += x;
    }
    int o = base + before + incl - c;
#pragma unroll
    for (int e = 0; e < G2V_COMPACT; ++e) {
      if (id[e] >= 0) ids[o++] = id[e];
    }
    base += total;
    __syncthreads();  // scan is rewritten next round
  }
  return base;
}

// Scores rows ids[0 .. m) with groups of `lanes` lanes (a power of two <=
// 32) a row: lane l of a group loads words l, l + lanes, ... of each of
// its G2V_LIST_ROWS rows (G2V_LIST_WORDS a row a pass, every load of a
// pass issued before any sum), adds them into its own sum (sc.add, in
// word order) and the group sums its lanes by a shuffle tree; emit(i,
// key, id) then takes row i's key (sc.score) on the group's first lane.
// The query's words a lane needs are read once (once a pass for rows of
// several passes) and serve every row.  The loop runs the same number of
// times on every lane of a warp.
//
// Scorer interface:
//   typename Word, QWord, Acc;  int words;   words a row
//   __device__ const Word* row(int id) const;
//   __device__ QWord qword(int w) const;     the query's word w
//   __device__ float aux(int id) const;      a per-row factor (the int8 scale)
//   __device__ void add(const Word& x, const QWord& q, Acc& acc) const;
//   __device__ float score(Acc acc, float aux) const;
template <class Sc, class Emit>
__device__ void g2v_score_rows(const Sc& sc, const int* ids, int m, int lanes, const Emit& emit) {
  using Word = typename Sc::Word;
  using QWord = typename Sc::QWord;
  using Acc = typename Sc::Acc;
  constexpr int U = G2V_LIST_ROWS, J = G2V_LIST_WORDS;
  const int lane = threadIdx.x & 31, gl = lane & (lanes - 1);
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int per_warp = (32 / lanes) * U;  // rows a warp scores at once
  const bool one_pass = sc.words <= lanes * J;
  QWord qv[J];
  const auto load_query = [&](int c0) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int w = c0 + gl + lanes * j;
      if (w < sc.words) qv[j] = sc.qword(w);
    }
  };
  if (one_pass) load_query(0);
  for (int w0 = warp * per_warp; w0 < m; w0 += nw * per_warp) {
    const int i0 = w0 + (lane / lanes) * U;
    int id[U];
    float aux[U];
    Acc acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      id[u] = i0 + u < m ? ids[i0 + u] : -1;
      aux[u] = 1.0f;
      acc[u] = Acc(0);
    }
#if G2V_LIST_LOADS
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (id[u] >= 0) aux[u] = sc.aux(id[u]);
    }
    for (int c0 = 0; c0 < sc.words; c0 += lanes * J) {
      Word x[U][J];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const Word* row = id[u] >= 0 ? sc.row(id[u]) : nullptr;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int w = c0 + gl + lanes * j;
          if (row && w < sc.words) x[u][j] = __ldg(row + w);
        }
      }
      if (!one_pass) load_query(c0);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int w = c0 + gl + lanes * j;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (id[u] >= 0 && w < sc.words) sc.add(x[u][j], qv[j], acc[u]);
        }
      }
    }
#else
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = Acc(gl == 0 && id[u] >= 0 ? id[u] & 1023 : 0);
#endif
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int o = lanes >> 1; o > 0; o >>= 1) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
    }
    if (gl == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (id[u] >= 0) emit(i0 + u, g2v_key(sc.score(acc[u], aux[u])), id[u]);
      }
    }
  }
}

__device__ __forceinline__ void g2v_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned g2v_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of `p` (this block's shared memory) in block `rank` of the
// cluster, as a generic pointer.
template <class T>
__device__ __forceinline__ T* g2v_cluster_map(T* p, unsigned rank) {
  const uint64_t local = reinterpret_cast<uint64_t>(p);
  uint64_t remote;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(remote) : "l"(local), "r"(rank));
  return reinterpret_cast<T*>(remote);
}

// Dynamic shared memory of a list block: its S (key, id) pairs, the
// leader's ncand candidates (key, tie, id) as sent and packed, 3 x P ints
// for a sort, the query (qbytes) and the candidate source's own
// (src_bytes), each 16-byte aligned.
static inline size_t g2v_list_smem(int S, int ncand, int P, int qbytes, int src_bytes) {
  const auto up = [](size_t b) { return (b + 15) & ~static_cast<size_t>(15); };
  return up(8 * static_cast<size_t>(S)) + up(24 * static_cast<size_t>(ncand)) +
         up(12 * static_cast<size_t>(P)) + up(qbytes) + up(src_bytes);
}

// Candidate source interface (per kernel, by value):
//   int src_bytes() const;                       shared memory it stages
//   __device__ void stage(int b, int* smem) const;  block-wide, before the
//       barrier that precedes the compaction (K9: the query's probe row)
//   __device__ int id(int b, const int* smem, int p) const;  row or -1
// Query scorer (per kernel, by value): the Scorer interface above, and
//   size_t query_bytes() const;
//   __device__ void stage(int b, unsigned char* qmem) const;  block-wide
//   __device__ Sc bound(const unsigned char* qmem) const;  the scorer on
//       the staged query
//
// Grid (kRuns false): B * nseg blocks in clusters of nseg, cluster b
// being query b.  One block (nseg 1) selects and sorts its rows' top-keep
// itself; in a cluster each block sends its own top-min(keep, S) (a
// select without a sort) to the leader's candidates, and the leader packs
// them and selects and sorts the top-keep of those.
// (kRuns true) nseg x B blocks, no cluster: each block writes its
// top-min(slot, rows) (key, tie) to its run, the rows to aux[b * n + tie]
// and fill entries (-inf, n + seg * slot + j), which map to row 0.
template <class Src, class Q, bool kRuns>
__global__ void __launch_bounds__(G2V_LIST_THREADS)
g2v_list_select(Src src, Q qs, int n, int S, int nseg, int keep, int P, int lanes, int qbytes,
                int slot, int stride, int* __restrict__ rk, int* __restrict__ ri,
                int* __restrict__ aux, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char g2v_smem[];
  __shared__ G2vSelect sm;
  __shared__ int scan[32];
  __shared__ int counts[G2V_LIST_CLUSTER_MAX];
  const int b = kRuns ? blockIdx.y : blockIdx.x / nseg;
  const int seg = kRuns ? blockIdx.x : static_cast<int>(g2v_cluster_rank());
  const bool cluster = !kRuns && nseg > 1;
  const int K1 = min(keep, S);  // what a cluster's block sends its leader
  const int ncand = cluster ? nseg * K1 : 0;
  const auto up = [](size_t x) { return (x + 15) & ~static_cast<size_t>(15); };
  int* keys = reinterpret_cast<int*>(g2v_smem);  // S
  int* ids = keys + S;                            // S
  int* ck = reinterpret_cast<int*>(g2v_smem + up(8 * static_cast<size_t>(S)));
  int* ct = ck + ncand;
  int* cid = ct + ncand;
  int* dk = cid + ncand;  // the leader's candidates packed
  int* dt = dk + ncand;
  int* did = dt + ncand;
  int* sk = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(ck) +
                                   up(24 * static_cast<size_t>(ncand)));
  int* st = sk + P;
  int* sg = st + P;
  unsigned char* qmem = reinterpret_cast<unsigned char*>(sk) + up(12 * static_cast<size_t>(P));
  int* smem_src = reinterpret_cast<int*>(qmem + up(qbytes));
  G2V_MARK(0, 0);
  if (cluster) {  // every block of the cluster running before any writes remotely
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  src.stage(b, smem_src);
  qs.stage(b, qmem);
  __syncthreads();
  G2V_MARK(0, 1);
  const int p0 = seg * S, p1 = min(n, p0 + S);
  const int m = G2V_LIST_COMPACT
      ? g2v_compact([&](int p) { return src.id(b, smem_src, p); }, p0, p1, ids, scan)
      : 0;
  G2V_MARK(0, 2);
  g2v_score_rows(qs.bound(qmem), ids, m, lanes, [&](int i, int key, int) { keys[i] = key; });
  __syncthreads();
  G2V_MARK(0, 3);
  const auto position = [&](int i) { return p0 + i; };
  if (kRuns) {
    int* ok = rk + static_cast<size_t>(b) * stride + static_cast<size_t>(seg) * slot;
    int* oi = ri + static_cast<size_t>(b) * stride + static_cast<size_t>(seg) * slot;
    int* ax = aux + static_cast<size_t>(b) * n;
    if (G2V_LIST_SELECT) {
      g2v_dense_topk(keys, position, m, slot, false, &sm, sk, st, sg, [&](int s, int i) {
        ok[s] = keys[i];
        oi[s] = p0 + i;
        ax[p0 + i] = ids[i];
      });
    }
    for (int j = min(slot, m) + threadIdx.x; j < slot; j += blockDim.x) {
      ok[j] = g2v_key(-INFINITY);
      oi[j] = n + seg * slot + j;
    }
    return;
  }
  float* os = out_s + static_cast<size_t>(b) * keep;
  int* oi = out_i + static_cast<size_t>(b) * keep;
  int M = m;
  if (!cluster) {
    if (G2V_LIST_SELECT) {
      g2v_dense_topk(keys, position, m, keep, true, &sm, sk, st, sg, [&](int r, int i) {
        os[r] = g2v_unkey(keys[i]);
        oi[r] = ids[i];
      });
    }
  } else {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    int* lk = g2v_cluster_map(ck, 0);
    int* lt = g2v_cluster_map(ct, 0);
    int* li = g2v_cluster_map(cid, 0);
    const int base = seg * K1, ns = min(K1, m);
    if (G2V_LIST_SELECT) {
      g2v_dense_topk(keys, position, m, K1, false, &sm, sk, st, sg, [&](int s, int i) {
        lk[base + s] = keys[i];
        lt[base + s] = p0 + i;
        li[base + s] = ids[i];
      });
    }
    if (threadIdx.x == 0) g2v_cluster_map(counts, 0)[seg] = ns;
    G2V_MARK(0, 4);
    g2v_cluster_sync();  // the leader holds every block's candidates
    G2V_MARK(0, 5);
    if (seg != 0) return;
    M = 0;
    for (int s = 0; s < nseg; ++s) {
      const int c = counts[s];
      for (int j = threadIdx.x; j < c; j += blockDim.x) {
        dk[M + j] = ck[s * K1 + j];
        dt[M + j] = ct[s * K1 + j];
        did[M + j] = cid[s * K1 + j];
      }
      M += c;
    }
    __syncthreads();
    if (G2V_LIST_SELECT) {
      g2v_dense_topk(dk, [&](int i) { return dt[i]; }, M, keep, true, &sm, sk, st, sg,
                     [&](int r, int i) {
                       os[r] = g2v_unkey(dk[i]);
                       oi[r] = did[i];
                     });
    }
  }
  for (int i = M + threadIdx.x; i < keep; i += blockDim.x) {
    os[i] = -INFINITY;
    oi[i] = 0;
  }
  G2V_MARK(0, 6);
}

// Maps a chunked selection's tie to its row: aux[b * n + tie] for a kept
// candidate, 0 for a fill entry.
struct G2vAuxMap {
  const int* aux;
  int n;
  __device__ int operator()(int b, int t) const {
    return t < n ? aux[static_cast<size_t>(b) * n + t] : 0;
  }
};

// Launches the list select: route 0 (clusters of nseg blocks, one a query,
// one launch) or 1 (chunks of S positions, then g2v_final: two launches).
// Scratch for route 1: rk/ri/kb/ib the runs (B * stride each), aux B * n.
// Returns a cudaError_t.
template <class Src, class Q>
static int g2v_launch_list(const Src& src, const Q& qs, int route, int n, int B, int S, int nseg,
                           int keep, int lanes, int slot, int stride, int* rk, int* ri, int* kb,
                           int* ib, int* aux, float* out_s, int* out_i, cudaStream_t stream) {
  const bool runs = route == 1;
  const int ncand = !runs && nseg > 1 ? nseg * min(keep, S) : 0;
  const int P = runs ? 0 : g2v_next_pow2(min(keep, nseg > 1 ? ncand : S));
  const size_t smem = g2v_list_smem(S, ncand, P, qs.query_bytes(), src.src_bytes());
  const auto kernel = runs ? g2v_list_select<Src, Q, true> : g2v_list_select<Src, Q, false>;
  int err = g2v_smem_attr(kernel, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(G2V_LIST_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (runs) {
    cfg.gridDim = dim3(nseg, B);
  } else {
    cfg.gridDim = dim3(nseg * B);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nseg;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, src, qs, n, S, nseg, keep, P, lanes,
                                            static_cast<int>(qs.query_bytes()), slot, stride, rk,
                                            ri, aux, out_s, out_i));
  if (err) return err;
  err = static_cast<int>(cudaGetLastError());
  if (err || !runs) return err;
  return g2v_launch_final(G2vAuxMap{aux, n}, B, nseg, slot, stride, keep, rk, ri, kb, ib, out_s,
                          out_i, stream);
}
