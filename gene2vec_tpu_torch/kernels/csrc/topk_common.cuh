// Top-k selection shared by the serving kernels K7, K8, K9, K9r.
//
// A call scores `n` rows for each of B queries and returns each query's
// top-`keep` (score, id) in selection order, in two launches:
//
// 1. Scan.  Rows are cut into chunks of CH rows (CH <= 512); one block
//    scores one chunk for a group of queries and keeps the scores as
//    int32 keys in shared memory.  K7 and K8 stage the chunk's rows into
//    shared memory asynchronously (double-buffered tiles of TR rows: one
//    TMA bulk copy a tile on an mbarrier for int8 rows, 16-byte cp.async
//    copies into padded rows for float32 and bf16) and score every query
//    of the batch against each staged tile (g2v_staged_select), so a row
//    leaves device memory once per call.  Rows too wide for even a
//    32-row tile beside one query are staged as d-slices of a tile: each
//    slice's partial score (float32, or the exact int32 sum) waits in the
//    key's place until the last slice adds its own and makes the key.
//    K9 and K9r score with one thread per row or candidate
//    (g2v_rows_select).  Then the block selects each query's top-min(keep,
//    CH) of the chunk by a radix select (no sort), all queries side by
//    side, and writes them, in no particular order, to the query's run in
//    device memory.
// 2. Final (g2v_final).  One block per query selects the top-keep of its
//    runs by the same radix select, sorts only those survivors
//    (next_pow2(keep) pairs, bitonic, in shared memory), and writes the
//    scores and the ids the caller wants.  Lists longer than G2V_SORT_MAX
//    sort in G2V_SORT_MAX runs that the block then merges pairwise in
//    device memory along the merge path, still in the same launch.
// The (B, n) score matrix never reaches device memory.
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
// most queries a thread-per-row block scores (registers: one sum each)
#define G2V_QB_MAX 8
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
  // a short list (K9's probe and scan, K9r) takes four warps, whose passes
  // (histograms cleared and summed, barriers) cost less; longer ones take
  // all 32, whose many loads in flight a pass needs more
  const int N = nchunks * slot;
  const int threads = N <= 256 ? 128 : G2V_FINAL_THREADS;
  g2v_final<Map><<<B, threads, smem, stream>>>(ka, ia, kb, ib, N, stride, keep, map,
                                               out_scores, out_ids);
  return static_cast<int>(cudaGetLastError());
}

// -- launch 1, thread per row (K9, K9r) -------------------------------------

// Scorer interface (one struct per kernel, passed by value):
//   size_t query_bytes() const;             shared memory for one query
//   __device__ void load_queries(unsigned char* qmem, int q0, int nq) const;
//       the whole block stages queries q0..q0+nq-1 into qmem
//   __device__ void score_row(const unsigned char* qmem, int q0, int nq,
//                             int r, int* keys, int stride) const;
//       one thread scores row r for the nq queries and writes the key of
//       query j to keys[j * stride]
// Grid: chunks x query groups of QB.  Shared memory: QB x CH keys, the
// warps' histograms, then the queries.
template <class S>
__global__ void __launch_bounds__(G2V_TOPK_THREADS)
g2v_rows_select(S sc, int n, int B, int QB, int CH, int keep, int slot, int stride,
                int* __restrict__ okey, int* __restrict__ oidx) {
  extern __shared__ __align__(16) unsigned char g2v_smem[];
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, B - q0);
  const int r0 = chunk * CH;
  const int nrows = min(CH, n - r0);
  int* keys = reinterpret_cast<int*>(g2v_smem);  // QB x CH
  char* sel = reinterpret_cast<char*>(keys + static_cast<size_t>(QB) * CH);
  unsigned char* qmem = reinterpret_cast<unsigned char*>(sel + G2V_SELECT_BYTES);
  sc.load_queries(qmem, q0, nq);
  __syncthreads();
  for (int t = threadIdx.x; t < nrows; t += blockDim.x) {
    sc.score_row(qmem, q0, nq, r0 + t, keys + t, CH);
  }
  __syncthreads();
  g2v_block_select_runs(keys, CH, nq, nrows, r0, keep, slot,
                        static_cast<size_t>(q0) * stride + static_cast<size_t>(chunk) * slot,
                        stride, sel, okey, oidx);
}

// Runs the thread-per-row scan, then the final launch.  Returns a
// cudaError_t.
template <class S, class Map>
static int g2v_run_topk(const S& sc, const Map& map, int n, int B, int QB, int CH, int keep,
                        int slot, int stride, int* ka, int* ia, int* kb, int* ib,
                        float* out_scores, int* out_ids, cudaStream_t stream) {
  const int nchunks = (n + CH - 1) / CH;
  const size_t smem = static_cast<size_t>(QB) * CH * 4 + G2V_SELECT_BYTES +
                      static_cast<size_t>(QB) * sc.query_bytes();
  int err = g2v_smem_attr(g2v_rows_select<S>, smem);
  if (err) return err;
  g2v_rows_select<S><<<dim3(nchunks, (B + QB - 1) / QB), G2V_TOPK_THREADS, smem, stream>>>(
      sc, n, B, QB, CH, keep, slot, stride, ka, ia);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return g2v_launch_final(map, B, nchunks, slot, stride, keep, ka, ia, kb, ib, out_scores,
                          out_ids, stream);
}

// -- query staging and the thread-per-row scorers' dots ----------------------

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

// A candidate's float32 dot (K9r, K9 on a bf16 table) is summed as four
// interleaved partial sums (the columns d = 4i + k into part k), then (p0
// + p1) + (p2 + p3): a single running sum over a wide row gathers a
// rounding each step at the size of the whole score (at D = 1,024 over
// 1e-6 on a unit score, against the plain version's batched products),
// four quarter-size partials far less.  K9's centroid scores keep the
// single running sum, a matrix product's own order (kParts false), so
// that its probe ranks the lists as the plain version's product does.
__device__ __forceinline__ float g2v_sum_parts(const float (&p)[4]) {
  return (p[0] + p[1]) + (p[2] + p[3]);
}

// One thread's float32 dots of row `x` (D floats) with nq staged queries
// (qs, D floats each, 16-byte aligned when D % 4 == 0): float4 loads of
// the row when its width and address allow, else scalar loads; the
// queries are read from shared memory as broadcasts.  kParts: four
// partial sums, else one running sum.
template <bool kParts>
__device__ __forceinline__ void g2v_thread_dots_f32(const float* __restrict__ x,
                                                    const float* qs, int nq, int D,
                                                    float* acc) {
  constexpr int P = kParts ? 4 : 1;
  float part[G2V_QB_MAX][4];
#pragma unroll
  for (int j = 0; j < G2V_QB_MAX; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
  if ((D & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 5
    for (int c = 0; c < (D >> 2); ++c) {
      const float4 v = __ldg(x4 + c);
#pragma unroll
      for (int j = 0; j < G2V_QB_MAX; ++j) {
        if (j < nq) {
          const float4 q = reinterpret_cast<const float4*>(qs + j * D)[c];
          part[j][0] = fmaf(q.x, v.x, part[j][0]);
          part[j][1 % P] = fmaf(q.y, v.y, part[j][1 % P]);
          part[j][2 % P] = fmaf(q.z, v.z, part[j][2 % P]);
          part[j][3 % P] = fmaf(q.w, v.w, part[j][3 % P]);
        }
      }
    }
  } else {
    for (int d = 0; d < D; ++d) {
      const float v = __ldg(x + d);
#pragma unroll
      for (int j = 0; j < G2V_QB_MAX; ++j) {
        if (j < nq) part[j][d % P] = fmaf(qs[j * D + d], v, part[j][d % P]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < G2V_QB_MAX; ++j) acc[j] = kParts ? g2v_sum_parts(part[j]) : part[j][0];
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

// One thread's int8 dots of row `x` (D int8) with nq staged int8 queries,
// exact in int32: dp4a over 4-byte words when the width and address
// allow, else byte by byte.
__device__ __forceinline__ void g2v_thread_dots_int8(const signed char* __restrict__ x,
                                                     const signed char* qq, int nq, int D,
                                                     int* acc) {
#pragma unroll
  for (int j = 0; j < G2V_QB_MAX; ++j) acc[j] = 0;
  if ((D & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0) {
    const int* x4 = reinterpret_cast<const int*>(x);
#pragma unroll 5
    for (int c = 0; c < (D >> 2); ++c) {
      const int v = __ldg(x4 + c);
#pragma unroll
      for (int j = 0; j < G2V_QB_MAX; ++j) {
        if (j < nq) acc[j] = __dp4a(v, reinterpret_cast<const int*>(qq + j * D)[c], acc[j]);
      }
    }
  } else {
    for (int d = 0; d < D; ++d) {
      const int v = x[d];
#pragma unroll
      for (int j = 0; j < G2V_QB_MAX; ++j) {
        if (j < nq) acc[j] += v * static_cast<int>(qq[j * D + d]);
      }
    }
  }
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

// One thread's dots of bf16 row `x` (D values) with nq staged bf16-rounded
// queries (qs, D floats each).  Each bf16 x bf16 product is exact in
// float32 and the sum accumulates in float32 — the reference's
// dot_general(..., preferred_element_type=f32) — in four interleaved
// partial sums (g2v_sum_parts).  16-byte loads of 8 values when the width
// and address allow, else one value at a time.
__device__ __forceinline__ void g2v_thread_dots_bf16(const __nv_bfloat16* __restrict__ x,
                                                     const float* qs, int nq, int D,
                                                     float* acc) {
  float part[G2V_QB_MAX][4];
#pragma unroll
  for (int j = 0; j < G2V_QB_MAX; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
  if ((D & 7) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const uint4* x8 = reinterpret_cast<const uint4*>(x);
    for (int c = 0; c < (D >> 3); ++c) {
      const uint4 raw = __ldg(x8 + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
#pragma unroll
      for (int j = 0; j < G2V_QB_MAX; ++j) {
        if (j < nq) {
          const float* q = qs + j * D + 8 * c;
#pragma unroll
          for (int i = 0; i < 8; ++i) part[j][i & 3] = fmaf(q[i], v[i], part[j][i & 3]);
        }
      }
    }
  } else {
    for (int d = 0; d < D; ++d) {
      const float v = __bfloat162float(x[d]);
#pragma unroll
      for (int j = 0; j < G2V_QB_MAX; ++j) {
        if (j < nq) part[j][d & 3] = fmaf(qs[j * D + d], v, part[j][d & 3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < G2V_QB_MAX; ++j) acc[j] = g2v_sum_parts(part[j]);
}

static inline size_t g2v_int8_query_bytes(int D) {
  return static_cast<size_t>(D) + 8;
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
