// K15 — UMAP's fuzzy graph: each row's k nearest neighbours and their
// smooth-kNN weights, then the fuzzy union into a sparse P (CSR).
//
// Replaces: gene2vec_tpu/viz/umap.py:114-157 (_smooth_knn_weights and
// _fuzzy_graph), an XLA program, not a Pallas kernel: lax.top_k over each
// row of −d² with the diagonal masked, knn_d = sqrt(max(d², 0)), ρ = the
// nearest, shifted = max(knn_d − ρ, 0), a 64-step bisection of σ in
// [1e-6, 1e3] against log2(k), w = exp(−shifted/σ), then W scattered into
// a dense (N, N) matrix and P = W + Wᵀ − W∘Wᵀ.  Here P stays sparse:
// compressed rows, columns ascending, no diagonal, no stored zero.
//
// Bound on the H100: bytes.  d² is read once (N² floats, 2.39 GB at N =
// 24,447: 0.714 ms at 3.35 TB/s) and the CSR written once (N + 1 offsets,
// 8 bytes an entry: a few MB); the selection's comparisons and the
// bisection's N·(k + 1)·65 MUFU operations (25.4M at k = 15) are far
// below that.
//
// Launch 1 (knn_weights).  A persistent grid, one block of 1024 threads
// an SM, each block taking rows blockIdx.x, + gridDim.x, ...  Each row is
// read from device memory once: thread 0 bulk-copies it (cp.async.bulk on
// an mbarrier) into one of `nstages` row buffers in shared memory, so with
// two buffers the next row loads while this one is selected.  Rows must
// start 16-byte aligned: the caller pads them to a multiple of 32 floats.
// Where two rows do not fit beside the block's other buffers, one does;
// where none does, the row is read from global memory at every pass (the
// wrapper picks the route by shape).  A row's off-diagonal entries become
// 32-bit keys ordered as the floats are (−0 as +0), and the k smallest by
// (key, column) — lax.top_k's order, ties to the lower column — are found
// by one of two routes:
//  * candidates (k <= 32): every warp's smallest key over its columns;
//    the k-th smallest of those 32 minima, T0, bounds the row's k-th
//    smallest key from above (k distinct entries lie at or below it).  A
//    second pass over the staged row keeps every key <= T0 (a warp's
//    takers by ballot, one shared atomic a warp), and each candidate's
//    rank by (key, column) among them places it.  Typical rows keep a few
//    dozen; a row with more than 1024 (ties, a constant row) takes
//  * the radix select: the k-th smallest key T and how many keys equal to
//    T the k take, by three histogram passes (11, 11 and 10 bits; a warp's
//    keys that share a bin add once, __match_any_sync, so a row whose keys
//    crowd a few bins does not serialise on the bins' atomics), then one
//    selection pass in which each warp owns a contiguous column range:
//    ballots and __popc count its keys below and equal to T, one scan of
//    the 32 warps' counts gives each its output offset and its share of
//    the tied keys, and the warp writes its kept columns in column order.
//    The kept pairs are ranked as above.
// The ranked columns go to idx and their distances to w.  Once the block
// has selected all its rows, each warp runs the bisection of :114-139 for
// a row of the block at a time, the k terms spread over the lanes and
// summed by a butterfly (every lane holds the same sum, so all take the
// same decision), and overwrites the distances with the weights.  Each
// operation is rounded as the reference's (__fadd_rn, __fdiv_rn, ...); the
// row sum runs in another order than XLA's and expf is not the CPU's
// exponential, so σ lands within the sum's rounding of the reference's
// root.
//
// The union, four launches from the (N, k) lists (a thread an edge unless
// said otherwise):
//  2 count: w_ji is found by scanning j's list (0 when i is not in it),
//    the entry's value v = (w_ij + w_ji) − w_ij·w_ji (the reference's
//    order, :157; both directions of a mutual pair compute the same bits,
//    as + and · commute) and whether the pair is mutual are kept, and a
//    v ≠ 0 adds one to row i's count and, where j's list lacks i, one to
//    row j's (a mutual pair's reverse is counted by j's own edge);
//  3 scan: one block turns the counts into the row offsets and clears
//    them for the fill (the host then reads the entry count);
//  4 fill: each stored entry takes a slot of its row by an atomic on the
//    row's cursor (and the reverse entry one of row j's), in any order;
//  5 sort: a warp a row ranks its columns (distinct within a row) and
//    writes them, with their values, in ascending order: the CSR is the
//    same bits from run to run.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 2048;    // the widest radix digit: 11 bits
constexpr int kMaxCand = 1024;    // umap_graph.MAX_CANDIDATES
constexpr int kFastK = kWarps;    // the candidate route: one minimum a warp
constexpr int kMaxK = 14000;      // umap_graph.MAX_K
constexpr int kSmemBytes = 232448;
constexpr int kStaticBytes = 9 * 1024;  // umap_graph.STATIC_BYTES
constexpr long long kSpinLimit = 20000000000LL;  // clock64 cycles, ~10 s

// The float's bits as a key that orders as the floats do (+0 and -0 one key).
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(__fadd_rn(x, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Waits for a row buffer's copy; traps after ~10 s instead of hanging.
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinLimit) __trap();
  }
}

// Thread 0: row i of d² (its first n floats rounded up to 16 bytes) into dst.
__device__ __forceinline__ void issue_row(const float* d2, int pitch, int i, uint32_t bytes,
                                          float* dst, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(d2 + static_cast<size_t>(i) * pitch), "r"(bytes), "r"(b)
      : "memory");
}

// Inclusive prefix sum of v over the block; `scratch` holds kWarps ints.
// Every thread also gets the block's total.  Two barriers.
__device__ __forceinline__ int block_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int s = scratch[w];
    before += w < warp ? s : 0;
    total += s;
  }
  __syncthreads();
  return v + before;
}

struct Scratch {
  int hist[kMaxBins];
  int scan[kWarps];
  int counts[kWarps][2];  // a warp's keys below and equal to T
  uint32_t wmin[kWarps];
  int misc[3];            // the candidate count; the digit and the rank left
};

// Ranks the c kept (key, column) pairs by (key, column) and writes those
// of rank < k: the column to idx, the distance sqrt(max(d², 0)) to w.
__device__ __forceinline__ void rank_and_write(const uint32_t* key, const int* col, int c,
                                               int k, int* idx_row, float* w_row) {
  for (int e = threadIdx.x; e < c; e += kThreads) {
    const uint32_t ke = key[e];
    const int je = col[e];
    int rank = 0;
    for (int f = 0; f < c; ++f) {
      const uint32_t kf = key[f];
      rank += (kf < ke || (kf == ke && col[f] < je)) ? 1 : 0;
    }
    if (rank < k) {
      idx_row[rank] = je;
      w_row[rank] = sqrtf(fmaxf(key_float(ke), 0.0f));
    }
  }
}

// The radix select of row i's k smallest (key, column) pairs into
// cand_key / cand_col, in column order (k of them).
__device__ void radix_select(const float* row, int i, int n, int k, Scratch& s,
                             uint32_t* cand_key, int* cand_col) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t prefix = 0;
  int kk = k;
  const int shifts[3] = {21, 10, 0}, widths[3] = {11, 11, 10};
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = shifts[pass], bins = 1 << widths[pass];
    for (int b = t; b < bins; b += kThreads) s.hist[b] = 0;
    __syncthreads();
    for (int j0 = warp * 32; j0 < n; j0 += kThreads) {
      const int j = j0 + lane;
      const bool in = j < n && j != i;
      const uint32_t key = in ? order_key(row[j]) : 0u;
      const bool part = in && (pass == 0 || (key >> (shift + widths[pass])) == prefix);
      const unsigned act = __ballot_sync(0xffffffffu, part);
      if (part) {
        const int bin = static_cast<int>((key >> shift) & static_cast<uint32_t>(bins - 1));
        const unsigned peers = __match_any_sync(act, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&s.hist[bin], __popc(peers));
      }
    }
    __syncthreads();
    // the digit whose bin holds the kk-th key: each thread sums its run of
    // bins / kThreads consecutive bins
    const int per = bins / kThreads, first = t * per;
    int mine = 0;
    for (int b = 0; b < per; ++b) mine += s.hist[first + b];
    int total;
    const int incl = block_scan(mine, s.scan, total);
    int before = incl - mine;
    if (before < kk && kk <= incl) {
      for (int b = first;; ++b) {
        if (kk <= before + s.hist[b]) {
          s.misc[1] = b;
          s.misc[2] = kk - before;
          break;
        }
        before += s.hist[b];
      }
    }
    __syncthreads();
    prefix = (prefix << widths[pass]) | static_cast<uint32_t>(s.misc[1]);
    kk = s.misc[2];
    __syncthreads();
  }
  const uint32_t T = prefix;

  // each warp's contiguous column range: its keys below T and equal to T
  const int span = (n + kWarps - 1) / kWarps;
  const int lo = min(n, warp * span), hi = min(n, lo + span);
  int less = 0, eq = 0;
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    const uint32_t key = (j < hi && j != i) ? order_key(row[j]) : 0xffffffffu;
    less += __popc(__ballot_sync(0xffffffffu, key < T));
    eq += __popc(__ballot_sync(0xffffffffu, j < hi && j != i && key == T));
  }
  if (lane == 0) {
    s.counts[warp][0] = less;
    s.counts[warp][1] = eq;
  }
  __syncthreads();
  int less_before = 0, eq_before = 0;
  for (int w = 0; w < warp; ++w) {
    less_before += s.counts[w][0];
    eq_before += s.counts[w][1];
  }
  // the kept pairs of earlier warps: their keys below T and their share
  // of the first kk keys equal to T
  int out = less_before + min(eq_before, kk);
  int eq_seen = eq_before;
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < hi && j != i;
    const uint32_t key = in ? order_key(row[j]) : 0xffffffffu;
    const unsigned lt = __ballot_sync(0xffffffffu, in && key < T);
    const unsigned et = __ballot_sync(0xffffffffu, in && key == T);
    const bool take_eq = ((et >> lane) & 1u) && eq_seen + __popc(et & lanes_below()) < kk;
    const unsigned kept = lt | __ballot_sync(0xffffffffu, take_eq);
    if ((kept >> lane) & 1u) {
      const int pos = out + __popc(kept & lanes_below());
      cand_key[pos] = key;
      cand_col[pos] = j;
    }
    out += __popc(kept);
    eq_seen += __popc(et);
  }
  __syncthreads();
}

// Row i's k nearest neighbours into idx_row (by rank) and their distances
// into w_row.  Ends with a barrier: the row buffer is free afterwards.
__device__ void select_row(const float* row, int i, int n, int k, Scratch& s, uint32_t* cand_key,
                           int* cand_col, int* idx_row, float* w_row) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (k <= kFastK) {
    uint32_t mn = 0xffffffffu;
    for (int j = t; j < n; j += kThreads) {
      if (j != i) mn = min(mn, order_key(row[j]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    if (lane == 0) s.wmin[warp] = mn;
    if (t == 0) s.misc[0] = 0;
    __syncthreads();
    // T0: the k-th smallest warp minimum (ties by warp), in every warp
    const uint32_t v = s.wmin[lane];
    int rank = 0;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t u = s.wmin[w];
      rank += (u < v || (u == v && w < lane)) ? 1 : 0;
    }
    const unsigned at = __ballot_sync(0xffffffffu, rank == k - 1);
    const uint32_t T0 = __shfl_sync(0xffffffffu, v, __ffs(at) - 1);
    for (int j0 = warp * 32; j0 < n; j0 += kThreads) {
      const int j = j0 + lane;
      const bool in = j < n && j != i;
      const uint32_t key = in ? order_key(row[j]) : 0xffffffffu;
      const bool take = in && key <= T0;
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (m == 0) continue;
      int base = 0;
      if (lane == __ffs(m) - 1) base = atomicAdd(&s.misc[0], __popc(m));
      base = __shfl_sync(0xffffffffu, base, __ffs(m) - 1);
      const int pos = base + __popc(m & lanes_below());
      if (take && pos < kMaxCand) {
        cand_key[pos] = key;
        cand_col[pos] = j;
      }
    }
    __syncthreads();
    const int c = s.misc[0];
    if (c <= kMaxCand) {
      rank_and_write(cand_key, cand_col, c, k, idx_row, w_row);
      __syncthreads();
      return;
    }
  }
  radix_select(row, i, n, k, s, cand_key, cand_col);
  rank_and_write(cand_key, cand_col, k, k, idx_row, w_row);
  __syncthreads();
}

// The bisection of :114-139 for one row by one warp: w_row holds the
// sorted distances and receives the weights.
__device__ void bisect(float* w_row, int k, float target, int iters) {
  const int lane = threadIdx.x & 31;
  const float rho = w_row[0];
  const bool one = k <= 32;  // a term a lane, kept in a register
  const float s0 = lane < k ? fmaxf(__fsub_rn(w_row[lane], rho), 0.0f) : 0.0f;
  float lo = 1e-6f, hi = 1e3f;
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    float part = 0.0f;
    if (one) {
      if (lane < k) part = expf(__fdiv_rn(-s0, mid));
    } else {
      for (int t = lane; t < k; t += 32) {
        const float sh = fmaxf(__fsub_rn(w_row[t], rho), 0.0f);
        part = __fadd_rn(part, expf(__fdiv_rn(-sh, mid)));
      }
    }
    const float val = g2v_warp_sum(part);  // the same bits in every lane
    const bool gt = val > target;
    hi = gt ? mid : hi;
    lo = gt ? lo : mid;
  }
  const float sigma = __fmul_rn(0.5f, __fadd_rn(lo, hi));
  // every lane read rho (w_row[0]) before the sums' shuffles; each lane
  // overwrites only its own terms
  if (one) {
    if (lane < k) w_row[lane] = expf(__fdiv_rn(-s0, sigma));
  } else {
    for (int t = lane; t < k; t += 32) {
      const float sh = fmaxf(__fsub_rn(w_row[t], rho), 0.0f);
      w_row[t] = expf(__fdiv_rn(-sh, sigma));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
knn_weights_kernel(const float* __restrict__ d2, int pitch, int n, int k, float target, int iters,
                   int nstages, int* __restrict__ idx_out, float* __restrict__ w_out) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ Scratch s;
  __shared__ __align__(8) uint64_t bars[2];
  float* ring = reinterpret_cast<float*>(dyn);
  const int cap = max(kMaxCand, k);
  uint32_t* cand_key = reinterpret_cast<uint32_t*>(dyn + static_cast<size_t>(nstages) * pitch * 4);
  int* cand_col = reinterpret_cast<int*>(cand_key + cap);
  const int t = threadIdx.x, warp = t >> 5;
  const int rows = (n - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const uint32_t bytes = static_cast<uint32_t>((n + 3) / 4) * 16;
  if (nstages > 0) {
    if (t == 0) {
      for (int b = 0; b < nstages; ++b) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&bars[b])),
                     "r"(1)
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int m = 0; m < nstages && m < rows; ++m) {
        issue_row(d2, pitch, blockIdx.x + m * gridDim.x, bytes, ring + m * pitch, &bars[m]);
      }
    }
    __syncthreads();
  }
  for (int m = 0; m < rows; ++m) {
    const int i = blockIdx.x + m * gridDim.x;
    const float* row = d2 + static_cast<size_t>(i) * pitch;
    if (nstages > 0) {
      const int b = m % nstages;
      wait_parity(&bars[b], static_cast<uint32_t>((m / nstages) & 1));
      row = ring + b * pitch;
    }
    select_row(row, i, n, k, s, cand_key, cand_col, idx_out + static_cast<size_t>(i) * k,
               w_out + static_cast<size_t>(i) * k);
    // select_row ended with a barrier: the buffer is free for row m + nstages
    if (nstages > 0 && t == 0 && m + nstages < rows) {
      const int b = m % nstages;
      issue_row(d2, pitch, blockIdx.x + (m + nstages) * gridDim.x, bytes, ring + b * pitch,
                &bars[b]);
    }
  }
  // the distances this block wrote are visible to its threads past the
  // barrier select_row ended with
  for (int m = warp; m < rows; m += kWarps) {
    const int i = blockIdx.x + m * gridDim.x;
    bisect(w_out + static_cast<size_t>(i) * k, k, target, iters);
  }
}

__global__ void __launch_bounds__(256)
union_count_kernel(const int* __restrict__ idx, const float* __restrict__ w, int n, int k,
                   float* __restrict__ edge_val, int8_t* __restrict__ mutual,
                   int* __restrict__ counts) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(n) * k) return;
  const int i = static_cast<int>(e / k);
  const int j = __ldg(idx + e);
  const float wij = __ldg(w + e);
  const int* list = idx + static_cast<size_t>(j) * k;
  float wji = 0.0f;
  int mut = 0;
  for (int t = 0; t < k; ++t) {
    if (__ldg(list + t) == i) {
      wji = __ldg(w + static_cast<size_t>(j) * k + t);
      mut = 1;
      break;
    }
  }
  const float v = __fsub_rn(__fadd_rn(wij, wji), __fmul_rn(wij, wji));
  edge_val[e] = v;
  mutual[e] = static_cast<int8_t>(mut);
  if (v != 0.0f) {  // NaN is stored, as the plain union keeps it
    atomicAdd(counts + i, 1);
    if (!mut) atomicAdd(counts + j, 1);
  }
}

__global__ void __launch_bounds__(kThreads)
union_scan_kernel(int* __restrict__ counts, int n, int* __restrict__ rowptr) {
  __shared__ int scratch[kWarps];
  const int t = threadIdx.x;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, t * per), hi = min(n, lo + per);
  int mine = 0;
  for (int r = lo; r < hi; ++r) mine += counts[r];
  int total;
  int run = block_scan(mine, scratch, total) - mine;
  for (int r = lo; r < hi; ++r) {
    rowptr[r] = run;
    run += counts[r];
    counts[r] = 0;  // the fill's cursors
  }
  if (t == 0) rowptr[n] = total;
}

__global__ void __launch_bounds__(256)
union_fill_kernel(const int* __restrict__ idx, const float* __restrict__ edge_val,
                  const int8_t* __restrict__ mutual, int n, int k, const int* __restrict__ rowptr,
                  int* __restrict__ cursor, int* __restrict__ tmp_col,
                  float* __restrict__ tmp_val) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(n) * k) return;
  const float v = edge_val[e];
  if (v == 0.0f) return;
  const int i = static_cast<int>(e / k);
  const int j = __ldg(idx + e);
  int slot = __ldg(rowptr + i) + atomicAdd(cursor + i, 1);
  tmp_col[slot] = j;
  tmp_val[slot] = v;
  if (!mutual[e]) {
    slot = __ldg(rowptr + j) + atomicAdd(cursor + j, 1);
    tmp_col[slot] = i;
    tmp_val[slot] = v;
  }
}

__global__ void __launch_bounds__(256)
union_sort_kernel(const int* __restrict__ rowptr, const int* __restrict__ tmp_col,
                  const float* __restrict__ tmp_val, int n, int* __restrict__ col,
                  float* __restrict__ val) {
  const int r = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n) return;
  const int b = __ldg(rowptr + r), e = __ldg(rowptr + r + 1);
  for (int a = b + lane; a < e; a += 32) {
    const int c = __ldg(tmp_col + a);
    int rank = 0;
    for (int f = b; f < e; ++f) rank += __ldg(tmp_col + f) < c ? 1 : 0;
    col[b + rank] = c;
    val[b + rank] = __ldg(tmp_val + a);
  }
}

}  // namespace

// d2: (n, n) float32, rows `pitch` floats apart (a multiple of 4, 16-byte
// aligned); idx, w: (n, k) int32 / float32.  target = log2(k) in float32;
// iters = the bisection's steps (64); nstages: rows staged in shared
// memory at once (2, 1, or 0: read from global memory); sms: the grid.
G2V_EXPORT int k15_knn_weights(const float* d2, int pitch, int n, int k, float target, int iters,
                               int nstages, int sms, int* idx, float* w, cudaStream_t stream) {
  if (n == 0) return 0;
  if (k < 1 || k > n - 1 || k > kMaxK || pitch < n || pitch % 4 || !g2v_aligned16(d2) ||
      nstages < 0 || nstages > 2 || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t cap = static_cast<size_t>(k > kMaxCand ? k : kMaxCand);
  const size_t bytes = static_cast<size_t>(nstages) * pitch * 4 + cap * 8;
  if (bytes + kStaticBytes > static_cast<size_t>(kSmemBytes) ||
      (nstages > 0 && static_cast<size_t>((n + 3) / 4) * 16 >= (1u << 20))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      knn_weights_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n < sms ? n : sms);
  knn_weights_kernel<<<grid, kThreads, bytes, stream>>>(d2, pitch, n, k, target, iters, nstages,
                                                        idx, w);
  return static_cast<int>(cudaGetLastError());
}

// idx, w: (n, k) as k15_knn_weights writes them; edge_val (n, k) float32
// and mutual (n, k) int8 receive each edge's value and flag; counts: n
// int32, zeroed by the caller.
G2V_EXPORT int k15_union_count(const int* idx, const float* w, int n, int k, float* edge_val,
                               int8_t* mutual, int* counts, cudaStream_t stream) {
  if (n == 0) return 0;
  const long long edges = static_cast<long long>(n) * k;
  union_count_kernel<<<static_cast<unsigned>((edges + 255) / 256), 256, 0, stream>>>(
      idx, w, n, k, edge_val, mutual, counts);
  return static_cast<int>(cudaGetLastError());
}

// counts: n int32 → rowptr: n + 1 int32 offsets; counts left 0.
G2V_EXPORT int k15_union_scan(int* counts, int n, int* rowptr, cudaStream_t stream) {
  union_scan_kernel<<<1, kThreads, 0, stream>>>(counts, n, rowptr);
  return static_cast<int>(cudaGetLastError());
}

// The stored entries into tmp_col / tmp_val (rowptr[n] of each), each row
// in any order; cursor: n int32, 0.
G2V_EXPORT int k15_union_fill(const int* idx, const float* edge_val, const int8_t* mutual, int n,
                              int k, const int* rowptr, int* cursor, int* tmp_col, float* tmp_val,
                              cudaStream_t stream) {
  if (n == 0) return 0;
  const long long edges = static_cast<long long>(n) * k;
  union_fill_kernel<<<static_cast<unsigned>((edges + 255) / 256), 256, 0, stream>>>(
      idx, edge_val, mutual, n, k, rowptr, cursor, tmp_col, tmp_val);
  return static_cast<int>(cudaGetLastError());
}

// Each row of tmp_col / tmp_val in ascending column order into col / val.
G2V_EXPORT int k15_union_sort(const int* rowptr, const int* tmp_col, const float* tmp_val, int n,
                              int* col, float* val, cudaStream_t stream) {
  if (n == 0) return 0;
  const long long threads = static_cast<long long>(n) * 32;
  union_sort_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      rowptr, tmp_col, tmp_val, n, col, val);
  return static_cast<int>(cudaGetLastError());
}
