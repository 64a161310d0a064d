// K15 — UMAP's fuzzy graph: each row's k nearest neighbours and their
// smooth-kNN weights, then the fuzzy union into a dense P.
//
// Replaces: gene2vec_tpu/viz/umap.py:114-157 (_smooth_knn_weights and
// _fuzzy_graph), an XLA program, not a Pallas kernel: lax.top_k over each
// row of −d² with the diagonal masked, knn_d = sqrt(max(d², 0)), ρ = the
// nearest, shifted = max(knn_d − ρ, 0), a 64-step bisection of σ in
// [1e-6, 1e3] against log2(k), w = exp(−shifted/σ), then W scattered into
// a dense (N, N) matrix and P = W + Wᵀ − W∘Wᵀ.
//
// Bound on the H100: bytes.  d² is read once (N² floats) and P written
// once (N² floats): 4.78 GB at N = 24,447, 1.43 ms at 3.35 TB/s; the
// selection's comparisons and the bisection's N·k·65 exponentials and
// N·65 reciprocals of σ (25.4M MUFU operations at k = 15) are far below
// that.
//
// Launch 1 (knn_weights): one block of 256 threads a row.  The row's
// off-diagonal entries become 32-bit keys ordered as the floats are (-0
// taken as +0), and a radix select (11, 11 and 10 bits, one pass over
// the row each, histograms in shared memory) finds the k-th smallest key
// T and how many entries equal to T the k smallest take.  A fourth pass
// keeps every key below T and the first of the keys equal to T in index
// order (a block-wide count a chunk of 256 columns), which is lax.top_k's
// choice among ties; the k kept (key, index) pairs are ranked by (key,
// index) in shared memory, so they come out in top_k's order.  Then the
// bisection of :114-139 step for step, a block-wide sum a step (every
// thread adds the warps' sums in one order, so all take the same
// decision), and idx and w are written in that order.  Arithmetic is the
// reference's, each operation rounded (__fadd_rn, __fdiv_rn, ...); the
// row sum runs in another order than XLA's and expf is not the CPU's
// exponential, so σ lands within the sum's rounding of the reference's
// root.  The row is read from global memory at every pass (four reads of
// 98 KB a row at N = 24,447): a simple first design.
//
// Launch 2 (fuzzy_union): one thread an edge i→j of the (N, k) lists into
// a P the wrapper has zeroed: w_ji is found by scanning j's list (0 when
// i is not in it), and P_ij = P_ji = (w_ij + w_ji) − w_ij·w_ji, the
// reference's order (:157).  Both edges of a mutual pair compute the same
// bits (+ and · commute), so their racing stores agree; an entry with no
// edge either way stays 0.  P's rows are `pitch` floats apart.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 2048;  // the widest radix digit: 11 bits
// the kept pairs' keys, columns, columns by rank and distances (16 bytes
// each) in dynamic shared memory, beside the ~8.3 KB of static buffers
constexpr int kMaxK = 14000;

// The float's bits as a key that orders as the floats do (+0 and -0 one key).
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(__fadd_rn(x, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
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
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = scratch[w];
    before += w < warp ? s : 0;
    total += s;
  }
  __syncthreads();
  return v + before;
}

// Σ of each thread's x, in every thread: warp sums, then the warps' sums
// in one order; `red` alternates between two slots (one barrier a call).
__device__ __forceinline__ float block_sum(float x, float (*red)[kWarps], int parity) {
  x = g2v_warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[parity][threadIdx.x >> 5] = x;
  __syncthreads();
  float s = red[parity][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, red[parity][w]);
  return s;
}

__global__ void __launch_bounds__(kThreads)
knn_weights_kernel(const float* __restrict__ d2, int n, int k, float target, int iters,
                   int* __restrict__ idx_out, float* __restrict__ w_out) {
  extern __shared__ uint32_t dyn[];
  uint32_t* sel_key = dyn;                                 // the k kept keys, in any order
  int* sel_idx = reinterpret_cast<int*>(dyn + k);          // their columns
  int* sorted_idx = reinterpret_cast<int*>(dyn + 2 * k);   // the columns by rank
  float* shifted = reinterpret_cast<float*>(dyn + 3 * k);  // by rank: knn_d, then shifted
  __shared__ int hist[kMaxBins];
  __shared__ int scan[kWarps];
  __shared__ int chosen[3];  // the digit, the rank left, the count kept so far
  __shared__ float red[2][kWarps];
  const int i = blockIdx.x;
  const float* row = d2 + static_cast<size_t>(i) * n;

  // radix select: the k-th smallest key T, and kk = how many keys equal
  // to T the k smallest hold
  uint32_t prefix = 0;
  int kk = k;
  const int shifts[3] = {21, 10, 0}, widths[3] = {11, 11, 10};
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = shifts[pass], bins = 1 << widths[pass];
    for (int b = threadIdx.x; b < bins; b += kThreads) hist[b] = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      if (j == i) continue;
      const uint32_t key = order_key(__ldg(row + j));
      if (pass == 0 || (key >> (shift + widths[pass])) == prefix) {
        atomicAdd(&hist[(key >> shift) & (bins - 1)], 1);
      }
    }
    __syncthreads();
    // the digit whose bin holds the kk-th key: each thread scans its run
    // of bins/kThreads consecutive bins
    const int per = bins / kThreads, first = threadIdx.x * per;
    int mine = 0;
    for (int b = 0; b < per; ++b) mine += hist[first + b];
    int total;
    const int incl = block_scan(mine, scan, total);
    int before = incl - mine;
    if (before < kk && kk <= incl) {
      for (int b = first;; ++b) {
        if (kk <= before + hist[b]) {
          chosen[0] = b;
          chosen[1] = kk - before;
          break;
        }
        before += hist[b];
      }
    }
    __syncthreads();
    prefix = (prefix << widths[pass]) | static_cast<uint32_t>(chosen[0]);
    kk = chosen[1];
    __syncthreads();
  }
  const uint32_t T = prefix;

  // keep every key below T and the first kk keys equal to T, by column
  if (threadIdx.x == 0) chosen[2] = 0;
  int eq_before = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int j = base + threadIdx.x;
    uint32_t key = 0xffffffffu;
    bool less = false, eq = false;
    if (j < n && j != i) {
      key = order_key(__ldg(row + j));
      less = key < T;
      eq = key == T;
    }
    int eq_total;
    const int eq_rank = block_scan(eq ? 1 : 0, scan, eq_total) - 1;  // among this chunk's
    if (less || (eq && eq_before + eq_rank < kk)) {
      const int slot = atomicAdd(&chosen[2], 1);
      sel_key[slot] = key;
      sel_idx[slot] = j;
    }
    eq_before += eq_total;
  }
  __syncthreads();

  // rank each kept pair by (key, column): its place in top_k's order
  for (int e = threadIdx.x; e < k; e += kThreads) {
    const uint32_t ke = sel_key[e];
    const int je = sel_idx[e];
    int rank = 0;
    for (int f = 0; f < k; ++f) {
      const uint32_t kf = sel_key[f];
      rank += (kf < ke || (kf == ke && sel_idx[f] < je)) ? 1 : 0;
    }
    sorted_idx[rank] = je;
    shifted[rank] = sqrtf(fmaxf(key_float(ke), 0.0f));  // knn_d, for now
  }
  __syncthreads();

  // the bisection (:114-139), in every thread: rho = knn_d[0]
  const float rho = shifted[0];
  __syncthreads();
  for (int t = threadIdx.x; t < k; t += kThreads) {
    shifted[t] = fmaxf(__fsub_rn(shifted[t], rho), 0.0f);
  }
  __syncthreads();
  float lo = 1e-6f, hi = 1e3f;
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    float part = 0.0f;
    for (int t = threadIdx.x; t < k; t += kThreads) {
      part = __fadd_rn(part, expf(__fdiv_rn(-shifted[t], mid)));
    }
    const float val = block_sum(part, red, it & 1);
    const bool gt = val > target;
    hi = gt ? mid : hi;
    lo = gt ? lo : mid;
  }
  const float sigma = __fmul_rn(0.5f, __fadd_rn(lo, hi));
  const size_t out = static_cast<size_t>(i) * k;
  for (int t = threadIdx.x; t < k; t += kThreads) {
    idx_out[out + t] = sorted_idx[t];
    w_out[out + t] = expf(__fdiv_rn(-shifted[t], sigma));
  }
}

__global__ void __launch_bounds__(kThreads)
fuzzy_union_kernel(const int* __restrict__ idx, const float* __restrict__ w, int n, int k,
                   float* __restrict__ p, int pitch) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<long long>(n) * k) return;
  const int i = static_cast<int>(e / k);
  const int j = __ldg(idx + e);
  const float wij = __ldg(w + e);
  const int* list = idx + static_cast<size_t>(j) * k;
  float wji = 0.0f;
  for (int t = 0; t < k; ++t) {
    if (__ldg(list + t) == i) {
      wji = __ldg(w + static_cast<size_t>(j) * k + t);
      break;
    }
  }
  const float v = __fsub_rn(__fadd_rn(wij, wji), __fmul_rn(wij, wji));
  p[static_cast<size_t>(i) * pitch + j] = v;
  p[static_cast<size_t>(j) * pitch + i] = v;
}

}  // namespace

// d2: (n, n) float32, contiguous; idx, w: (n, k) int32 / float32.
// target = log2(k) in float32; iters = the bisection's steps (64).
G2V_EXPORT int k15_knn_weights(const float* d2, int n, int k, float target, int iters, int* idx,
                               float* w, cudaStream_t stream) {
  if (n == 0) return 0;
  if (k < 1 || k > n - 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(k) * 16;
  cudaError_t err = cudaFuncSetAttribute(
      knn_weights_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_weights_kernel<<<n, kThreads, bytes, stream>>>(d2, n, k, target, iters, idx, w);
  return static_cast<int>(cudaGetLastError());
}

// idx, w: (n, k) as k15_knn_weights writes them; p: (n, n) float32, rows
// `pitch` floats apart, zeroed by the caller.
G2V_EXPORT int k15_fuzzy_union(const int* idx, const float* w, int n, int k, float* p,
                               int pitch, cudaStream_t stream) {
  if (n == 0) return 0;
  if (pitch < n) return static_cast<int>(cudaErrorInvalidValue);
  const long long edges = static_cast<long long>(n) * k;
  fuzzy_union_kernel<<<static_cast<unsigned>((edges + kThreads - 1) / kThreads), kThreads, 0,
                       stream>>>(idx, w, n, k, p, pitch);
  return static_cast<int>(cudaGetLastError());
}
