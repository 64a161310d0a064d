// K10c — t-SNE calibration: perplexity-matched conditionals, then the
// symmetrized P.
//
// Replaces: gene2vec_tpu/viz/tsne.py:52-85 (_calibrate_p), an XLA program,
// not a Pallas kernel: a 50-step fori_loop over the (N, N) matrix
// exp(−d²·β) that bisects each row's β until the conditional's entropy
// hits log(perplexity), then P_cond = w / Σw and
// P = max((P_cond + P_condᵀ) / (2N), 1e-12).
//
// Bound on the H100: operations, at the special-function unit.  Each pass
// over a row takes one exponential an element, and expf is range
// reduction on the FMA pipe plus one MUFU.EX2, which issues 16 lanes a
// clock an SM (4.18e12 a second at 1.98 GHz); its FMA-pipe part and the
// two sums are ~10 float32 instructions an element at 128 lanes a clock.
// At N = 24,447 the reference's 51 passes are 3.05e10 exponentials, 7.3 ms
// at the MUFU rate; with the early exit below the passes are those the
// rows take (~30, chip_smoke.py prints the histogram).  The bytes (d² read
// once, P written once, 4.78 GB, 1.43 ms) are the smaller bound.
//
// Design, launch 1 (calibrate rows): one block of 512 threads a row, two
// routes by N.
//  - Staged (up to ~57,800 columns, the main path): the row staged once in
//    dynamic shared memory (opted in with cudaFuncSetAttribute).
//  - Global (longer rows): the row read from global memory at every pass.
// Each step is one pass with two sums, Σw and Σd²w, then every thread
// takes the same bisection update of :68-82 (too_high = h > target;
// lo/hi; doubling while hi is infinite).  Where the row is staged its
// diagonal is FLT_MAX: exp(−FLT_MAX·β) is 0 for every β the bisection
// reaches (2⁻⁵⁰ to 2⁵⁰), and FLT_MAX·0 = 0, so both sums and P_cond are
// bitwise what a select in the loop gives, without the select; the global
// route reads the caller's d² and keeps the select.  A step's block sums
// end in one barrier: each warp's pair goes to a shared slot of the step's
// parity, and every thread adds the warps' pairs in one order.  The sums
// are deterministic, so a step from the same (β, lo, hi) always makes the
// same decision: once a step leaves (β, lo, hi) unchanged (hi − lo one
// ulp, (lo + hi)/2 rounding to an end the next decision keeps), every
// later step does too, and the block stops there with the 50-step result
// bit for bit.  Both routes give a thread the columns j ≡ t (mod 512) in
// order and sum them and the warps as the first design did, so P_cond is
// that design's bit for bit.  `steps`, where given, receives each
// row's steps.  A last pass writes P_cond = w / Σw into rows `pitch`
// floats apart, and zeros into the columns past N.  The wrapper passes a
// row range (R rows of an (R, N) slab, diagonal column row0 + r), so the
// long-row route can be checked without an N × N plain version.
// Arithmetic follows the reference's order with each operation rounded
// (__fmul_rn / __fdiv_rn / __fadd_rn); IEEE division; the sums run in
// another order than XLA's (thread strides, then a fixed tree), so β
// lands within float32 rounding of the reference's root.
//
// Launch 2 (symmetrize): one block a pair of 64 × 64 tiles (i, j) and
// (j, i), j ≥ i (the grid holds those pairs only), both staged in shared
// memory by 16-byte loads, so P overwrites P_cond in place: max((a + b) /
// (2N), 1e-12), IEEE division; a + b commutes exactly, so P is symmetric
// bit for bit.  The padding columns stay 0.  Bound: bytes, P_cond read
// and P written once (4.78 GB at N = 24,447, 1.43 ms).
#include <float.h>
#include <math.h>

#include "common.cuh"

// Build switches (kernel_split.py compiles the kernel with each changed):
// the exponential (0: its argument in its place), the diagonal select in
// the loop (1: on both routes, the diagonal staged as it is), the block
// sums (0: each thread bisects on its own sums) and the early exit (0:
// every row takes all `iters` steps).
#define K10C_EXP 1
#define K10C_SELECT 0
#define K10C_BLOCK_SUMS 1
#define K10C_EARLY_EXIT 1

namespace {

constexpr int kThreads = 512;           // both routes: a block a row
constexpr int kWarps = kThreads / 32;
constexpr int kSymTile = 64;            // symmetrize: a pair of 64 × 64 tiles a block
constexpr int kSymThreads = 256;

__device__ __forceinline__ float weight(float d, float beta) {
#if K10C_EXP
  return expf(__fmul_rn(-d, beta));
#else
  return __fmul_rn(-d, beta);
#endif
}

// This thread's (Σw, Σd·w) → the block's, in every thread; one barrier.
// The warps' pairs are added in the tree a warp shuffle sum over 16 lanes
// takes (pairs 8, 4, 2, 1 apart), so every thread gets the sums a
// shuffle of warp 0 would give.
__device__ __forceinline__ void block_sums(float a, float b, float2 (*red)[kWarps], int parity,
                                           float& sa, float& sb) {
#if K10C_BLOCK_SUMS
  a = g2v_warp_sum(a);
  b = g2v_warp_sum(b);
  if ((threadIdx.x & 31) == 0) red[parity][threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  static_assert(kWarps == 16, "the tree below adds 16 warps' sums");
  float2 v[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v[w] = red[parity][w];
  const auto fold = [&](int w, int o) {
    v[w].x = __fadd_rn(v[w].x, v[w + o].x);
    v[w].y = __fadd_rn(v[w].y, v[w + o].y);
  };
#pragma unroll
  for (int w = 0; w < 8; ++w) fold(w, 8);
#pragma unroll
  for (int w = 0; w < 4; ++w) fold(w, 4);
  fold(0, 2);
  fold(1, 2);
  fold(0, 1);
  sa = v[0].x;
  sb = v[0].y;
#else
  sa = a;
  sb = b;
#endif
}

// One row's bisection (:68-82) with the exact early exit; sums(β, a, b)
// gives this thread's Σw and Σd·w.  Returns the final β, with its Σw
// (clamped at 1e-12) and the steps taken.
template <class Sums>
__device__ __forceinline__ float bisect(const Sums& sums, float target, int iters,
                                        float2 (*red)[kWarps], float& sw, int& steps) {
  float beta = 1.0f, lo = 0.0f, hi = INFINITY, sdw, a, b;
  int it = 0;
  while (it < iters) {
    sums(beta, a, b);
    block_sums(a, b, red, it & 1, sw, sdw);
    ++it;
    sw = fmaxf(sw, 1e-12f);
    // H = log Σw + β · Σd²w / Σw
    const float h = __fadd_rn(logf(sw), __fdiv_rn(__fmul_rn(beta, sdw), sw));
    const bool too_high = h > target;
    const float nlo = too_high ? beta : lo;
    const float nhi = too_high ? hi : beta;
    const float nbeta = isinf(nhi) ? __fmul_rn(beta, 2.0f) : __fdiv_rn(__fadd_rn(nlo, nhi), 2.0f);
#if K10C_EARLY_EXIT
    if (nbeta == beta && nlo == lo && nhi == hi) break;  // every later step repeats this one
#endif
    beta = nbeta;
    lo = nlo;
    hi = nhi;
  }
  steps = it;
  sums(beta, a, b);
  block_sums(a, b, red, it & 1, sw, sdw);
  sw = fmaxf(sw, 1e-12f);
  return beta;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
calibrate_rows_kernel(const float* __restrict__ d2, int n, long long row0, float target,
                      int iters, float* __restrict__ pcond, int pitch, int* __restrict__ steps) {
  extern __shared__ float staged[];
  __shared__ float2 red[2][kWarps];
  const size_t r = blockIdx.x;
  const float* row = d2 + r * n;
  const long long diag = row0 + static_cast<long long>(r);
  constexpr bool kSelect = !kStaged || K10C_SELECT;
  if (kStaged) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      staged[j] = (kSelect || j != diag) ? __ldg(row + j) : FLT_MAX;
    }
    __syncthreads();
  }
  const float* src = kStaged ? staged : row;
  const auto w_of = [&](int j, float d, float beta) {
    return (kSelect && j == diag) ? 0.0f : weight(d, beta);
  };
  const auto sums = [&](float beta, float& a, float& b) {
    a = 0.0f;
    b = 0.0f;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float d = kStaged ? src[j] : __ldg(src + j);
      const float w = w_of(j, d, beta);
      a = __fadd_rn(a, w);
      b = __fadd_rn(b, __fmul_rn(d, w));
    }
  };
  float sw;
  int taken;
  const float beta = bisect(sums, target, iters, red, sw, taken);
  if (steps != nullptr && threadIdx.x == 0) steps[r] = taken;
  float* out = pcond + r * pitch;
  for (int j = threadIdx.x; j < pitch; j += kThreads) {
    out[j] = j < n ? __fdiv_rn(w_of(j, kStaged ? src[j] : __ldg(src + j), beta), sw) : 0.0f;
  }
}

__device__ __forceinline__ float sym_of(float a, float b, float two_n) {
  return fmaxf(__fdiv_rn(__fadd_rn(a, b), two_n), 1e-12f);
}

// Block k takes the tile pair (bi, bj), bj ≥ bi, k = bj·(bj + 1)/2 + bi:
// both 64 × 64 tiles staged (16-byte loads where the four columns lie
// below n), then each written as max((a + bᵀ) / 2N, 1e-12).
__global__ void __launch_bounds__(kSymThreads)
symmetrize_kernel(float* __restrict__ p, int n, int pitch, float two_n) {
  __shared__ float a[kSymTile][kSymTile + 1], b[kSymTile][kSymTile + 1];
  const long long k = blockIdx.x;
  int bj = static_cast<int>((sqrt(8.0 * static_cast<double>(k) + 1.0) - 1.0) / 2.0);
  while (static_cast<long long>(bj) * (bj + 1) / 2 > k) --bj;
  while (static_cast<long long>(bj + 1) * (bj + 2) / 2 <= k) ++bj;
  const int bi = static_cast<int>(k - static_cast<long long>(bj) * (bj + 1) / 2);
  const int tx = (threadIdx.x % (kSymTile / 4)) * 4, ty = threadIdx.x / (kSymTile / 4);
  constexpr int kRowsAPass = kSymThreads / (kSymTile / 4);
  const int ri = bi * kSymTile, rj = bj * kSymTile;
  const size_t ps = pitch;
  const auto load = [&](float (*t)[kSymTile + 1], int i, int j) {  // t[y][tx..] = p[i][j..]
#pragma unroll
    for (int y = ty; y < kSymTile; y += kRowsAPass) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (i + y < n) {
        const float* src = p + (i + y) * ps + j + tx;
        if (j + tx + 3 < n) {
          const float4 q = *reinterpret_cast<const float4*>(src);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
          for (int c = 0; c < 4 && j + tx + c < n; ++c) v[c] = src[c];
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) t[y][tx + c] = v[c];
    }
  };
  // p[i + y][j + tx ..] = sym(s[y][tx ..], tt[tx ..][y])
  const auto store = [&](float (*s)[kSymTile + 1], float (*tt)[kSymTile + 1], int i, int j) {
#pragma unroll
    for (int y = ty; y < kSymTile; y += kRowsAPass) {
      if (i + y >= n) continue;
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = sym_of(s[y][tx + c], tt[tx + c][y], two_n);
      float* dst = p + (i + y) * ps + j + tx;
      if (j + tx + 3 < n) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int c = 0; c < 4 && j + tx + c < n; ++c) dst[c] = v[c];
      }
    }
  };
  load(a, ri, rj);  // tile (bi, bj)
  load(b, rj, ri);  // tile (bj, bi)
  __syncthreads();
  store(a, b, ri, rj);
  if (bi != bj) store(b, a, rj, ri);
}

}  // namespace

// d2: (rows, n) float32, rows row0 .. row0 + rows − 1 of the squared
// distances; pcond: (rows, pitch) (pitch ≥ n; columns n .. pitch − 1 get
// 0); steps: (rows,) int32 or null.  staged: the row in shared memory (n ·
// 4 bytes, opted in here), else read from global memory at every step.
G2V_EXPORT int k10c_calibrate_rows(const float* d2, int rows, int n, long long row0,
                                   float target, int iters, int staged, float* pcond, int pitch,
                                   int* steps, cudaStream_t stream) {
  if (rows == 0) return 0;
  if (pitch < n) return static_cast<int>(cudaErrorInvalidValue);
  if (staged) {
    const size_t bytes = static_cast<size_t>(n) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        calibrate_rows_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    calibrate_rows_kernel<true><<<rows, kThreads, bytes, stream>>>(d2, n, row0, target, iters,
                                                                   pcond, pitch, steps);
  } else {
    calibrate_rows_kernel<false><<<rows, kThreads, 0, stream>>>(d2, n, row0, target, iters,
                                                                pcond, pitch, steps);
  }
  return static_cast<int>(cudaGetLastError());
}

// p: (n, n) float32 conditionals with rows `pitch` floats apart, overwritten
// with the symmetrized P.
G2V_EXPORT int k10c_symmetrize(float* p, int n, int pitch, cudaStream_t stream) {
  if (n == 0) return 0;
  if (pitch < n) return static_cast<int>(cudaErrorInvalidValue);
  if (pitch % 4 || !g2v_aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kSymTile - 1) / kSymTile;
  symmetrize_kernel<<<static_cast<unsigned>(tiles * (tiles + 1) / 2), kSymThreads, 0, stream>>>(
      p, n, pitch, 2.0f * static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}
