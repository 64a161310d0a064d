// K10c — t-SNE calibration: perplexity-matched conditionals, then the
// symmetrized P.
//
// Replaces: gene2vec_tpu/viz/tsne.py:52-85 (_calibrate_p), an XLA program,
// not a Pallas kernel: a 50-step fori_loop over the (N, N) matrix
// exp(−d²·β) that bisects each row's β until the conditional's entropy
// hits log(perplexity), then P_cond = w / Σw and
// P = max((P_cond + P_condᵀ) / (2N), 1e-12).
//
// Bound on the H100: operations.  51 passes over N² elements of about 5
// operations each (the product d²·β, the exponential counted as one, two
// sums, a product): 1.5e11 at N = 24,447, ~2.3 ms at 67 TFLOP/s; the bytes
// (d² read once, P written once, 4.78 GB, 1.43 ms) are the smaller bound.
//
// Design, launch 1 (calibrate_rows): one block a row.  The row of d² is
// staged once in shared memory (dynamic, opted in with
// cudaFuncSetAttribute: 98 KB at N = 24,447, up to ~57,800 columns); a
// longer row is read from global memory at each step (the wrapper picks
// the route by N).  Each of the 50 steps is one pass over the row with two
// block sums — Σw and Σd²w, w_ii = 0, Σw clamped at 1e-12 — then every
// thread takes the same bisection update of :68-82 (too_high = h > target;
// lo/hi; doubling while hi is infinite).  A last pass writes
// P_cond = w / Σw.  The wrapper passes a row range (R rows of an (R, N)
// slab, diagonal column row0 + r), so the long-row route can be checked
// without an N × N plain version.  Arithmetic follows the reference's order
// with each operation rounded (__fmul_rn / __fdiv_rn / __fadd_rn: no
// contraction), IEEE division; the sums run in another order (thread
// strides, then a fixed tree), so β lands within float32 rounding of the
// reference's root.
//
// Launch 2 (symmetrize): one block a pair of 32 × 32 tiles (i, j) and
// (j, i), both staged in shared memory, so P overwrites P_cond in place:
// max((a + b) / (2N), 1e-12), IEEE division; a + b commutes exactly, so P
// is symmetric bit for bit.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr int kTileRows = 8;   // symmetrize: 32 × 8 threads a block

// The sums of one bisection step, Σw and Σ d²·w, over the row.
template <bool kStaged>
__device__ __forceinline__ void row_sums(const float* __restrict__ src, int n, long long diag,
                                         float beta, float* red, float& sw, float& sdw) {
  float a = 0.0f, b = 0.0f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float d = kStaged ? src[j] : __ldg(src + j);
    const float w = (j == diag) ? 0.0f : expf(__fmul_rn(-d, beta));
    a = __fadd_rn(a, w);
    b = __fadd_rn(b, __fmul_rn(d, w));
  }
  a = g2v_warp_sum(a);
  b = g2v_warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? red[lane] : 0.0f;
    b = lane < kWarps ? red[kWarps + lane] : 0.0f;
    a = g2v_warp_sum(a);
    b = g2v_warp_sum(b);
    if (lane == 0) {
      red[2 * kWarps] = a;
      red[2 * kWarps + 1] = b;
    }
  }
  __syncthreads();
  sw = red[2 * kWarps];
  sdw = red[2 * kWarps + 1];
  __syncthreads();  // red is reused by the next step
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
calibrate_rows_kernel(const float* __restrict__ d2, int n, long long row0, float target,
                      int iters, float* __restrict__ pcond) {
  extern __shared__ float staged[];
  __shared__ float red[2 * kWarps + 2];
  const size_t r = blockIdx.x;
  const float* row = d2 + r * n;
  const long long diag = row0 + static_cast<long long>(r);
  if (kStaged) {
    for (int j = threadIdx.x; j < n; j += kThreads) staged[j] = __ldg(row + j);
    __syncthreads();
  }
  const float* src = kStaged ? staged : row;
  float beta = 1.0f, lo = 0.0f, hi = INFINITY, sw, sdw;
  for (int it = 0; it < iters; ++it) {
    row_sums<kStaged>(src, n, diag, beta, red, sw, sdw);
    sw = fmaxf(sw, 1e-12f);
    // H = log Σw + β · Σd²w / Σw
    const float h = __fadd_rn(logf(sw), __fdiv_rn(__fmul_rn(beta, sdw), sw));
    const bool too_high = h > target;
    lo = too_high ? beta : lo;
    hi = too_high ? hi : beta;
    beta = isinf(hi) ? __fmul_rn(beta, 2.0f) : __fdiv_rn(__fadd_rn(lo, hi), 2.0f);
  }
  row_sums<kStaged>(src, n, diag, beta, red, sw, sdw);
  sw = fmaxf(sw, 1e-12f);
  float* out = pcond + r * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float d = kStaged ? src[j] : __ldg(src + j);
    const float w = (j == diag) ? 0.0f : expf(__fmul_rn(-d, beta));
    out[j] = __fdiv_rn(w, sw);
  }
}

__global__ void __launch_bounds__(kTile * kTileRows)
symmetrize_kernel(float* __restrict__ p, int n, float two_n) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj < bi) return;  // the pair (bi, bj) is the block (bj, bi)'s
  __shared__ float a[kTile][kTile + 1], b[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t nn = n;
  const size_t ri = static_cast<size_t>(bi) * kTile, rj = static_cast<size_t>(bj) * kTile;
  for (int y = ty; y < kTile; y += kTileRows) {
    const size_t i = ri + y, j = rj + tx;   // tile (bi, bj)
    a[y][tx] = (i < nn && j < nn) ? p[i * n + j] : 0.0f;
    const size_t i2 = rj + y, j2 = ri + tx; // tile (bj, bi)
    b[y][tx] = (i2 < nn && j2 < nn) ? p[i2 * n + j2] : 0.0f;
  }
  __syncthreads();
  for (int y = ty; y < kTile; y += kTileRows) {
    const size_t i = ri + y, j = rj + tx;
    if (i < nn && j < nn) p[i * n + j] = fmaxf(__fdiv_rn(__fadd_rn(a[y][tx], b[tx][y]), two_n), 1e-12f);
    const size_t i2 = rj + y, j2 = ri + tx;
    if (bi != bj && i2 < nn && j2 < nn) {
      p[i2 * n + j2] = fmaxf(__fdiv_rn(__fadd_rn(b[y][tx], a[tx][y]), two_n), 1e-12f);
    }
  }
}

}  // namespace

// d2: (rows, n) float32, rows row0 .. row0 + rows − 1 of the squared
// distances; pcond: (rows, n).  staged: 1 to stage each row in shared memory
// (n · 4 bytes, opted in here), 0 to read it from global memory each step.
G2V_EXPORT int k10c_calibrate_rows(const float* d2, int rows, int n, long long row0,
                                   float target, int iters, int staged, float* pcond,
                                   cudaStream_t stream) {
  if (rows == 0) return 0;
  if (staged) {
    const size_t bytes = static_cast<size_t>(n) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        calibrate_rows_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    calibrate_rows_kernel<true><<<rows, kThreads, bytes, stream>>>(d2, n, row0, target, iters,
                                                                   pcond);
  } else {
    calibrate_rows_kernel<false><<<rows, kThreads, 0, stream>>>(d2, n, row0, target, iters,
                                                                pcond);
  }
  return static_cast<int>(cudaGetLastError());
}

// p: (n, n) float32 conditionals, overwritten with the symmetrized P.
G2V_EXPORT int k10c_symmetrize(float* p, int n, cudaStream_t stream) {
  if (n == 0) return 0;
  const int tiles = (n + kTile - 1) / kTile;
  symmetrize_kernel<<<dim3(tiles, tiles), dim3(kTile, kTileRows), 0, stream>>>(
      p, n, 2.0f * static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}
