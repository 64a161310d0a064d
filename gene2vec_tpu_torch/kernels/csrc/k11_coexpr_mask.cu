// K11 — co-expression mask: the bits of clip(|zᵀz| / (n − 1), 0, 1) > thr.
//
// Replaces: gene2vec_tpu/corpus/builder.py:145-171 (abs_correlation_mask,
// backend "jax"; the product of :125-142), an XLA program, not a Pallas
// kernel: a float32 matmul of the standardized (n, g) study matrix with
// itself at Precision.HIGHEST, the |·| / (n − 1) scale, the clip, the
// threshold, and jnp.packbits of the (g, g) mask, so that only bits leave
// the device.
//
// Bound on the H100: operations.  C = zᵀz is symmetric, so the function
// needs one triangle: g(g + 1)·n float32 FLOP at 67 TFLOP/s (SIMT: TF32
// stays off, since reduced precision flips pairs near the threshold,
// builder.py:133-135): g = 24,447, n = 160 is 9.56e10 FLOP, ~1.43 ms.
// This design computes both triangles (2·g²·n), twice that.  The bytes
// are z once (n·g·4) and the packed words once (g·⌈g/32⌉·4, 74.7 MB at
// g = 24,447, ~0.022 ms).
//
// Design: a tiled SIMT GEMM whose epilogue compares and packs, so the
// float (g, g) matrix is never stored.  A block takes a 64-row × 128-column
// tile of C = zᵀz; both operands are column slices of z, so each staged
// depth step reads 16 samples × (64 + 128) genes along z's contiguous gene
// axis.  Warp w owns rows 8w..8w+7 of the tile and lane l columns l + 32c
// (c < 4): each lane keeps 8 × 4 sums, reads its 8 row values as two
// broadcast float4s and its 4 column values conflict-free.  The sums run
// over the samples in increasing order, one fmaf each; since a fused
// product commutes exactly, C[i][j] and C[j][i] are the same bits and the
// mask is symmetric.  The epilogue follows builder.py:166-170 operation for
// operation — |acc| / (n − 1) with IEEE division (__fdiv_rn; no multiply
// by a reciprocal), the clip to [0, 1], c > (float)thr — and a warp ballot
// over the 32 lanes is the word of 32 columns: lane 4r + c writes row r's
// word c.  Rows are padded to ⌈g/32⌉ uint32 words, bit b of word w column
// 32w + b; bits past g are 0.  (jnp.packbits' flat big-endian layout
// straddles rows when g % 8 ≠ 0, so blocks would share bytes; the host
// unpacks these words instead.)  All-zero (zero-variance) columns give
// 0 and never pass a threshold ≥ 0; a threshold ≥ 1 gives no bit.
#include "common.cuh"

namespace {

constexpr int kRows = 64;      // C rows (genes i) a block
constexpr int kCols = 128;     // C columns (genes j) a block: 4 words a row
constexpr int kDepth = 16;     // samples staged a step
constexpr int kThreads = 256;  // 8 warps × 8 rows; lanes × 4 column groups

__global__ void __launch_bounds__(kThreads)
coexpr_mask_kernel(const float* __restrict__ z, int n, int g, int words, float denom,
                   float thr, uint32_t* __restrict__ out) {
  __shared__ __align__(16) float as[kDepth][kRows];
  __shared__ float bs[kDepth][kCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = blockIdx.y * kRows, j0 = blockIdx.x * kCols;
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  }
  for (int k0 = 0; k0 < n; k0 += kDepth) {
    for (int e = threadIdx.x; e < kDepth * kRows; e += kThreads) {
      const int kk = e / kRows, i = i0 + e % kRows, k = k0 + kk;
      as[kk][e % kRows] = (k < n && i < g) ? __ldg(z + static_cast<size_t>(k) * g + i) : 0.0f;
    }
    for (int e = threadIdx.x; e < kDepth * kCols; e += kThreads) {
      const int kk = e / kCols, j = j0 + e % kCols, k = k0 + kk;
      bs[kk][e % kCols] = (k < n && j < g) ? __ldg(z + static_cast<size_t>(k) * g + j) : 0.0f;
    }
    __syncthreads();
    // padded samples are 0 · 0 products, which leave a sum unchanged
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 lo = *reinterpret_cast<const float4*>(&as[kk][warp * 8]);
      const float4 hi = *reinterpret_cast<const float4*>(&as[kk][warp * 8 + 4]);
      const float a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      float b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = bs[kk][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
    __syncthreads();
  }
  uint32_t mine = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + lane + 32 * c;
      const float v = fminf(fmaxf(__fdiv_rn(fabsf(acc[r][c]), denom), 0.0f), 1.0f);
      const uint32_t word = __ballot_sync(0xffffffffu, j < g && v > thr);
      if (lane == r * 4 + c) mine = word;
    }
  }
  const int i = i0 + warp * 8 + lane / 4, w = blockIdx.x * 4 + lane % 4;
  if (i < g && w < words) out[static_cast<size_t>(i) * words + w] = mine;
}

}  // namespace

// z: (n, g) float32, row-major (samples × genes); out: (g, ⌈g/32⌉) words.
G2V_EXPORT int k11_coexpr_mask(const float* z, int n, int g, float thr, uint32_t* out,
                               cudaStream_t stream) {
  const int words = (g + 31) / 32;
  const dim3 grid((g + kCols - 1) / kCols, (g + kRows - 1) / kRows);
  coexpr_mask_kernel<<<grid, kThreads, 0, stream>>>(z, n, g, words,
                                                    static_cast<float>(n - 1), thr, out);
  return static_cast<int>(cudaGetLastError());
}
