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
// builder.py:133-135; a 3×TF32 split drops lo·lo products that the stated
// bar EPS_N does not model): 1.4273 ms at g = 24,447, n = 160 and 0.2141
// ms at n = 24.  The bytes are z once (n·g·4) and the packed words once
// (g·⌈g/32⌉·4 = 74.7 MB at g = 24,447, ~0.022 ms).
//
// Output: rows of ⌈g/32⌉ uint32 words, bit b of word w column 32w + b;
// bits past g are 0.  (jnp.packbits' flat big-endian layout straddles rows
// when g % 8 ≠ 0, so blocks would share bytes; the host unpacks these
// words instead.)
//
// Design, against what held the first design (both triangles, 8 × 4 sums
// a thread, synchronous scalar loads, a division an element) back:
// - One triangle.  A block takes one 128 × 128 tile pair (bi, bj) with
//   bj ≥ bi, its linear index mapped to (bi, bj) in closed form: 18,336
//   blocks at g = 24,447 where both triangles took 2·191².  An off-diagonal
//   tile writes its own words (rows i, columns j) and the mirrored ones
//   (rows j, columns i) from the same predicates: a 32 × 32 bit block is
//   transposed in a warp by five shuffle-and-mask steps, lane r holding
//   row r's word.  Every sum is one fmaf a sample over the samples in
//   increasing order from 0, and a fused product commutes exactly, so
//   C[i][j] and C[j][i] are the same bits, the mirrored words are the
//   words the other triangle's tile would write, and the words are
//   bitwise the first design's.
// - A register-tiled product: 256 threads, 8 × 8 sums each.  Warp w owns
//   rows {16·(w/2) .. +15} and {64 + 16·(w/2) .. +15} of the tile and
//   columns {32·(w%2) .. +31} and {64 + 32·(w%2) .. +31}; lane l takes 4 +
//   4 rows from 4·(l/8) and 4 + 4 columns from 4·(l%8) in each.  A sample
//   costs 4 LDS.128 for 64 FFMA: A's quarter-warp reads one address
//   (broadcast), B's reads 8 consecutive float4s (no conflict).
// - Asynchronous loads.  Each stage is 8 samples × 128 genes of both
//   operands, one 16-byte cp.async.cg a thread an operand, two stages
//   double-buffered, so stage s + 1 copies while stage s computes.  The
//   depth of 8 leaves n = 24, 64 and 160 unpadded (past n the copies fill
//   zeros, and a 0 · 0 product leaves a sum's bits unchanged).  16-byte
//   copies need every row of z on a 16-byte boundary, so the wrapper hands
//   the kernel z with its row pitch rounded up to 4 floats (a copy when g
//   % 4 ≠ 0: 15.6 MB at n = 160).  cp.async and not TMA: a stage is two
//   1 KB slabs, one 16-byte copy a thread, with no producer warp, barrier
//   or tensor map to set up on the host.
// - An exact threshold on the sum.  fl(a / (n − 1)) is monotone in a, so
//   clip(fl(|acc| / (n − 1)), 0, 1) > thr is |acc| ≥ a*, with a* the least
//   float32 a ≥ 0 that passes, found on the host by bisection over float32
//   bit patterns (coexpr_mask.sum_threshold; NaN where no sum passes,
//   thr ≥ 1, since every compare with NaN is false).  The epilogue is one
//   compare an element and no division.  The predicates go to a nibble
//   tile in shared memory (a thread's 4 adjacent columns), 8 nibbles make
//   a word, and the words leave as each row's 4 adjacent words.
#include "common.cuh"

#define K11_STAGES 2    // kernel_split.py's single_buffer: 1
#define K11_MIRROR 1    // 0: the mirrored words are not written (no_mirror)
#define K11_EPILOGUE 1  // 0: no compare or packing, the sums kept alive by one word a tile

namespace {

constexpr int kTile = 128;      // C rows and columns a block: 4 words a row
constexpr int kDepth = 8;       // samples a stage
constexpr int kThreads = 256;   // 8 warps of 32 × 64 sums
constexpr int kNibPitch = 40;   // bytes a row of the nibble tile: 32 + 8, no bank conflict
constexpr int kWordPitch = 5;   // words a row of the word tiles: 4 + 1, no bank conflict

__device__ __forceinline__ void cp_async16(void* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Eight nibbles, one a byte (lo: 0-3, hi: 4-7), as one word: nibble t at
// bits 4t .. 4t + 3.
__device__ __forceinline__ uint32_t pack_nibbles(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo | (lo >> 4), hi | (hi >> 4), 0x6420);
}

// One step of transpose32: lanes r and r ^ J swap the off-diagonal J × J
// halves of every 2J × 2J block; M marks the columns c with c & J = 0.
template <int J, uint32_t M>
__device__ __forceinline__ uint32_t swap_halves(uint32_t x, int lane) {
  const uint32_t y = __shfl_xor_sync(0xffffffffu, x, J);
  return (lane & J) ? ((x & ~M) | ((y >> J) & M)) : ((x & M) | ((y << J) & ~M));
}

// Lane r holds row r of a 32 × 32 bit block (bit c = column c); returns
// column `lane` (bit r = row r).
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  x = swap_halves<16, 0x0000FFFFu>(x, lane);
  x = swap_halves<8, 0x00FF00FFu>(x, lane);
  x = swap_halves<4, 0x0F0F0F0Fu>(x, lane);
  x = swap_halves<2, 0x33333333u>(x, lane);
  return swap_halves<1, 0x55555555u>(x, lane);
}

// One stage: samples k0 .. k0 + 7 of genes i0 .. i0 + 127 (a) and j0 ..
// j0 + 127 (b); thread tid copies sample k0 + tid / 32, genes 4·(tid % 32)
// .. + 3 of each, zeros past n and past the row pitch.
__device__ __forceinline__ void load_stage(float (*a)[kTile], float (*b)[kTile],
                                           const float* __restrict__ z, int pitch, int n,
                                           int i0, int j0, int k0, int tid) {
  const int kk = tid >> 5, c = (tid & 31) * 4, k = k0 + kk;
  const bool ok_a = k < n && i0 + c < pitch, ok_b = k < n && j0 + c < pitch;
  const float* row = z + static_cast<size_t>(k) * pitch;
  cp_async16(&a[kk][c], ok_a ? row + i0 + c : z, ok_a);
  cp_async16(&b[kk][c], ok_b ? row + j0 + c : z, ok_b);
}

__global__ void __launch_bounds__(kThreads, 2)
coexpr_mask_kernel(const float* __restrict__ z, int pitch, int n, int g, int words, float astar,
                   uint32_t* __restrict__ out) {
  __shared__ __align__(16) float sa[K11_STAGES][kDepth][kTile];
  __shared__ __align__(16) float sb[K11_STAGES][kDepth][kTile];
  // the tile pair: blocks enumerate bj = 0, 1, ... with bi = 0 .. bj
  const int t = blockIdx.x;
  int bj = static_cast<int>((sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
  while (bj * (bj + 1) / 2 > t) --bj;
  while ((bj + 1) * (bj + 2) / 2 <= t) ++bj;
  const int bi = t - bj * (bj + 1) / 2;
  const int i0 = bi * kTile, j0 = bj * kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_a = (warp >> 1) * 16 + (lane >> 3) * 4;  // + 64·rh + r: the thread's rows
  const int col_b = (warp & 1) * 32 + (lane & 7) * 4;    // + 64·h + c: its columns

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  }
  const int steps = (n + kDepth - 1) / kDepth;
  if (steps > 0) load_stage(sa[0], sb[0], z, pitch, n, i0, j0, 0, tid);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
#if K11_STAGES == 2
    const int buf = s & 1;
    if (s + 1 < steps)
      load_stage(sa[buf ^ 1], sb[buf ^ 1], z, pitch, n, i0, j0, (s + 1) * kDepth, tid);
    cp_async_commit();
    cp_async_wait<1>();
#else
    const int buf = 0;
    cp_async_wait<0>();
#endif
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[buf][kk][row_a]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sa[buf][kk][row_a + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[buf][kk][col_b]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sb[buf][kk][col_b + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
    __syncthreads();
#if K11_STAGES == 1
    if (s + 1 < steps) load_stage(sa[0], sb[0], z, pitch, n, i0, j0, (s + 1) * kDepth, tid);
    cp_async_commit();
#endif
  }

#if K11_EPILOGUE
  __shared__ __align__(8) uint8_t nib[kTile][kNibPitch];
  __shared__ uint32_t direct[kTile][kWordPitch];
  // nibble (row, 16h + 8·(warp % 2) + lane % 8) holds columns 64h + col_b .. + 3
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int ti = (r >> 2) * 64 + row_a + (r & 3);
    const bool row_ok = i0 + ti < g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t bits = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool pass = fabsf(acc[r][h * 4 + c]) >= astar;
        bits |= (pass && row_ok && j0 + h * 64 + col_b + c < g) ? (1u << c) : 0u;
      }
      nib[ti][h * 16 + (col_b >> 2)] = static_cast<uint8_t>(bits);
    }
  }
  __syncthreads();
  // thread tid: row tid / 2, words 2·(tid % 2) and + 1
  const int wr = tid >> 1, wq = (tid & 1) * 2;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint2 v = *reinterpret_cast<const uint2*>(&nib[wr][8 * (wq + k)]);
    const uint32_t word = pack_nibbles(v.x, v.y);
    direct[wr][wq + k] = word;
    if (i0 + wr < g && 4 * bj + wq + k < words)
      out[static_cast<size_t>(i0 + wr) * words + 4 * bj + wq + k] = word;
  }
#if K11_MIRROR
  if (bi != bj) {
    __shared__ uint32_t mirror[kTile][kWordPitch];
    __syncthreads();
    // warp w transposes the 32 × 32 blocks (p, q) = (w / 2, 2·(w % 2) + e):
    // tile rows 32p .., columns 32q .. become mirrored rows 32q .., word p
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = warp >> 1, q = (warp & 1) * 2 + e;
      mirror[32 * q + lane][p] = transpose32(direct[32 * p + lane][q], lane);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (j0 + wr < g && 4 * bi + wq + k < words)
        out[static_cast<size_t>(j0 + wr) * words + 4 * bi + wq + k] = mirror[wr][wq + k];
    }
  }
#endif
#else
  uint32_t x = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) x ^= __float_as_uint(acc[r][c]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0 && i0 < g) atomicXor(out + static_cast<size_t>(i0) * words + 4 * bj, x);
#endif
}

}  // namespace

// z: (n, g) float32 samples × genes, row k at z + k·pitch, pitch a multiple
// of 4 and z on a 16-byte boundary; astar: coexpr_mask.sum_threshold(n,
// thr); out: (g, ⌈g/32⌉) words.
G2V_EXPORT int k11_coexpr_mask(const float* z, int pitch, int n, int g, float astar,
                               uint32_t* out, cudaStream_t stream) {
  if (g <= 0) return 0;
  const int tiles = (g + kTile - 1) / kTile;
  coexpr_mask_kernel<<<tiles * (tiles + 1) / 2, kThreads, 0, stream>>>(
      z, pitch, n, g, (g + 31) / 32, astar, out);
  return static_cast<int>(cudaGetLastError());
}
