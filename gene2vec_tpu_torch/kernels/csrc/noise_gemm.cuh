// The stratified noise term, shared by K2 (exact head) and K3 (tail blocks).
//
// Both compute, for G groups of Eg consecutive examples, each against its
// own contiguous slab of S context rows starting at start_g:
//   logit[e, s]  = v[e] . ctx[start_g + s]                      (phase 1)
//   mask         = (start_g + s != contexts[e])
//   g[e, s]      = (K * w[row]) * sigmoid(logit) * mask
//   loss[e]     += sum_s (K * w[row]) * mask * softplus(logit)
//   d_center[e] (+)= sum_s g[e, s] * ctx[start_g + s]           (phase 2)
//   acc[row, :D] += sum_e g[e, s] * v[e]                        (phase 3)
//   acc[row,  D] += (K * w[row]) * sum_e mask                   (phase 3)
// The head is G = 1, start = 0, S = H, w = q; the tail is one drawn block
// per group, start_g = min(head + blocks[g]*S, vn - S), w = tail_w.
//
// Each phase is one SIMT tiled GEMM (64x64 output tile, K in steps of 16,
// 256 threads with a 4x4 register micro-tile, shared-memory staging with
// zero fill at ragged edges) and its own epilogue.  g goes through device
// memory between phases.  Phase 3 contracts over examples; it is split
// over K (grid z) when the tile count alone cannot fill the card, and adds
// its partial sums with atomics — which K3 needs anyway, since two groups
// can draw the same block and the clamped last block overlaps its
// neighbour.  The weight column uses an exact integer count of the masked
// pairs, recorded by phase 1, so it is sigma-free as in the reference.
#pragma once

#include "common.cuh"

namespace g2v {

constexpr int BM = 64, BN = 64, BK = 16, TPB = 256;

struct NoiseParams {
  const float* v;         // (E, D) center rows (K1 output)
  const float* u;         // (E, D) positive context rows (K1 output)
  const float* g_pos;     // (E,)
  const int* contexts;    // (E,)
  const float* ctx;       // (V, D) context table
  const float* w;         // (V,) per-row noise weight: q (head) or tail_w
  const int* blocks;      // (G,) drawn block ids; null for the head
  float* g;               // (E, S) scratch
  int* hits;              // (G, S) masked-pair counts, zeroed by the caller
  float* loss;            // (E,) accumulated, zeroed by the caller
  float* d_center;        // (E, D)
  float* acc;             // (V, D+1) accumulator
  float kneg;             // K, the number of negatives
  int D, S, Eg, head, vn, splits;
  int init_center;        // 1: d_center = g_pos*u + ...; 0: d_center += ...
};

__device__ __forceinline__ int group_start(const NoiseParams& p, int grp) {
  if (p.blocks == nullptr) return 0;
  return min(p.head + p.blocks[grp] * p.S, p.vn - p.S);
}

// acc[i][j] += sum_{k in [k_begin, k_end)} A(m0+ty+16i, k) * B(k, n0+tx+16j)
// A(m, k) = A_T ? A[k*lda + m] : A[m*lda + k]
// B(k, n) = B_T ? B[n*ldb + k] : B[k*ldb + n]
template <bool A_T, bool B_T>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A, int lda,
                                          const float* __restrict__ B, int ldb,
                                          int M, int N, int m0, int n0,
                                          int k_begin, int k_end,
                                          float acc[4][4]) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = t + r * TPB;
      {
        const int m = A_T ? (idx & 63) : (idx >> 4);
        const int k = A_T ? (idx >> 6) : (idx & 15);
        const int gm = m0 + m, gk = k0 + k;
        float x = 0.0f;
        if (gm < M && gk < k_end)
          x = A_T ? A[static_cast<size_t>(gk) * lda + gm]
                  : A[static_cast<size_t>(gm) * lda + gk];
        As[k][m] = x;
      }
      {
        const int n = B_T ? (idx >> 4) : (idx & 63);
        const int k = B_T ? (idx & 15) : (idx >> 6);
        const int gn = n0 + n, gk = k0 + k;
        float x = 0.0f;
        if (gn < N && gk < k_end)
          x = B_T ? B[static_cast<size_t>(gn) * ldb + gk]
                  : B[static_cast<size_t>(gk) * ldb + gn];
        Bs[k][n] = x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Phase 1: grid (ceil(S/64), ceil(Eg/64), G).  M = Eg, N = S, K = D.
__global__ void __launch_bounds__(TPB) noise_logits_kernel(NoiseParams p) {
  const int grp = blockIdx.z;
  const int start = group_start(p, grp);
  const int e0 = grp * p.Eg;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  gemm_tile<false, true>(p.v + static_cast<size_t>(e0) * p.D, p.D,
                         p.ctx + static_cast<size_t>(start) * p.D, p.D, p.Eg,
                         p.S, m0, n0, 0, p.D, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    const bool row_ok = m < p.Eg;
    const int e = e0 + m;
    const int c = row_ok ? p.contexts[e] : -1;
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (row_ok && n < p.S) {
        const int row = start + n;
        const float x = acc[i][j];
        const float kw = p.kneg * p.w[row];
        const float mask = (row != c) ? 1.0f : 0.0f;
        p.g[static_cast<size_t>(e) * p.S + n] = kw * g2v_sigmoid(x) * mask;
        part += kw * mask * g2v_softplus(x);
        if (row == c) atomicAdd(&p.hits[grp * p.S + n], 1);
      }
    }
    // the 16 threads sharing this row are one half-warp
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (tx == 0 && row_ok) atomicAdd(&p.loss[e], part);
  }
}

// Phase 2: grid (ceil(D/64), ceil(Eg/64), G).  M = Eg, N = D, K = S.
__global__ void __launch_bounds__(TPB) noise_center_kernel(NoiseParams p) {
  const int grp = blockIdx.z;
  const int start = group_start(p, grp);
  const int e0 = grp * p.Eg;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  gemm_tile<false, false>(p.g + static_cast<size_t>(e0) * p.S, p.S,
                          p.ctx + static_cast<size_t>(start) * p.D, p.D, p.Eg,
                          p.D, m0, n0, 0, p.S, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.Eg) continue;
    const int e = e0 + m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= p.D) continue;
      const size_t o = static_cast<size_t>(e) * p.D + n;
      const float base = p.init_center ? __fmul_rn(p.g_pos[e], p.u[o])
                                       : p.d_center[o];
      p.d_center[o] = __fadd_rn(base, acc[i][j]);
    }
  }
}

// Phase 3: grid (ceil(D/64), ceil(S/64), G * splits).  M = S, N = D,
// K = the group's examples, cut into `splits` ranges.
__global__ void __launch_bounds__(TPB) noise_rows_kernel(NoiseParams p) {
  const int grp = blockIdx.z / p.splits;
  const int split = blockIdx.z % p.splits;
  const int start = group_start(p, grp);
  const int e0 = grp * p.Eg;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int chunk = ((p.Eg + p.splits - 1) / p.splits + BK - 1) / BK * BK;
  const int k_begin = split * chunk;
  const int k_end = min(p.Eg, k_begin + chunk);
  float acc[4][4] = {};
  if (k_begin < k_end)
    gemm_tile<true, false>(p.g + static_cast<size_t>(e0) * p.S, p.S,
                           p.v + static_cast<size_t>(e0) * p.D, p.D, p.S, p.D,
                           m0, n0, k_begin, k_end, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D1 = p.D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.S) continue;
    float* arow = p.acc + static_cast<size_t>(start + m) * D1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < p.D) atomicAdd(&arow[n], acc[i][j]);
    }
  }
  if (blockIdx.x == 0 && split == 0 && threadIdx.x < BM) {
    const int m = m0 + threadIdx.x;
    if (m < p.S) {
      const int row = start + m;
      const int cnt = p.Eg - p.hits[grp * p.S + m];
      atomicAdd(&p.acc[static_cast<size_t>(row) * D1 + p.D],
                (p.kneg * p.w[row]) * static_cast<float>(cnt));
    }
  }
}

inline int launch_noise(const NoiseParams& p, int G, cudaStream_t stream) {
  const dim3 block(TPB);
  const int mt = (p.Eg + BM - 1) / BM;
  const int st = (p.S + BN - 1) / BN;
  const int dt = (p.D + BN - 1) / BN;
  noise_logits_kernel<<<dim3(st, mt, G), block, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  noise_center_kernel<<<dim3(dt, mt, G), block, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  noise_rows_kernel<<<dim3(dt, (p.S + BM - 1) / BM, G * p.splits), block, 0,
                      stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace g2v
