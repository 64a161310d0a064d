// The dense noise terms of K5b (shared pool) and K6's shallow phase
// (hierarchical softmax over the node prefix).  K2 and K3, the stratified
// step's head and tail blocks, left this header for noise_tc.cuh (3xTF32
// tensor cores, two launches); this one now serves K5b and K6 only.
//
// Both compute, for G groups of Eg consecutive examples, each against its
// own slab of S context rows — the S pool ids ids[g*S .. g*S+S-1] (K5b)
// or the node rows 0 .. S-1 (K6, G = 1):
//   logit[e, s]  = v[e] . ctx[row(g, s)]                        (phase 1)
//   mask         = (row != contexts[e])
//   g[e, s]      = (K * w[row]) * sigmoid(logit) * mask          (w = 1: pool)
//   loss[e]     += sum_s (K * w[row]) * mask * softplus(logit)
//   d_center[e] (+)= sum_s g[e, s] * ctx[row(g, s)]              (phase 2)
//   acc[row, :D] += sum_e g[e, s] * v[e]                        (phase 3)
//   acc[row,  D] += (K * w[row]) * sum_e mask                   (phase 3)
// The shared pool is ids = the pool, w = 1, K = the importance scale
// K*G/P.  With `sign` (K6's shallow phase: G = 1, start 0, S = Ns node
// rows) the epilogue is hierarchical softmax's instead: s = sign[targets[e],
// n] in {+1, -1, 0}, g = |s| * (sigmoid(logit) - (1 + s)/2), loss += |s| *
// softplus(-s * logit), and the weight column counts the examples whose
// path holds the node (sum_e |s|).
//
// Each phase is one SIMT tiled GEMM (64x64 output tile, K in steps of 16,
// 256 threads with a 4x4 register micro-tile, shared-memory staging with
// zero fill at ragged edges) and its own epilogue.  g goes through device
// memory between phases.  Phase 3 contracts over examples; it is split
// over K (grid z) when the tile count alone cannot fill the card, and adds
// its partial sums with atomics — which K5b needs anyway, since two
// groups can draw the same pool row.  The weight column uses an exact
// integer count of the masked (or on-path) pairs, recorded by phase 1, so
// it is sigma-free as in the reference.
//
// The slab kind (pool ids, HS sign rows) is a template parameter of the
// kernels, fixed by each entry point, so each runs its own code with no
// per-element branch on the other kind.  So is the table's element type T
// (float or __nv_bfloat16): the slab rows, the GEMMs' B operand in phases
// 1 and 2, are upcast to float32 as they are staged, and the shared-memory
// tiles, g and every sum stay float32.  Phase 3's B operand is v, float32
// whatever the table.
#pragma once

#include "common.cuh"

namespace g2v {

constexpr int BM = 64, BN = 64, BK = 16, TPB = 256;

// Where a group's S slab rows come from, and which epilogue runs.
enum class Slab {
  kPool,        // pool ids ids[g*S + s] (K5b)
  kSign,        // node rows 0 .. S - 1 with HS sign rows (K6's shallow phase)
};

struct NoiseParams {
  const float* v;         // (E, D) center rows (K1 output)
  const float* u;         // (E, D) positive context rows (K1 output)
  const float* g_pos;     // (E,)
  const int* contexts;    // (E,)
  const void* ctx;        // (V, D) context table, float or bfloat16 (T)
  const float* w;         // (V,) per-row noise weight (unused: pool and HS)
  const int* ids;         // (G*S,) pool row ids (K5b); null for K6
  const signed char* sign;  // (V, S) HS sign rows (K6 shallow); null: SGNS
  const int* targets;     // (E,) HS targets whose sign rows are read
  float* g;               // (E, S) scratch
  int* hits;              // (G, S) masked-pair counts, zeroed by the caller
  float* loss;            // (E,) accumulated, zeroed by the caller
  float* d_center;        // (E, D)
  float* acc;             // (V, D+1) accumulator
  float kneg;             // K, the number of negatives
  int D, S, Eg, splits;
  int init_center;        // 1: d_center = g_pos*u + ...; 0: d_center += ...
};

// The group's first slab row (kSign: node row 0) or its offset into the
// pool (kPool).
template <Slab kSlab>
__device__ __forceinline__ int group_start(const NoiseParams& p, int grp) {
  if constexpr (kSlab == Slab::kPool) return grp * p.S;
  return 0;
}

// Table row of slab slot s of the group starting at `start`.
template <Slab kSlab>
__device__ __forceinline__ int slab_row(const NoiseParams& p, int start, int s) {
  if constexpr (kSlab == Slab::kPool) return p.ids[start + s];
  return start + s;
}

// The slab as a GEMM operand: (base, row map) — the node rows from
// ctx + start*D, or the pool's rows of ctx.
template <Slab kSlab, typename T>
__device__ __forceinline__ const T* slab_base(const NoiseParams& p, int start) {
  const T* ctx = static_cast<const T*>(p.ctx);
  if constexpr (kSlab == Slab::kPool) return ctx;
  return ctx + static_cast<size_t>(start) * p.D;
}

// The pool ids of the group's slab (kPool), else null.
template <Slab kSlab>
__device__ __forceinline__ const int* pool_map(const NoiseParams& p, int start) {
  if constexpr (kSlab == Slab::kPool) return p.ids + start;
  return nullptr;
}

// acc[i][j] += sum_{k in [k_begin, k_end)} A(m0+ty+16i, k) * B(k, n0+tx+16j)
// A(m, k) = A_T ? A[k*lda + m] : A[m*lda + k]
// B(k, n) = B_T ? B[map(n)*ldb + k] : B[map(k)*ldb + n]
// with map the row map `bmap` when kMapped (B's rows are gathered table
// rows), else the identity.  B's elements (type TB) load as float32.
template <bool A_T, bool B_T, bool kMapped, typename TB>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A, int lda,
                                          const TB* __restrict__ B, int ldb,
                                          const int* __restrict__ bmap,
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
        if (gn < N && gk < k_end) {
          if (B_T) {
            const int row = kMapped ? bmap[gn] : gn;
            x = g2v_ld(B + static_cast<size_t>(row) * ldb + gk);
          } else {
            const int row = kMapped ? bmap[gk] : gk;
            x = g2v_ld(B + static_cast<size_t>(row) * ldb + gn);
          }
        }
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
template <Slab kSlab, typename T>
__global__ void __launch_bounds__(TPB) noise_logits_kernel(NoiseParams p) {
  constexpr bool kSign = kSlab == Slab::kSign;
  const int grp = blockIdx.z;
  const int start = group_start<kSlab>(p, grp);
  const int e0 = grp * p.Eg;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  gemm_tile<false, true, kSlab == Slab::kPool>(
      p.v + static_cast<size_t>(e0) * p.D, p.D, slab_base<kSlab, T>(p, start), p.D,
      pool_map<kSlab>(p, start), p.Eg, p.S, m0, n0, 0, p.D, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    const bool row_ok = m < p.Eg;
    const int e = e0 + m;
    const int c = (row_ok && !kSign) ? p.contexts[e] : -1;
    const signed char* srow =
        (row_ok && kSign) ? p.sign + static_cast<size_t>(p.targets[e]) * p.S : nullptr;
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (row_ok && n < p.S) {
        const float x = acc[i][j];
        float* gp = &p.g[static_cast<size_t>(e) * p.S + n];
        if constexpr (kSign) {
          const float sg = static_cast<float>(srow[n]);
          const float a = fabsf(sg);
          *gp = a * (g2v_sigmoid(x) - (1.0f + sg) / 2.0f);
          part += a * g2v_softplus(-sg * x);
          if (srow[n] != 0) atomicAdd(&p.hits[n], 1);
        } else {
          const int row = slab_row<kSlab>(p, start, n);
          const float kw = p.kneg * (kSlab == Slab::kPool ? 1.0f : p.w[row]);
          const float mask = (row != c) ? 1.0f : 0.0f;
          *gp = kw * g2v_sigmoid(x) * mask;
          part += kw * mask * g2v_softplus(x);
          if (row == c) atomicAdd(&p.hits[grp * p.S + n], 1);
        }
      }
    }
    // the 16 threads sharing this row are one half-warp
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (tx == 0 && row_ok) atomicAdd(&p.loss[e], part);
  }
}

// Phase 2: grid (ceil(D/64), ceil(Eg/64), G).  M = Eg, N = D, K = S.
template <Slab kSlab, typename T>
__global__ void __launch_bounds__(TPB) noise_center_kernel(NoiseParams p) {
  const int grp = blockIdx.z;
  const int start = group_start<kSlab>(p, grp);
  const int e0 = grp * p.Eg;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  gemm_tile<false, false, kSlab == Slab::kPool>(
      p.g + static_cast<size_t>(e0) * p.S, p.S, slab_base<kSlab, T>(p, start), p.D,
      pool_map<kSlab>(p, start), p.Eg, p.D, m0, n0, 0, p.S, acc);
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
template <Slab kSlab>
__global__ void __launch_bounds__(TPB) noise_rows_kernel(NoiseParams p) {
  const int grp = blockIdx.z / p.splits;
  const int split = blockIdx.z % p.splits;
  const int start = group_start<kSlab>(p, grp);
  const int e0 = grp * p.Eg;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int chunk = ((p.Eg + p.splits - 1) / p.splits + BK - 1) / BK * BK;
  const int k_begin = split * chunk;
  const int k_end = min(p.Eg, k_begin + chunk);
  float acc[4][4] = {};
  if (k_begin < k_end)
    gemm_tile<true, false, false>(p.g + static_cast<size_t>(e0) * p.S, p.S,
                                  p.v + static_cast<size_t>(e0) * p.D, p.D, nullptr,
                                  p.S, p.D, m0, n0, k_begin, k_end, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D1 = p.D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.S) continue;
    float* arow = p.acc + static_cast<size_t>(slab_row<kSlab>(p, start, m)) * D1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < p.D) atomicAdd(&arow[n], acc[i][j]);
    }
  }
  if (blockIdx.x == 0 && split == 0 && threadIdx.x < BM) {
    const int m = m0 + threadIdx.x;
    if (m < p.S) {
      const int row = slab_row<kSlab>(p, start, m);
      float weight;
      if constexpr (kSlab == Slab::kSign) {  // examples whose path holds the node
        weight = static_cast<float>(p.hits[m]);
      } else {                               // K * w[row] * unmasked examples
        const int cnt = p.Eg - p.hits[grp * p.S + m];
        weight = (p.kneg * (kSlab == Slab::kPool ? 1.0f : p.w[row])) *
                 static_cast<float>(cnt);
      }
      atomicAdd(&p.acc[static_cast<size_t>(row) * D1 + p.D], weight);
    }
  }
}

template <Slab kSlab, typename T>
inline int launch_noise(const NoiseParams& p, int G, cudaStream_t stream) {
  const dim3 block(TPB);
  const int mt = (p.Eg + BM - 1) / BM;
  const int st = (p.S + BN - 1) / BN;
  const int dt = (p.D + BN - 1) / BN;
  noise_logits_kernel<kSlab, T><<<dim3(st, mt, G), block, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  noise_center_kernel<kSlab, T><<<dim3(dt, mt, G), block, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  noise_rows_kernel<kSlab><<<dim3(dt, (p.S + BM - 1) / BM, G * p.splits), block, 0,
                             stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// launch_noise at the table's element type: bf16 = 0 (float) or 1.
template <Slab kSlab>
inline int launch_noise_as(const NoiseParams& p, int G, int bf16, cudaStream_t stream) {
  return bf16 ? launch_noise<kSlab, __nv_bfloat16>(p, G, stream)
              : launch_noise<kSlab, float>(p, G, stream);
}

}  // namespace g2v
