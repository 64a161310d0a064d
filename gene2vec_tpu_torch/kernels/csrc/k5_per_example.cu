// K5a — per-example noise (gensim's estimator: K alias draws per example).
//
// Replaces: gene2vec_tpu/sgns/step.py:97-130 (sgns_loss_and_grads, its
// noise half) and the ctx scatter of _step_per_example (:289-334), which
// adds the positive contexts and the noise draws in one fused scatter:
//   neg_logit[e, k] = v[e] . ctx[negs[e, k]],  mask = negs[e, k] != context,
//   loss_neg[e]     = sum_k mask * softplus(neg_logit),
//   g_neg           = sigmoid(neg_logit) * mask,
//   d_center[e]     = g_pos[e]*u[e] + sum_k g_neg[e, k] * ctx[negs[e, k]],
//   acc[negs[e, k]]    += [g_neg[e, k] * v[e] | mask],
//   acc[contexts[e]]   += [g_pos[e] * v[e] | 1].
// The centers' scatter and the finalizes go through K4's generic entry
// points.
//
// Bound on the H100: bytes.  The function reads v, u, g_pos, the ids and
// each distinct noise row once, writes d_center and the loss, and reads
// and writes each accumulator row it adds to (the distinct draws and
// contexts, D + 1 floats) once: at E = 8192, K = 5, D = 200, the step's
// Zipf contexts and its alias draws (~14,500 distinct noise rows, ~15,100
// accumulator rows) that is ~56 MB, ~0.017 ms at 3.35 TB/s; bfloat16
// tables halve the noise-row reads: ~50 MB, ~0.015 ms.
//
// Design: a warp an example, everything in registers.  When D is a
// multiple of a 16-byte chunk (4 float32 or 8 bfloat16 elements), at most
// 256, and v, u and d_center are 16-byte aligned, a lane holds its chunks
// of v, u and of KB noise rows (KB = K for K <= 8, else passes of 8): all
// KB rows are requested before the first is used, their dots reduce
// together (interleaved shuffles, not one row after another), lane k
// forms draw k's loss term and g once, and d_center is formed from the
// same registers, so no row is read twice.  The payloads go out through
// g2v_add_row (float4 atomics on each accumulator row's aligned middle,
// the count column in the same call), reading v from the warp's copy in
// shared memory, because the helper's lane-to-column map depends on the
// row's alignment.  A masked draw (it hit the positive) contributes zeros
// and is skipped.  Rows are in frequency order, so ids below kHot are the
// hottest draws and contexts (at the step's shapes row 0 takes ~2% of the
// draws and ~9% of the contexts, rows 0-7 ~7% and ~25%): their payloads
// are summed in the block's shared memory and flushed once a block.
// Blocks are persistent (the SM count times the occupancy), each over a
// contiguous range of examples, so a hot row takes one flush a block
// instead of an atomic from every example that names it.  Other widths
// take an element-wise kernel of the same outputs, a warp an example.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;  // widths the chunked kernel holds in registers
constexpr int kMaxKB = 8;   // noise rows a lane holds at once
constexpr int kHot = 8;     // rows summed in shared memory before one flush

// acc[n] += [g * v | w]: the warp's v staged in shared memory (vs).
__device__ __forceinline__ void add_payload(float* acc, int n, int D, const float* vs, float g,
                                            float w, int lane) {
  g2v_add_row(acc + static_cast<size_t>(n) * (D + 1), D + 1, lane,
              [&](int d) { return d < D ? __fmul_rn(g, vs[d]) : w; });
}

// acc[n] += [g * v | w] for a row n < kHot, into the block's slot.
__device__ __forceinline__ void add_hot(float* hot, int n, int D, const float* vs, float g,
                                        float w, int lane) {
  float* row = hot + n * (D + 1);
  for (int d = lane; d <= D; d += 32) atomicAdd(row + d, d < D ? __fmul_rn(g, vs[d]) : w);
}

// Examples [blockIdx.x * per_block, + per_block), a warp each in turn.
template <typename T, int KB>
__global__ void __launch_bounds__(kThreads)
    per_example_chunks_kernel(const float* __restrict__ v, const float* __restrict__ u,
                              const float* __restrict__ g_pos, const int* __restrict__ contexts,
                              const int* __restrict__ negs, const T* __restrict__ ctx,
                              float* __restrict__ loss_neg, float* __restrict__ d_center,
                              float* __restrict__ acc, int E, int K, int D, int per_block) {
  constexpr int W = G2vChunk<T>::kElems;
  constexpr int NC = kMaxD / (32 * W);  // chunks a lane holds: 2 float32, 1 bfloat16
  __shared__ __align__(16) float v_smem[kWarps][kMaxD];
  __shared__ float hot[kHot * (kMaxD + 1)];
  const int D1 = D + 1;
  for (int i = threadIdx.x; i < kHot * D1; i += kThreads) hot[i] = 0.0f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = D / W;
  const int e_end = min(E, (blockIdx.x + 1) * per_block);
  for (int e = blockIdx.x * per_block + warp; e < e_end; e += kWarps) {
    const int c = __ldg(contexts + e);
    const float gp = __ldg(g_pos + e);
    const size_t o = static_cast<size_t>(e) * D;
    float vv[NC][W], uu[NC][W], dc[NC][W];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int q = lane + 32 * j;
      if (q < chunks) {
        g2v_ld_floats(v + o + q * W, vv[j]);
        g2v_ld_floats(u + o + q * W, uu[j]);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) dc[j][i] = 0.0f;
    }
    float* vs = v_smem[warp];
    float loss = 0.0f;
    for (int k0 = 0; k0 < K; k0 += KB) {
      const int kn = min(KB, K - k0);
      const int mine = lane < kn ? __ldg(negs + static_cast<size_t>(e) * K + k0 + lane) : 0;
      int n[KB];
      uint4 r[KB][NC];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        n[k] = __shfl_sync(0xffffffffu, mine, k);
        const T* row = ctx + static_cast<size_t>(n[k]) * D;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int q = lane + 32 * j;
          if (k < kn && q < chunks) r[k][j] = g2v_ld_chunk(row + q * W);
        }
      }
      if (k0 == 0) {  // v into shared memory while the rows are in flight
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int q = lane + 32 * j;
          if (q < chunks) g2v_st_floats(vs + q * W, vv[j]);
        }
        __syncwarp();
      }
      float s[KB];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        s[k] = 0.0f;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int q = lane + 32 * j;
          if (k < kn && q < chunks) {
            float f[W];
            g2v_chunk_floats(r[k][j], f);
#pragma unroll
            for (int i = 0; i < W; ++i) s[k] = fmaf(vv[j][i], f[i], s[k]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < KB; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
      }
      // lane k < kn forms draw k's loss term and g (once, not in every
      // lane); every lane then takes the KB g's
      float s_mine = 0.0f, l_mine = 0.0f, g_mine = 0.0f;
#pragma unroll
      for (int k = 0; k < KB; ++k) s_mine = lane == k ? s[k] : s_mine;
      if (lane < kn) {
        const float mask = (mine != c) ? 1.0f : 0.0f;
        l_mine = mask * g2v_softplus(s_mine);
        g_mine = g2v_sigmoid(s_mine) * mask;
      }
      float g[KB];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        g[k] = __shfl_sync(0xffffffffu, g_mine, k);
        const float l = __shfl_sync(0xffffffffu, l_mine, k);
        if (k < kn) loss += l;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int q = lane + 32 * j;
          if (k < kn && q < chunks) {
            float f[W];
            g2v_chunk_floats(r[k][j], f);
#pragma unroll
            for (int i = 0; i < W; ++i) dc[j][i] = fmaf(g[k], f[i], dc[j][i]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k < kn && n[k] != c) {
          if (n[k] < kHot) {
            add_hot(hot, n[k], D, vs, g[k], 1.0f, lane);
          } else {
            add_payload(acc, n[k], D, vs, g[k], 1.0f, lane);
          }
        }
      }
    }
    if (c < kHot) {
      add_hot(hot, c, D, vs, gp, 1.0f, lane);
    } else {
      add_payload(acc, c, D, vs, gp, 1.0f, lane);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int q = lane + 32 * j;
      if (q < chunks) {
        float out[W];
#pragma unroll
        for (int i = 0; i < W; ++i) out[i] = __fadd_rn(__fmul_rn(gp, uu[j][i]), dc[j][i]);
        g2v_st_floats(d_center + o + q * W, out);
      }
    }
    if (lane == 0) loss_neg[e] = loss;
    __syncwarp();  // vs is read above before the next example stages its v
  }
  __syncthreads();
  for (int r = warp; r < kHot; r += kWarps) {  // one flush a touched slot
    const float* slot = hot + r * D1;
    if (slot[D] != 0.0f) {
      g2v_add_row(acc + static_cast<size_t>(r) * D1, D1, lane, [&](int d) { return slot[d]; });
    }
  }
}

// Any D and alignment: lanes stride over the columns; v, then each draw's
// g and id, in dynamic shared memory ((D + 2K) words a warp).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    per_example_elems_kernel(const float* __restrict__ v, const float* __restrict__ u,
                             const float* __restrict__ g_pos, const int* __restrict__ contexts,
                             const int* __restrict__ negs, const T* __restrict__ ctx,
                             float* __restrict__ loss_neg, float* __restrict__ d_center,
                             float* __restrict__ acc, int E, int K, int D) {
  extern __shared__ float g2v_k5_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= E) return;  // warp-uniform; no block-wide barrier below
  float* vs = g2v_k5_smem + static_cast<size_t>(warp) * (D + 2 * K);
  float* gk = vs + D;
  int* nk = reinterpret_cast<int*>(gk + K);
  const size_t o = static_cast<size_t>(e) * D;
  for (int d = lane; d < D; d += 32) vs[d] = v[o + d];
  __syncwarp();
  const int c = contexts[e];
  float loss = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int n = negs[static_cast<size_t>(e) * K + k];
    const T* cr = ctx + static_cast<size_t>(n) * D;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(vs[d], g2v_ld(cr + d), s);
    s = g2v_warp_sum(s);  // every lane holds the sum
    const float mask = (n != c) ? 1.0f : 0.0f;
    loss += mask * g2v_softplus(s);
    if (lane == 0) {
      gk[k] = g2v_sigmoid(s) * mask;
      nk[k] = n;
    }
  }
  __syncwarp();
  const float gp = g_pos[e];
  for (int d = lane; d < D; d += 32) {
    float sum = 0.0f;
    for (int k = 0; k < K; ++k) {
      sum = fmaf(gk[k], g2v_ld(ctx + static_cast<size_t>(nk[k]) * D + d), sum);
    }
    d_center[o + d] = __fadd_rn(__fmul_rn(gp, u[o + d]), sum);
  }
  for (int k = 0; k < K; ++k) {
    if (nk[k] != c) add_payload(acc, nk[k], D, vs, gk[k], 1.0f, lane);
  }
  add_payload(acc, c, D, vs, gp, 1.0f, lane);
  if (lane == 0) loss_neg[e] = loss;
}

// A persistent grid: the SM count times the kernel's occupancy (asked
// once per instantiation), each block over per_block examples.
template <typename T, int KB>
int launch_chunks(const float* v, const float* u, const float* g_pos, const int* contexts,
                  const int* negs, const T* ctx, float* loss_neg, float* d_center, float* acc,
                  int E, int K, int D, cudaStream_t s) {
  static int occupancy = 0;
  if (occupancy == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, per_example_chunks_kernel<T, KB>,
                                                      kThreads, 0) != cudaSuccess ||
        n < 1) {
      n = 1;
    }
    occupancy = n;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long slots = static_cast<long long>(sms) * occupancy;
  const int per_block = static_cast<int>((E + slots - 1) / slots);
  const int blocks = (E + per_block - 1) / per_block;
  per_example_chunks_kernel<T, KB><<<blocks, kThreads, 0, s>>>(
      v, u, g_pos, contexts, negs, ctx, loss_neg, d_center, acc, E, K, D, per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_per_example(const float* v, const float* u, const float* g_pos,
                       const int* contexts, const int* negs, const T* ctx,
                       float* loss_neg, float* d_center, float* acc, int E,
                       int K, int D, cudaStream_t stream) {
  constexpr int W = G2vChunk<T>::kElems;
  if (D % W == 0 && D <= kMaxD && g2v_aligned16(ctx) && g2v_aligned16(v) && g2v_aligned16(u) &&
      g2v_aligned16(d_center)) {
#define G2V_K5_CASE(KB)                                                                    \
  case KB:                                                                                 \
    return launch_chunks<T, KB>(v, u, g_pos, contexts, negs, ctx, loss_neg, d_center, acc, \
                                E, K, D, stream);
    switch (K < kMaxKB ? K : kMaxKB) {
      G2V_K5_CASE(1)
      G2V_K5_CASE(2)
      G2V_K5_CASE(3)
      G2V_K5_CASE(4)
      G2V_K5_CASE(5)
      G2V_K5_CASE(6)
      G2V_K5_CASE(7)
      G2V_K5_CASE(8)
      default:
        break;  // K = 0: the element-wise kernel adds the positives alone
    }
#undef G2V_K5_CASE
  }
  const size_t smem = static_cast<size_t>(kWarps) * (D + 2 * K) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        per_example_elems_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  per_example_elems_kernel<T><<<(E + kWarps - 1) / kWarps, kThreads, smem, stream>>>(
      v, u, g_pos, contexts, negs, ctx, loss_neg, d_center, acc, E, K, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

G2V_EXPORT int k5_per_example(const float* v, const float* u, const float* g_pos,
                              const int* contexts, const int* negs,
                              const void* ctx, float* loss_neg, float* d_center,
                              float* acc_ctx, int E, int K, int D, int bf16,
                              void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_per_example(v, u, g_pos, contexts, negs,
                              static_cast<const __nv_bfloat16*>(ctx), loss_neg,
                              d_center, acc_ctx, E, K, D, s);
  return launch_per_example(v, u, g_pos, contexts, negs, static_cast<const float*>(ctx),
                            loss_neg, d_center, acc_ctx, E, K, D, s);
}
