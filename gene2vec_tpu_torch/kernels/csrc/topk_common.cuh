// Tiled top-k selection shared by the serving kernels K7, K8, K9, K9r.
//
// A kernel scores `n` rows for each of B queries.  The rows are cut into
// tiles of T rows (a power of two, T >= keep); one block scores one tile
// for QB queries — one thread per row, which reads its row once with wide
// loads (16-byte float4, 4-byte dp4a words) and dots it with every query
// of the block from shared memory, so each thread keeps several loads in
// flight — keeps the scores in shared memory, sorts each query's tile
// and writes its top-`keep` (key, row) list.  Merge passes then sort
// groups of lists in shared memory until one list per query is left, and
// a finalize pass turns keys back into floats and rows into the ids the
// caller wants.  The (B, n) score matrix never reaches device memory.
//
// Order: lax.top_k's — value descending, +0 ahead of -0, -inf last, the
// lower row first among equal values.  Scores are sorted as the int32
// key bits ^ ((bits >> 31) & 0x7fffffff), whose signed order is that
// total order; a tile's rows past `n` carry the sentinel (INT_MIN,
// INT_MAX), which sorts after every real row.
//
// The sort is a bitonic network over the tile in shared memory, 256
// threads a block.  Simple and exact; a later version can select with a
// radix pass instead of sorting whole tiles.
#pragma once

#include <climits>
#include <cmath>

#include "common.cuh"

#define G2V_TOPK_THREADS 256
#define G2V_QB_MAX 8
// most (key, row) pairs one merge block sorts: 128 KB of shared memory
#define G2V_MERGE_MAX 16384

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

// Scorer interface (one struct per kernel, passed by value):
//   size_t query_bytes() const;             shared memory for one query
//   __device__ void load_queries(unsigned char* qmem, int q0, int nq) const;
//       the whole block stages queries q0..q0+nq-1 into qmem
//   __device__ void score_row(const unsigned char* qmem, int q0, int nq,
//                             int r, int* keys, int stride) const;
//       one thread scores row r for the nq queries and writes the key of
//       query j to keys[j * stride]
template <class S>
__global__ void __launch_bounds__(G2V_TOPK_THREADS)
g2v_tile_topk(S sc, int n, int B, int QB, int T, int keep, int ntiles,
              int* __restrict__ okey, int* __restrict__ oidx) {
  extern __shared__ __align__(16) unsigned char g2v_smem[];
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, B - q0);
  const int r0 = tile * T;
  int* keys = reinterpret_cast<int*>(g2v_smem);   // QB x T
  int* sk = keys + static_cast<size_t>(QB) * T;   // T
  int* si = sk + T;                               // T
  unsigned char* qmem = reinterpret_cast<unsigned char*>(si + T);
  sc.load_queries(qmem, q0, nq);
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int r = r0 + t;
    if (r < n) {
      sc.score_row(qmem, q0, nq, r, keys + t, T);
    } else {
      for (int j = 0; j < nq; ++j) keys[j * T + t] = INT_MIN;
    }
  }
  for (int j = 0; j < nq; ++j) {
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const int r = r0 + t;
      sk[t] = keys[j * T + t];
      si[t] = r < n ? r : INT_MAX;
    }
    g2v_bitonic(sk, si, T);
    const size_t base = (static_cast<size_t>(q0 + j) * ntiles + tile) * keep;
    for (int i = threadIdx.x; i < keep; i += blockDim.x) {
      okey[base + i] = sk[i];
      oidx[base + i] = si[i];
    }
  }
}

// One block merges lists [l0, l0 + G) of one query (grid: lists out x B).
__global__ void __launch_bounds__(G2V_TOPK_THREADS)
g2v_merge(const int* __restrict__ ikey, const int* __restrict__ iidx, int nin,
          int G, int keep, int M, int nout, int* __restrict__ okey,
          int* __restrict__ oidx) {
  extern __shared__ __align__(16) unsigned char g2v_smem[];
  int* sk = reinterpret_cast<int*>(g2v_smem);
  int* si = sk + M;
  const int b = blockIdx.y, o = blockIdx.x;
  const int l0 = o * G;
  const int m = min(G, nin - l0) * keep;
  const size_t in_base = (static_cast<size_t>(b) * nin + l0) * keep;
  for (int t = threadIdx.x; t < M; t += blockDim.x) {
    sk[t] = t < m ? ikey[in_base + t] : INT_MIN;
    si[t] = t < m ? iidx[in_base + t] : INT_MAX;
  }
  g2v_bitonic(sk, si, M);
  const size_t out_base = (static_cast<size_t>(b) * nout + o) * keep;
  for (int i = threadIdx.x; i < keep; i += blockDim.x) {
    okey[out_base + i] = sk[i];
    oidx[out_base + i] = si[i];
  }
}

// IdMap interface: __device__ int operator()(int b, int row) const.
struct G2vIdentity {
  __device__ int operator()(int, int row) const { return row; }
};

template <class Map>
__global__ void g2v_finalize(const int* __restrict__ key, const int* __restrict__ idx,
                             int B, int keep, Map map, float* __restrict__ out_scores,
                             int* __restrict__ out_ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * keep) return;
  out_scores[i] = g2v_unkey(key[i]);
  out_ids[i] = map(i / keep, idx[i]);
}

static inline int g2v_next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <class K>
static int g2v_smem_attr(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// Runs tile -> merges -> finalize.  Scratch: two ping-pong buffers of
// B * ceil(n / T) * keep (key, row) pairs each.  Returns a cudaError_t.
template <class S, class Map>
static int g2v_run_topk(const S& sc, const Map& map, int n, int B, int QB, int T,
                        int keep, int* ka, int* ia, int* kb, int* ib,
                        float* out_scores, int* out_ids, cudaStream_t stream) {
  const int ntiles = (n + T - 1) / T;
  const size_t tile_smem = (static_cast<size_t>(QB) * T + 2 * static_cast<size_t>(T)) * 4 +
                           static_cast<size_t>(QB) * sc.query_bytes();
  int err = g2v_smem_attr(g2v_tile_topk<S>, tile_smem);
  if (err) return err;
  dim3 grid(ntiles, (B + QB - 1) / QB);
  g2v_tile_topk<S><<<grid, G2V_TOPK_THREADS, tile_smem, stream>>>(
      sc, n, B, QB, T, keep, ntiles, ka, ia);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  int nl = ntiles;
  const int G = G2V_MERGE_MAX / keep > 2 ? G2V_MERGE_MAX / keep : 2;
  while (nl > 1) {
    const int g = nl < G ? nl : G;
    const int nout = (nl + g - 1) / g;
    const int M = g2v_next_pow2(g * keep);
    const size_t smem = 2 * static_cast<size_t>(M) * 4;
    err = g2v_smem_attr(g2v_merge, smem);
    if (err) return err;
    g2v_merge<<<dim3(nout, B), G2V_TOPK_THREADS, smem, stream>>>(
        ka, ia, nl, g, keep, M, nout, kb, ib);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    int* t = ka; ka = kb; kb = t;
    t = ia; ia = ib; ib = t;
    nl = nout;
  }
  const int total = B * keep;
  g2v_finalize<Map><<<(total + 255) / 256, 256, 0, stream>>>(
      ka, ia, B, keep, map, out_scores, out_ids);
  return static_cast<int>(cudaGetLastError());
}

// Block-wide staging of f32 query rows into shared memory, optionally
// normalized (q / max(|q|, 1e-12), the norm summed in a fixed order: each
// lane of warp j strides the row of query j, then a shuffle tree).
__device__ void g2v_stage_queries_f32(const float* __restrict__ q, int q0, int nq,
                                      int D, bool normalize, float* qs_out) {
  for (int i = threadIdx.x; i < nq * D; i += blockDim.x) {
    qs_out[i] = q[static_cast<size_t>(q0) * D + i];
  }
  if (!normalize) return;
  __syncthreads();
  __shared__ float norm[G2V_QB_MAX];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < nq; j += blockDim.x >> 5) {
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(qs_out[j * D + d], qs_out[j * D + d], s);
    s = g2v_warp_sum(s);
    if (lane == 0) norm[j] = fmaxf(__fsqrt_rn(s), 1e-12f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * D; i += blockDim.x) {
    qs_out[i] = __fdiv_rn(qs_out[i], norm[i / D]);
  }
}

// One thread's float32 dots of row `x` (D floats) with nq staged queries
// (qs, D floats each, 16-byte aligned when D % 4 == 0): float4 loads of
// the row when its width and address allow, else scalar loads; the
// queries are read from shared memory as broadcasts.
__device__ __forceinline__ void g2v_thread_dots_f32(const float* __restrict__ x,
                                                    const float* qs, int nq, int D,
                                                    float* acc) {
#pragma unroll
  for (int j = 0; j < G2V_QB_MAX; ++j) acc[j] = 0.0f;
  if ((D & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 5
    for (int c = 0; c < (D >> 2); ++c) {
      const float4 v = __ldg(x4 + c);
#pragma unroll
      for (int j = 0; j < G2V_QB_MAX; ++j) {
        if (j < nq) {
          const float4 q = reinterpret_cast<const float4*>(qs + j * D)[c];
          acc[j] = fmaf(q.x, v.x, acc[j]);
          acc[j] = fmaf(q.y, v.y, acc[j]);
          acc[j] = fmaf(q.z, v.z, acc[j]);
          acc[j] = fmaf(q.w, v.w, acc[j]);
        }
      }
    }
  } else {
    for (int d = 0; d < D; ++d) {
      const float v = __ldg(x + d);
#pragma unroll
      for (int j = 0; j < G2V_QB_MAX; ++j) {
        if (j < nq) acc[j] = fmaf(qs[j * D + d], v, acc[j]);
      }
    }
  }
}

// Staging of int8 queries: each staged f32 query (already normalized) is
// quantized per row as the reference's _quantize_queries — scale
// max(max|q| / 127, 1e-12), rint (half to even), clip to +-127.  XLA
// folds the division by the constant 127 into a product with fl(1/127),
// so the scale is that correctly rounded product; q / scale is the
// correctly rounded __fdiv_rn.  The int8 values and scales are bitwise
// the reference's.  Layout: nq*D int8, then nq
// f32 scales at the next 4-byte boundary (g2v_int8_query_bytes leaves
// room for the padding).
__device__ void g2v_stage_queries_int8(const float* __restrict__ qn, int q0, int nq,
                                       int D, signed char* qq, float* qscale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < nq; j += blockDim.x >> 5) {
    const float* row = qn + static_cast<size_t>(q0 + j) * D;
    float m = 0.0f;
    for (int d = lane; d < D; d += 32) m = fmaxf(m, fabsf(row[d]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float s = fmaxf(__fmul_rn(m, 1.0f / 127.0f), 1e-12f);
    for (int d = lane; d < D; d += 32) {
      const float v = rintf(__fdiv_rn(row[d], s));
      qq[j * D + d] = static_cast<signed char>(fminf(fmaxf(v, -127.0f), 127.0f));
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

static inline size_t g2v_int8_query_bytes(int D) {
  return static_cast<size_t>(D) + 8;
}
