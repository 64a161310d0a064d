// K13 — lane gather and one-hot lane scatter over a transposed (D, V)
// table in buckets of 128 columns.
//
// Replaces: experiments/test_lane_gather.py:57 (bucketed_gather) and :82
// (bucketed_scatter), the TPU probes of a row gather / scatter done along
// the lane axis: the table is stored transposed, (D, V) with V = 192
// buckets of 128 columns, and bucket b's 128 offsets are row 8b of an
// (8 * V/128, 128) int32 array (a TPU tile is 8 sublanes high).
//   gather:  out[:, 128b + j] = T[:, 128b + offs[8b, j]]
//   scatter: out[:, 128b + c] = T[:, 128b + c] + cast(sum over j with
//            offs[8b, j] == c of G[:, 128b + j])
// The Pallas scatter forms the sum as an MXU dot with a one-hot matrix,
// accumulated in float32, cast to the table's type and then added.
//
// Bound on the H100: bytes.  The gather reads T once and writes out once
// (2 x 25 MB at (256, 24576) float32, ~15 us at 3.35 TB/s); the scatter
// reads T and G and writes out (75 MB, ~22 us); the offsets add 96 KB.
// The one-hot dot's D x V x 128 multiply-adds are a TPU artefact: here the
// scatter adds each contributor once (D x V adds).
//
// Design: a block owns one bucket and a slice of rows; it stages the
// bucket's 128 offsets (clamped into the bucket) in shared memory.  A
// warp takes one row at a time: it loads the row's 128-column segment
// with 16-byte loads into shared memory (512 B at float32, 256 B at
// bfloat16), then each lane produces 4 adjacent output columns and stores
// them as one 16-byte (float32) or 8-byte (bfloat16) vector.  The scatter
// first turns the offsets into per-column contributor lists (a counting
// sort over the 128 offsets, j increasing within a column), so each
// output column sums its contributors in increasing j order in float32:
// no atomics, deterministic, and the same order as its plain version.
#include "common.cuh"

namespace {

constexpr int kBucket = 128;
constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 32;

template <typename T>
struct Vec4;  // 4 adjacent elements, stored as one vector
template <>
struct Vec4<float> {
  using Type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using Type = uint2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Bucket b's offsets into shared memory, clamped into [0, 128).
__device__ __forceinline__ void stage_offsets(const int* offs, int b, int* s_offs) {
  for (int j = threadIdx.x; j < kBucket; j += blockDim.x) {
    const int o = offs[static_cast<size_t>(8 * b) * kBucket + j];
    s_offs[j] = min(max(o, 0), kBucket - 1);
  }
}

// One row's 128-column segment of `src` into `seg` (16-byte loads).
template <typename T>
__device__ __forceinline__ void load_segment(const T* src, T* seg, int lane) {
  constexpr int kVecs = kBucket * sizeof(T) / 16;
  if (lane < kVecs)
    reinterpret_cast<uint4*>(seg)[lane] = __ldg(reinterpret_cast<const uint4*>(src) + lane);
}

template <typename T>
__global__ void lane_gather_kernel(const T* __restrict__ table, const int* __restrict__ offs,
                                   T* __restrict__ out, int D, int V) {
  __shared__ int s_offs[kBucket];
  __shared__ __align__(16) unsigned char seg_raw[kWarps * kBucket * sizeof(T)];
  auto seg = reinterpret_cast<T(*)[kBucket]>(seg_raw);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_offsets(offs, b, s_offs);
  __syncthreads();
  const int d_end = min(D, (blockIdx.y + 1) * kRowsPerBlock);
  for (int d = blockIdx.y * kRowsPerBlock + warp; d < d_end; d += kWarps) {
    const size_t base = static_cast<size_t>(d) * V + static_cast<size_t>(b) * kBucket;
    load_segment(table + base, seg[warp], lane);
    __syncwarp();
    typename Vec4<T>::Type v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = seg[warp][s_offs[4 * lane + k]];
    reinterpret_cast<typename Vec4<T>::Type*>(out + base)[lane] = v;
    __syncwarp();  // the segment is rewritten by the warp's next row
  }
}

template <typename T>
__global__ void lane_scatter_kernel(const T* __restrict__ table, const T* __restrict__ grads,
                                    const int* __restrict__ offs, T* __restrict__ out, int D,
                                    int V) {
  __shared__ int s_offs[kBucket];
  __shared__ int s_count[kBucket], s_start[kBucket], s_list[kBucket];
  __shared__ __align__(16) unsigned char seg_raw[kWarps * kBucket * sizeof(T)];
  auto seg = reinterpret_cast<T(*)[kBucket]>(seg_raw);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_offsets(offs, b, s_offs);
  __syncthreads();
  // contributor lists per output column: counts, exclusive prefix, fill
  for (int c = threadIdx.x; c < kBucket; c += blockDim.x) {
    int n = 0;
    for (int j = 0; j < kBucket; ++j) n += s_offs[j] == c;
    s_count[c] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int c = 0; c < kBucket; ++c) {
      s_start[c] = run;
      run += s_count[c];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kBucket; c += blockDim.x) {
    int k = s_start[c];
    for (int j = 0; j < kBucket; ++j)
      if (s_offs[j] == c) s_list[k++] = j;
  }
  __syncthreads();
  const int d_end = min(D, (blockIdx.y + 1) * kRowsPerBlock);
  for (int d = blockIdx.y * kRowsPerBlock + warp; d < d_end; d += kWarps) {
    const size_t base = static_cast<size_t>(d) * V + static_cast<size_t>(b) * kBucket;
    load_segment(grads + base, seg[warp], lane);
    __syncwarp();
    using V4 = typename Vec4<T>::Type;
    V4 t = __ldg(reinterpret_cast<const V4*>(table + base) + lane);
    const T* te = reinterpret_cast<const T*>(&t);
    V4 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * lane + k;
      float acc = 0.0f;
      for (int i = s_start[c]; i < s_start[c] + s_count[c]; ++i)
        acc += to_f32(seg[warp][s_list[i]]);
      e[k] = from_f32<T>(to_f32(te[k]) + to_f32(from_f32<T>(acc)));
    }
    reinterpret_cast<V4*>(out + base)[lane] = v;
    __syncwarp();
  }
}

dim3 grid_for(int D, int V) {
  return dim3(V / kBucket, (D + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// table/grads/out: (D, V) row-major, V a multiple of 128, 16-byte aligned
// bases (the wrapper checks); offs: (8 * V/128, 128) int32.
G2V_EXPORT int k13_lane_gather(const void* table, const int* offs, void* out, int D, int V,
                               int bf16, void* stream) {
  if (D == 0 || V == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    lane_gather_kernel<__nv_bfloat16><<<grid_for(D, V), kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(table), offs, static_cast<__nv_bfloat16*>(out), D,
        V);
  else
    lane_gather_kernel<float><<<grid_for(D, V), kWarps * 32, 0, st>>>(
        static_cast<const float*>(table), offs, static_cast<float*>(out), D, V);
  return static_cast<int>(cudaGetLastError());
}

G2V_EXPORT int k13_lane_scatter(const void* table, const void* grads, const int* offs,
                                void* out, int D, int V, int bf16, void* stream) {
  if (D == 0 || V == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    lane_scatter_kernel<__nv_bfloat16><<<grid_for(D, V), kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(table), static_cast<const __nv_bfloat16*>(grads),
        offs, static_cast<__nv_bfloat16*>(out), D, V);
  else
    lane_scatter_kernel<float><<<grid_for(D, V), kWarps * 32, 0, st>>>(
        static_cast<const float*>(table), static_cast<const float*>(grads), offs,
        static_cast<float*>(out), D, V);
  return static_cast<int>(cudaGetLastError());
}
