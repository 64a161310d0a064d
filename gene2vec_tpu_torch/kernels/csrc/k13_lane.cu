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
// Offsets outside [0, 128) are clamped into the bucket.
//
// Bound on the H100: bytes.  The gather reads T once and writes out once
// (2 x 25 MB at (256, 24576) float32, ~15 us at 3.35 TB/s); the scatter
// reads T and G and writes out (75 MB, ~22 us); the offsets add 96 KB.
// The one-hot dot's D x V x 128 multiply-adds are a TPU artefact: here the
// scatter adds each contributor once (D x V adds).  So both kernels are
// streaming passes, and the design keeps many bytes in flight on every SM.
//
// Work split: a one-shot grid of 256-thread blocks, a block a tile of
// `rows` rows x one bucket's 128 columns, buckets fastest, so that the
// blocks running together read neighbouring segments of the same rows.
// The wrapper picks rows (lane.plan): the tile measured fastest at the
// probe's shape (gather 32 float32 / 64 bfloat16 rows, scatter 32), halved
// down to 8 while the grid would hold fewer than 4 tiles an SM of the card
// (its SM count), so that a small table still spreads over the SMs.  A
// block is one stage: it requests its whole tile before it waits on any of
// it, and its SM overlaps it with the other blocks it holds.  (A
// persistent ring of two chunks a block, each block an equal share of the
// bucket-rows, was slower: its blocks read far-apart rows at once.)
//
// Gather: the tile lands by 16-byte cp.async in a dense (rows, 128)
// array, in two row ranges of one commit group each; each thread forms
// 16-byte output vectors (4 float32 / 8 bfloat16 columns) from the
// permuted shared-memory elements and stores them, the first range while
// the second is still in flight.
//
// Scatter: T never enters shared memory.  Each thread requests its T
// chunks (16 bytes, one column chunk q of rows r0, r0 + 8 or 16, ...) into
// registers, and the block copies G's tile by 16-byte cp.async into rows 16
// bytes longer than the segment.  While both are in flight the block builds
// the bucket's contributor lists once, in parallel: the 128 offsets are
// grouped by __match_any_sync within each warp of 32 j's, every group
// counted by its leader; a warp scan over the columns gives each column's
// first entry; each j lands at that entry + the counts of the earlier
// warps' j's + its rank among the equal offsets of its own warp (the
// lower lanes), so every column's entries hold its j's in increasing
// order.  Then the 32 lanes of a warp take 8 rows x 4 column classes (a
// class is the place of a column's word in a 16-byte chunk, so the padded
// rows put the 32 lanes in 32 banks); a lane walks its class's entries,
// adds each column's contributors in order in float32 from 0.0f (the
// plain version's order) and writes the sum, cast to T, to an S tile.  The
// lanes of a class walk one list together, so a column of many
// contributors costs its lanes one step a contributor, without
// divergence among them.  Last, each thread adds its S chunk to its T
// chunk (0.0 for the columns no offset names, as the plain version adds)
// and stores 16 bytes.  No atomics; deterministic; bitwise the plain
// version.  A tile of at most 8 KB a tensor caps the scatter's registers
// so that 6 blocks share an SM (kScatterMinBlocks).
#include "common.cuh"

#define K13_LISTS 1    // build the contributor lists (0: each column its own j;
                       // 2: build them, then use 0's)
#define K13_SUM 1      // sum the lists (0: one read of G a column)
#define K13_PERMUTE 1  // gather through the offsets (0: a plain copy)
#define K13_GATHER_STAGES 2  // row ranges of a gather tile, 1 or 2

namespace {

constexpr int kBucket = 128;
constexpr int kThreads = 256;
constexpr int kTileBytes = 16384;  // one tensor's tile at the largest rows

template <typename T>
constexpr int kMaxRows = kTileBytes / (kBucket * static_cast<int>(sizeof(T)));

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ int bucket_offset(const int* offs, int b, int j) {
  return min(max(offs[static_cast<size_t>(8 * b) * kBucket + j], 0), kBucket - 1);
}

// This block's tile: bucket b, rows d0 .. d0 + n - 1.
struct Tile {
  int b, d0, n;
};
__device__ __forceinline__ Tile block_tile(int D, int V, int rows) {
  const int nb = V / kBucket;
  Tile t;
  t.b = blockIdx.x % nb;
  t.d0 = (blockIdx.x / nb) * rows;
  t.n = min(rows, D - t.d0);
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const T* __restrict__ table, const int* __restrict__ offs,
                   T* __restrict__ out, int D, int V, int rows) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // columns a 16-byte vector
  constexpr int kRowVecs = kBucket / kVec;
  __shared__ uint4 tile_raw[kTileBytes / 16];
  __shared__ int s_offs[kBucket];
  T* tile = reinterpret_cast<T*>(tile_raw);
  const Tile t = block_tile(D, V, rows);
  const size_t base = static_cast<size_t>(t.d0) * V + static_cast<size_t>(t.b) * kBucket;
  // the tile in K13_GATHER_STAGES row ranges, a commit group each: the
  // first range is permuted and stored while the later ones are in flight
  const int per = (t.n + K13_GATHER_STAGES - 1) / K13_GATHER_STAGES;
  for (int st = 0; st < K13_GATHER_STAGES; ++st) {
    const int r_end = min(t.n, (st + 1) * per);
    for (int i = st * per * kRowVecs + threadIdx.x; i < r_end * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs, q = i % kRowVecs;
      cp16(tile + r * kBucket + q * kVec, table + base + static_cast<size_t>(r) * V + q * kVec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (threadIdx.x < kBucket) s_offs[threadIdx.x] = bucket_offset(offs, t.b, threadIdx.x);
  for (int st = 0; st < K13_GATHER_STAGES; ++st) {
    if (st + 1 < K13_GATHER_STAGES)
      asm volatile("cp.async.wait_group %0;\n" ::"n"(K13_GATHER_STAGES - 1) : "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const int r_end = min(t.n, (st + 1) * per);
    for (int i = st * per * kRowVecs + threadIdx.x; i < r_end * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs, q = i % kRowVecs;
      uint4 v;
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        e[k] = tile[r * kBucket + (K13_PERMUTE ? s_offs[q * kVec + k] : q * kVec + k)];
      reinterpret_cast<uint4*>(out + base + static_cast<size_t>(r) * V)[q] = v;
    }
  }
}

// The bucket's contributor lists as one array of entries: a column's
// entries are its contributors j in increasing j, and the columns follow
// one another by rank (below), so that first[i] .. first[i + 1] - 1 are
// the entries of the column of rank i.  An entry packs j, c and whether it
// opens or closes its column's sum.
constexpr int kOpens = 1 << 16, kCloses = 1 << 17;

struct Lists {
  int first[kBucket + 1];  // by rank; first[kBucket] = kBucket
  int entry[kBucket];
  int col_first[kBucket], count[kBucket];  // by column
  int by_warp[4][kBucket];  // j's of warp w equal to c; then their first slot
  int warp_total[4];
};

__device__ __forceinline__ int pack_entry(int j, int c, int rank, int n) {
  return j | c << 8 | (rank == 0 ? kOpens : 0) | (rank == n - 1 ? kCloses : 0);
}

// Ranks run over the columns class-major: rank 32k + u is the u-th
// column of class k, a column's class being the place of its 4-byte word
// in a 16-byte chunk (float32: c % 4; bfloat16: (c / 2) % 4).  A sum
// warp's 32 lanes are 8 rows x the 4 classes, so that they write 32
// different banks of the S tile.
template <typename T>
__device__ __forceinline__ int column_of_rank(int i) {
  const int k = i >> 5, u = i & 31;
  return sizeof(T) == 4 ? 4 * u + k : 8 * (u >> 1) + 2 * k + (u & 1);
}

// Threads 0-127 (warps 0-3), thread j holding bucket offset o.
template <typename T>
__device__ __forceinline__ void build_lists(Lists& s, int o) {
  const int j = threadIdx.x, warp = j >> 5, lane = j & 31;
  for (int i = threadIdx.x; i < 4 * kBucket; i += kThreads) (&s.by_warp[0][0])[i] = 0;
  __syncthreads();
  unsigned lower = 0;
  if (j < kBucket) {
    const unsigned peers = __match_any_sync(0xffffffffu, o);
    lower = peers & ((1u << lane) - 1u);
    if (lower == 0) s.by_warp[warp][o] = __popc(peers);  // the group's leader
  }
  __syncthreads();
  const int c = column_of_rank<T>(j);  // thread j now stands for rank j
  int n[4], total = 0, incl = 0;
  if (j < kBucket) {
#pragma unroll
    for (int w = 0; w < 4; ++w) total += n[w] = s.by_warp[w][c];
    incl = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += x;
    }
    if (lane == 31) s.warp_total[warp] = incl;
  }
  __syncthreads();
  if (j < kBucket) {
    int start = incl - total;
    for (int w = 0; w < warp; ++w) start += s.warp_total[w];
    s.first[j] = s.col_first[c] = start;
    if (j == kBucket - 1) s.first[kBucket] = kBucket;
    s.count[c] = total;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s.by_warp[w][c] = start;
      start += n[w];
    }
  }
  __syncthreads();
  if (j < kBucket) {
    const int pos = s.by_warp[warp][o] + __popc(lower);
    s.entry[pos] = pack_entry(j, o, pos - s.col_first[o], s.count[o]);
  }
}

template <typename T>
constexpr int kWords = kBucket * static_cast<int>(sizeof(T)) / 4;  // words a row's segment
template <typename T>
constexpr int kPitch = kWords<T> + 4;  // 16-byte rows, 4 words apart in the banks

// __launch_bounds__'s least blocks an SM: 6 for tiles of at most 8 KB a
// tensor (registers capped at 40, which the card timed faster at every
// such height), else 1 (shared memory holds 5 blocks an SM; a cap bought
// nothing there).
template <typename T, int kRows>
constexpr int kScatterMinBlocks = kRows * sizeof(T) <= 64 ? 6 : 1;

template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads, (kScatterMinBlocks<T, kRows>))
lane_scatter_kernel(const T* __restrict__ table, const T* __restrict__ grads,
                    const int* __restrict__ offs, T* __restrict__ out, int D, int V) {
  constexpr int kW = kWords<T>, kP = kPitch<T>, kChunks = kW / 4;  // 16-byte chunks a row
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));            // columns a chunk
  constexpr int kStep = kThreads / kChunks;  // rows apart a thread's chunks are
  constexpr int kPer = (kRows + kStep - 1) / kStep;  // chunks a thread
  __shared__ __align__(16) uint32_t s_g[kRows * kP];  // G's tile
  __shared__ __align__(16) uint32_t s_s[kRows * kP];  // each column's sum, cast
  __shared__ Lists s;
  constexpr int rows = kRows;
  const Tile t = block_tile(D, V, rows);
  const size_t ld = static_cast<size_t>(V) * sizeof(T) / 4;  // words a table row
  const size_t base = static_cast<size_t>(t.d0) * ld + static_cast<size_t>(t.b) * kW;
  const uint32_t* gw = reinterpret_cast<const uint32_t*>(grads) + base;
  for (int i = threadIdx.x; i < t.n * kChunks; i += kThreads) {
    const int r = i / kChunks, w = 4 * (i % kChunks);
    cp16(s_g + r * kP + w, gw + r * ld + w);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // T never enters shared memory: a thread's chunks (one column chunk q,
  // rows r0, r0 + step, ...) are in flight in registers meanwhile
  const int q = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
  const uint4* tw = reinterpret_cast<const uint4*>(reinterpret_cast<const uint32_t*>(table) + base);
  uint4 tv[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int r = r0 + m * kStep;
    if (r < t.n) tv[m] = __ldg(tw + r * (ld / 4) + q);
  }
  const int o = threadIdx.x < kBucket ? bucket_offset(offs, t.b, threadIdx.x) : 0;
#if K13_LISTS
  build_lists<T>(s, o);
#else
  (void)o;
#endif
#if K13_LISTS != 1
  __syncthreads();
  if (threadIdx.x < kBucket) {
    const int c = column_of_rank<T>(threadIdx.x);
    s.first[threadIdx.x] = threadIdx.x;
    s.entry[threadIdx.x] = pack_entry(c, c, 0, 1);
    s.count[threadIdx.x] = 1;
    if (threadIdx.x == 0) s.first[kBucket] = kBucket;
  }
#endif
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // a warp: 8 rows (row group rg) x the columns of part `part`; a lane:
  // row r8 of them, the part's columns of class k
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int rgs = rows / 8, parts = 8 / rgs, span = 32 / parts;  // ranks a lane
  const int rg = warp % rgs, part = warp / rgs, k = lane & 3;
  const int lo_rank = 32 * k + part * span;
  const int r = 8 * rg + (lane >> 2);
  if (r < t.n) {
    const T* g_row = reinterpret_cast<const T*>(s_g + r * kP);
    T* s_row = reinterpret_cast<T*>(s_s + r * kP);
    const int e_hi = s.first[lo_rank + span];
    float acc = 0.0f;
    for (int e_i = s.first[lo_rank]; e_i < e_hi; ++e_i) {
      const int e = s.entry[e_i];
#if K13_SUM
      acc = ((e & kOpens) ? 0.0f : acc) + to_f32(g_row[e & 0xff]);
#else
      acc = to_f32(g_row[(e >> 8) & 0xff]);
#endif
      if (e & kCloses) s_row[(e >> 8) & 0xff] = from_f32<T>(acc);
    }
  }
  // the thread's columns that no offset names: their sum is +0.0
  unsigned none = 0;
#pragma unroll
  for (int e = 0; e < kVec; ++e) none |= (s.count[q * kVec + e] == 0) << e;
  __syncthreads();
  uint4* ow = reinterpret_cast<uint4*>(reinterpret_cast<uint32_t*>(out) + base);
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int rr = r0 + m * kStep;
    if (rr < t.n) {
      const uint4 sv = *reinterpret_cast<const uint4*>(s_s + rr * kP + 4 * q);
      const T* se = reinterpret_cast<const T*>(&sv);
      T* te = reinterpret_cast<T*>(&tv[m]);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        te[e] = from_f32<T>(to_f32(te[e]) + ((none >> e) & 1 ? 0.0f : to_f32(se[e])));
      ow[rr * (ld / 4) + q] = tv[m];
    }
  }
}

// rows: a power of two from 8 to max_rows; its log2, or -1.
int rows_log2(int rows, int max_rows) {
  for (int k = 3; (1 << k) <= max_rows; ++k)
    if (rows == 1 << k) return k;
  return -1;
}

template <typename T>
int gather(const void* table, const int* offs, void* out, int D, int V, int rows,
           cudaStream_t st) {
  if (rows_log2(rows, kMaxRows<T>) < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(V / kBucket) * ((D + rows - 1) / rows);
  lane_gather_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(table), offs,
                                                   static_cast<T*>(out), D, V, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kRows>
int scatter_rows(const void* table, const void* grads, const int* offs, void* out, int D, int V,
                 cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(V / kBucket) * ((D + kRows - 1) / kRows);
  lane_scatter_kernel<T, kRows><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(table), static_cast<const T*>(grads), offs, static_cast<T*>(out), D,
      V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scatter(const void* table, const void* grads, const int* offs, void* out, int D, int V,
            int rows, cudaStream_t st) {
  switch (rows_log2(rows, kMaxRows<T>)) {
    case 3: return scatter_rows<T, 8>(table, grads, offs, out, D, V, st);
    case 4: return scatter_rows<T, 16>(table, grads, offs, out, D, V, st);
    case 5: return scatter_rows<T, 32>(table, grads, offs, out, D, V, st);
    case 6: return scatter_rows<T, kMaxRows<T> < 64 ? 32 : 64>(table, grads, offs, out, D, V, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// table/grads/out: (D, V) row-major, V a multiple of 128, 16-byte aligned
// bases (the wrapper checks); offs: (8 * V/128, 128) int32; rows: the
// tile's rows (lane.plan), a power of two from 8 to 32 (float32) or 64
// (bfloat16).
G2V_EXPORT int k13_lane_gather(const void* table, const int* offs, void* out, int D, int V,
                               int bf16, int rows, void* stream) {
  if (D == 0 || V == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? gather<__nv_bfloat16>(table, offs, out, D, V, rows, st)
              : gather<float>(table, offs, out, D, V, rows, st);
}

G2V_EXPORT int k13_lane_scatter(const void* table, const void* grads, const int* offs,
                                void* out, int D, int V, int bf16, int rows, void* stream) {
  if (D == 0 || V == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? scatter<__nv_bfloat16>(table, grads, offs, out, D, V, rows, st)
              : scatter<float>(table, grads, offs, out, D, V, rows, st);
}
