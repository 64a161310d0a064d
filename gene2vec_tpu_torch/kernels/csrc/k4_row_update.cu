// K4 — (V, D+1) accumulators and the combiner finalize over the rows a
// step touched, both tables.
//
// Replaces: gene2vec_tpu/sgns/step.py:229-263 (_scatter_accumulator,
// _finalize_row_updates) with _row_divisor (:143-172), as used by
// _step_stratified at :800-851: [grad | weight] rows scatter-add by token
// id into a zeroed (V, D+1) float32 accumulator — centers take
// [d_center | 1] into acc_emb, contexts take [g_pos*v | 1] into acc_ctx,
// which already holds K2's head rows and K3's tail blocks — then
// table -= lr * acc[:, :D] / divisor(acc[:, D]), divisor = 1 (sum),
// max(w, 1) (mean) or max(max(w, 1)/32, 1) (capped).
//
// Which rows.  The reference finalizes every row; a row no producer wrote
// has acc = +0 and keeps its bits (t - lr*(+0/div) = t, -0 kept; a bf16
// row has zero low bits under either rounding, step.py:186-193).  So the
// finalize visits only the rows a step touched: in row_update those its
// scatter visits (centers, contexts) plus the ones the caller names
// (G2vRowSet: up to two id lists, the prefix [0, prefix), blocks
// [start_g, start_g + S) with start_g =
// min(prefix + blocks[g]*S, limit - S), and Huffman path nodes
// points[t, l] for l < lengths[t]).  The callers' sets, checked against
// every producer's writes (each adds into the zeroed accumulator with
// float atomics, so an acc element is never -0, the one value whose skip
// would not be exact):
//   stratified  emb: centers                 ctx: contexts, [0, H) (K2), the
//               (row_update)                      drawn blocks (K3)
//   per_example emb: centers                 ctx: contexts, negs (K5a; a
//               (scatter_rows then                draw equal to the context
//                finalize_rows with ids)          writes nothing)
//   shared      emb: centers                 ctx: contexts, the pool (K5b)
//   sg/cbow_hs  input: inputs                node: [0, Ns) (K6's dense
//                                                 shallow phase), points
//                                                 [targets, l < lengths]
//                                                 (K6's deep phase)
// A row outside the set whose accumulator is not +0 would be skipped
// wrongly; the CPU tests hold each objective's step against the reference
// with exactly these sets, and chip_smoke.py checks the +0 invariant on
// the card.
//
// Marking: a call flags its rows in a workspace of V uint32 flags (and
// two barrier counters) with a generation g from the wrapper, one higher
// each call (the flags zeroed when it wraps), and finalizes them before it
// returns: no marks pass from one call to the next, so a workspace that
// is new or reused only costs its zeroed flags.  row_update's launch 1
// stores g at each row it scatters into and at the caller's rows; launch 2
// visits every row whose flag is g, each once: a row is one lane of one
// scan unit, so duplicates, overlapping ranges and rows both scattered and
// named are visited once.  Flags of earlier generations count as clean,
// so no pass clears them and the next call needs no memset.  The generic
// finalize_rows gets all its rows from the caller (the scattered ids
// among them) in its own launch: the grid stores their flags (one lane of
// a warp's lanes naming a row stores it: hot noise rows are named
// thousands of times), meets at a grid-wide barrier (a cooperative launch,
// so every block is resident), then scans; asked for every row, it gets
// no workspace and scans every row unflagged, with no marking and no
// barrier.  row_update asked for every row of a table flags them all in
// launch 1.  A flag check per row, not a compacted row list:
// the check reads 4 bytes a row (98 KB at V = 24,447, ~0.03 us of the
// card's bandwidth) and hands each warp its rows with no contended
// counter; a list needs one counter that every marking thread appends
// through, and a reset ordered after its last reader.
//
// Bound on the H100: bytes — each touched row's accumulator read and its
// table row read and written (2,404 B a float32 row at D = 200, 1,204 B
// bfloat16), the flags, and the scatter's payload reads and atomics.
//
// Design: two launches for row_update, one each for the generic entries.
// Launch 1 scatters (one warp per example; float4 atomics on each
// accumulator row's 16-byte aligned middle, scalar ones at its ends:
// rows are D + 1 floats apart) and marks.  The finalize is a persistent
// grid (sized from the SM count and the kernel's occupancy, never from a
// count read back) whose warps stride over scan units of 4 rows, each
// warp loading its next unit's flags before it finalizes the current
// unit's flagged rows, 4 at a time (2 where a row takes two rounds of 32
// words).  Every load of those rows is issued before the arithmetic and
// the stores: 16-byte table words, the accumulator through its 16-byte
// aligned words with non-coherent, no-L1-allocate loads (lanes pass the
// word that straddles their neighbour's elements by shuffle), the
// weights.  The update is t - lr*(a/div) with correctly rounded division,
// multiply and subtract (no FMA contraction), as the reference writes it;
// a / 1 = a, so rows whose divisor is 1 skip the division.  Rows whose
// width is not a whole number of 16-byte table words (D % 4 for float32,
// D % 8 for bfloat16) take a per-element path.  (Staging a warp's rows
// through shared memory with cp.async, 8 rows in flight a warp, measured
// slower than these registers.)
//
// bfloat16 tables (step.py:179-226, 248-263): the finalize reads the table
// element as float32, computes new = t - lr*(a/div) in float32 in the
// reference's order, and writes it back either by stochastic rounding
// (the reference's salted murmur-finalizer hash of the element's flat
// index r*D + c, bit for bit in wrapping uint32 arithmetic: add the low
// 16 hash bits below the bf16 mantissa, truncate) or by round-to-nearest-
// even (__float2bfloat16_rn, XLA's astype).  Each table's two salt words
// come from the caller.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // the scatters' blocks
constexpr int kFinThreads = 128;  // the finalize's blocks
constexpr int kFinBlocks = 3;     // ... and its least resident blocks an SM

// Rows a warp keeps in flight in the finalize: 4, or 2 where each row
// takes two rounds of 32 words (the same bytes in flight, fewer registers).
template <int kRounds>
constexpr int kRowsOf = kRounds == 2 ? 2 : 4;

// How a finalized float32 value goes back into a bfloat16 table: sr = 1
// stochastic rounding with salts (s0, s1), sr = 0 nearest-even.  Ignored
// for a float32 table.
struct WriteBack {
  int sr;
  uint32_t s0, s1;
};

}  // namespace

// Rows of one table a finalize visits besides the ones row_update
// scatters into (the same layout as row_update.py's ctypes structure).
// Items, in order: n_ids0 ids0, n_ids1 ids1; the prefix rows; n_blocks
// blocks of `block` rows; n_targets paths of path_len entries.
struct G2vRowSet {
  const int* ids0;
  const int* ids1;
  long long n_ids0, n_ids1;
  int prefix;
  const int* blocks;
  int n_blocks, block, limit;
  const int* points;
  const int* lengths;
  const int* targets;
  int n_targets, path_len;
};

namespace {

__host__ __device__ __forceinline__ long long set_items(const G2vRowSet& s) {
  return s.n_ids0 + s.n_ids1 + s.prefix + static_cast<long long>(s.n_blocks) * s.block +
         static_cast<long long>(s.n_targets) * s.path_len;
}

// The row of item i in [0, set_items(s)), or -1 (a path entry past its
// path's length).
__device__ __forceinline__ int set_row(const G2vRowSet& s, long long i) {
  if (i < s.n_ids0) return s.ids0[i];
  i -= s.n_ids0;
  if (i < s.n_ids1) return s.ids1[i];
  i -= s.n_ids1;
  if (i < s.prefix) return static_cast<int>(i);
  i -= s.prefix;
  const long long nb = static_cast<long long>(s.n_blocks) * s.block;
  if (i < nb) {
    const long long g = i / s.block;
    const long long start = min(static_cast<long long>(s.prefix) +
                                    static_cast<long long>(s.blocks[g]) * s.block,
                                static_cast<long long>(s.limit) - s.block);
    return static_cast<int>(start + i % s.block);
  }
  i -= nb;
  const int t = s.targets[i / s.path_len];
  const int l = static_cast<int>(i % s.path_len);
  return l < min(s.lengths[t], s.path_len)
             ? s.points[static_cast<size_t>(t) * s.path_len + l]
             : -1;
}

// One table's finalize: its workspace flags and generation (no flags:
// every row); `set` is flagged in this launch.
template <typename T>
struct Job {
  T* table;
  const float* acc;
  unsigned* flags;
  unsigned gen;
  WriteBack wb;
  G2vRowSet set;
};

// step.py:206-209, wrapping uint32 arithmetic
__device__ __forceinline__ uint32_t sr_hash(uint32_t flat, uint32_t s0, uint32_t s1) {
  uint32_t h = (flat ^ s0) * 0x9E3779B1u;
  h = (h ^ (h >> 15)) * 0x85EBCA6Bu;
  return (h ^ (h >> 13)) + s1;
}

// bfloat16 bits of float32 x under the write-back
__device__ __forceinline__ unsigned short bf16_bits(float x, uint32_t flat,
                                                    const WriteBack& w) {
  if (w.sr) {
    const uint32_t h = sr_hash(flat, w.s0, w.s1);
    return static_cast<unsigned short>(((__float_as_uint(x) + (h & 0xFFFFu)) & 0xFFFF0000u) >>
                                       16);
  }
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* t, size_t i, float x, const WriteBack&) {
  t[i] = x;
}

__device__ __forceinline__ void store(__nv_bfloat16* t, size_t i, float x,
                                      const WriteBack& w) {
  t[i] = __ushort_as_bfloat16(bf16_bits(x, static_cast<uint32_t>(i), w));
}

// The accumulator is read once: non-coherent loads that skip L1.
__device__ __forceinline__ float ld_once(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float4 ld_once4(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 shfl_down4(const float4& v) {
  return make_float4(__shfl_down_sync(0xffffffffu, v.x, 1), __shfl_down_sync(0xffffffffu, v.y, 1),
                     __shfl_down_sync(0xffffffffu, v.z, 1), __shfl_down_sync(0xffffffffu, v.w, 1));
}

// combiner: 0 = sum, 1 = mean, 2 = capped (cap 32)
__device__ __forceinline__ float row_divisor(float w, int combiner) {
  w = fmaxf(w, 1.0f);
  if (combiner == 0) return 1.0f;
  if (combiner == 1) return w;
  return fmaxf(w / 32.0f, 1.0f);
}

// a / 1 is a, bit for bit: the division is skipped on the rows whose
// divisor is 1 (every row under "sum", the rows of at most 32 example
// units under "capped").
__device__ __forceinline__ float update(float t, float a, float div, float lr) {
  return __fsub_rn(t, __fmul_rn(lr, div == 1.0f ? a : __fdiv_rn(a, div)));
}

// acc_row += [payload(d) for d < D | w]: float4 atomics on the row's
// 16-byte aligned middle, scalar ones at its ends.
template <class Payload>
__device__ __forceinline__ void add_row(float* arow, int D, const Payload& payload, float w,
                                        int lane) {
  const int head =
      min(D, static_cast<int>((16 - reinterpret_cast<uintptr_t>(arow) % 16) % 16) / 4);
  const int body = (D - head) & ~3;
  if (lane < head) atomicAdd(arow + lane, payload(lane));
  for (int d = head + 4 * lane; d < head + body; d += 128) {
    atomicAdd(reinterpret_cast<float4*>(arow + d),
              make_float4(payload(d), payload(d + 1), payload(d + 2), payload(d + 3)));
  }
  for (int d = head + body + lane; d < D; d += 32) atomicAdd(arow + d, payload(d));
  if (lane == 0) atomicAdd(arow + D, w);
}

// Launch 1 of row_update: blocks [0, sb) scatter, one warp per example;
// the rest store the generations at the caller's rows, emb's then ctx's.
// (A check of the flags' pointer here, for tables finalized without
// flags, made this launch 1.75x as long in the default step on the H100:
// row_update always has both workspaces.)
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(float* __restrict__ acc_emb, float* __restrict__ acc_ctx,
                   const int* __restrict__ centers, const int* __restrict__ contexts,
                   const float* __restrict__ d_center, const float* __restrict__ v,
                   const float* __restrict__ g_pos, int E, int D, int sb,
                   unsigned* __restrict__ flags_emb, unsigned gen_emb, G2vRowSet set_emb,
                   unsigned* __restrict__ flags_ctx, unsigned gen_ctx, G2vRowSet set_ctx) {
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) >= sb) {
    // one lane of a warp's lanes naming a row stores its flag
    const long long i = static_cast<long long>(blockIdx.x - sb) * kThreads + threadIdx.x;
    const long long ne = set_items(set_emb), nc = set_items(set_ctx);
    const int r = i < ne ? set_row(set_emb, i) : i - ne < nc ? set_row(set_ctx, i - ne) : -1;
    const int side = i < ne ? 0 : 1;
    const unsigned peers = __match_any_sync(0xffffffffu, r * 2 + side);
    if (r >= 0 && __ffs(peers) - 1 == lane) {
      if (side == 0) {
        flags_emb[r] = gen_emb;
      } else {
        flags_ctx[r] = gen_ctx;
      }
    }
    return;
  }
  const int e = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (e >= E) return;  // warp-uniform
  const int D1 = D + 1;
  const int c = centers[e], x = contexts[e];
  // the rows' flags, read now and stored after the adds where not yet set
  // (a hot row is scattered into by hundreds of examples)
  const unsigned fe = lane == 0 ? __ldcg(flags_emb + c) : gen_emb;
  const unsigned fc = lane == 0 ? __ldcg(flags_ctx + x) : gen_ctx;
  const float* dc = d_center + static_cast<size_t>(e) * D;
  const float* vr = v + static_cast<size_t>(e) * D;
  const float gp = g_pos[e];
  add_row(acc_emb + static_cast<size_t>(c) * D1, D, [&](int d) { return dc[d]; }, 1.0f, lane);
  add_row(acc_ctx + static_cast<size_t>(x) * D1, D, [&](int d) { return __fmul_rn(gp, vr[d]); },
          1.0f, lane);
  if (fe != gen_emb) flags_emb[c] = gen_emb;
  if (fc != gen_ctx) flags_ctx[x] = gen_ctx;
}

__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(float* __restrict__ acc, const int* __restrict__ idx,
                        const float* __restrict__ grads, const float* __restrict__ weights,
                        int R, int D) {
  const int r = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // warp-uniform
  const int id = idx[r];
  const float* gr = grads + static_cast<size_t>(r) * D;
  add_row(acc + static_cast<size_t>(id) * (D + 1), D, [&](int d) { return gr[d]; }, weights[r],
          lane);
}

// Elements of T in a 16-byte table word, and their float32 values.
template <typename T>
struct TableWord {
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ float word_elem(const uint4& w, int j, const float*) {
  const unsigned u = j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
  return __uint_as_float(u);
}

__device__ __forceinline__ float word_elem(const uint4& w, int j, const __nv_bfloat16*) {
  const int k = j >> 1;
  const unsigned u = k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
  return __uint_as_float((j & 1) ? (u & 0xFFFF0000u) : (u << 16));
}

// The rows rows[q] >= 0 (warp-uniform) finalized: every load of kRounds
// rounds of 32 words issued first, then the arithmetic and the stores.
template <typename T, int kRounds, int kRows = kRowsOf<kRounds>>
__device__ __forceinline__ void finalize_vec(const Job<T>& j, const int (&rows)[kRows], int D,
                                             float lr, int combiner, int lane) {
  constexpr int W = TableWord<T>::kElems;  // table elements a word
  constexpr int A = W / 4;                 // accumulator float4 words a table word
  const int nw = D / W;
  const int D1 = D + 1;
  float div[kRows];
  int shift[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const float* arow = j.acc + static_cast<size_t>(rows[q] < 0 ? 0 : rows[q]) * D1;
    div[q] = rows[q] >= 0 ? ld_once(arow + D) : 0.0f;
    shift[q] = static_cast<int>((reinterpret_cast<uintptr_t>(arow) >> 2) & 3);
  }
  for (int w0 = 0; w0 < nw; w0 += 32 * kRounds) {
    uint4 tw[kRows][kRounds];
    float4 c[kRows][kRounds][A + 1];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const size_t r = static_cast<size_t>(rows[q] < 0 ? 0 : rows[q]);
      const float4* base =
          reinterpret_cast<const float4*>((j.acc + r * D1) - shift[q]);  // 16-byte aligned
      const uint4* trow = reinterpret_cast<const uint4*>(j.table + r * D);
#pragma unroll
      for (int k = 0; k < kRounds; ++k) {
        const int w = w0 + 32 * k + lane;
        const bool live = rows[q] >= 0 && w < nw;
        tw[q][k] = live ? __ldcg(trow + w) : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int a = 0; a < A; ++a) {
          c[q][k][a] = live ? ld_once4(base + w * A + a) : make_float4(0, 0, 0, 0);
        }
        // the word after this lane's: its own load at the end of a round
        // or of the row, else the next lane's first word
        const bool own = live && (lane == 31 || w == nw - 1);
        c[q][k][A] = own ? ld_once4(base + (w + 1) * A) : make_float4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int k = 0; k < kRounds; ++k) {
        const float4 next = shfl_down4(c[q][k][0]);
        const int w = w0 + 32 * k + lane;
        if (!(lane == 31 || w == nw - 1)) c[q][k][A] = next;
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (rows[q] < 0) continue;  // warp-uniform
      const float dv = row_divisor(div[q], combiner);
      const int s = shift[q];
      const size_t r = static_cast<size_t>(rows[q]);
#pragma unroll
      for (int k = 0; k < kRounds; ++k) {
        const int w = w0 + 32 * k + lane;
        if (w >= nw) continue;
        float x[W];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          // accumulator element e of this word: position s + e of c
          const float a0 = comp(c[q][k][e / 4], e % 4);
          const float a1 = comp(c[q][k][(e + 1) / 4], (e + 1) % 4);
          const float a2 = comp(c[q][k][(e + 2) / 4], (e + 2) % 4);
          const float a3 = comp(c[q][k][(e + 3) / 4], (e + 3) % 4);
          const float a = s == 0 ? a0 : s == 1 ? a1 : s == 2 ? a2 : a3;
          x[e] = update(word_elem(tw[q][k], e, j.table), a, dv, lr);
        }
        uint4 out;
        if constexpr (sizeof(T) == 4) {
          out = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                           __float_as_uint(x[3]));
        } else {
          unsigned h[W];
          const uint32_t flat = static_cast<uint32_t>(r * D + static_cast<size_t>(w) * W);
#pragma unroll
          for (int e = 0; e < W; ++e) h[e] = bf16_bits(x[e], flat + e, j.wb);
          out = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                           h[6] | (h[7] << 16));
        }
        *reinterpret_cast<uint4*>(j.table + r * D + static_cast<size_t>(w) * W) = out;
      }
    }
  }
}

// Rows whose width is not a whole number of 16-byte words: lanes over
// the elements, a row at a time.
template <typename T, int kRows>
__device__ __forceinline__ void finalize_elems(const Job<T>& j, const int (&rows)[kRows], int D,
                                               float lr, int combiner, int lane) {
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    if (rows[q] < 0) continue;
    const float* arow = j.acc + static_cast<size_t>(rows[q]) * (D + 1);
    const float dv = row_divisor(ld_once(arow + D), combiner);
    const size_t base = static_cast<size_t>(rows[q]) * D;
    for (int d = lane; d < D; d += 32) {
      store(j.table, base + d, update(g2v_ld(j.table + base + d), ld_once(arow + d), dv, lr),
            j.wb);
    }
  }
}

// kRounds: 0 the per-element path, else rounds of 32 words loaded at once.
template <typename T, int kRounds, int kRows = kRowsOf<kRounds>>
__device__ __forceinline__ void finalize_batch(const Job<T>& j, const int (&rows)[kRows], int D,
                                               float lr, int combiner, int lane) {
  if constexpr (kRounds == 0) {
    finalize_elems(j, rows, D, lr, combiner, lane);
  } else {
    finalize_vec<T, kRounds>(j, rows, D, lr, combiner, lane);
  }
}

// The flagged rows among this lane's `row` (flag `f`), kRows at a time.
template <typename T, int kRounds>
__device__ __forceinline__ void finalize_flagged(const Job<T>& j, int row, unsigned f, int D,
                                                 float lr, int combiner, int lane) {
  constexpr int kRows = kRowsOf<kRounds>;
  unsigned mask = __ballot_sync(0xffffffffu, row >= 0 && f == j.gen);
  while (mask) {  // warp-uniform
    int rows[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int src = mask ? __ffs(mask) - 1 : 0;
      const int r = __shfl_sync(0xffffffffu, row, src);
      rows[q] = mask ? r : -1;
      mask &= mask - 1;
    }
    finalize_batch<T, kRounds>(j, rows, D, lr, combiner, lane);
  }
}

// Scan unit k of a job, 4 rows: lanes 0-3 take a row each and its flag
// (a job without flags: the generation, every row flagged); the load
// stays in flight until finalize_flagged compares it.
template <typename T>
__device__ __forceinline__ unsigned scan_flag(const Job<T>& j, long long k, int V, int lane,
                                              int& row) {
  row = static_cast<int>(4 * k) + lane;
  if (lane >= 4 || row >= V) row = -1;
  if (row < 0) return 0u;
  return j.flags != nullptr ? __ldcg(j.flags + row) : j.gen;
}

// All blocks of the (cooperative) launch past this point before any goes
// on; bar[0] counts arrivals, bar[1] departures (grid_depart).
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned*>(bar) < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// The last block out zeroes both counters for the next launch.
__device__ __forceinline__ void grid_depart(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
    bar[0] = 0;
    bar[1] = 0;
  }
}

// The caller's rows of job j flagged by the whole grid; of a warp's lanes
// naming one row, one stores its flag (a row drawn many times, as hot
// noise rows are, is not stored to by every lane that names it).
template <typename T>
__device__ __forceinline__ void mark_set(const Job<T>& j, int lane) {
  const long long n = set_items(j.set);
  const long long stride = static_cast<long long>(gridDim.x) * kFinThreads;
  for (long long i0 = static_cast<long long>(blockIdx.x) * kFinThreads + (threadIdx.x & ~31);
       i0 < n; i0 += stride) {
    const long long i = i0 + lane;
    const int r = i < n ? set_row(j.set, i) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    if (r >= 0 && __ffs(peers) - 1 == lane) j.flags[r] = j.gen;
  }
}

// The finalize of one or two tables (njobs).  With `bar` (finalize_rows
// given rows of its own) the grid first flags those rows and meets at a
// barrier; then warps stride over both jobs' scan units, each loading its
// next unit's flags before it finalizes the current unit's rows.
// At least kFinBlocks resident blocks an SM (at most 170 registers a
// thread): left to itself, the compiler gave the bfloat16 one-round
// instantiation 193 registers, two blocks an SM, and the default bf16
// step's finalize took 1.4x as long on the H100.
template <typename T, int kRounds>
__global__ void __launch_bounds__(kFinThreads, kFinBlocks)
    finalize_kernel(Job<T> j0, Job<T> j1, int njobs, int V, int D, float lr, int combiner,
                    unsigned* bar) {
  const int lane = threadIdx.x & 31;
  if (bar != nullptr) {
    mark_set(j0, lane);
    grid_barrier(bar);
  }
  const long long warps = (static_cast<long long>(gridDim.x) * kFinThreads) >> 5;
  const long long scan = (V + 3) / 4;
  const long long total = scan * njobs;
  long long u = (static_cast<long long>(blockIdx.x) * kFinThreads + threadIdx.x) >> 5;
  const auto flag_at = [&](long long k, int& row) {
    if (k >= total) {
      row = -1;
      return 0u;
    }
    return k < scan ? scan_flag(j0, k, V, lane, row) : scan_flag(j1, k - scan, V, lane, row);
  };
  int row;
  unsigned f = flag_at(u, row);
  for (; u < total; u += warps) {
    int next_row;
    const unsigned next_f = flag_at(u + warps, next_row);
    if (u < scan) {
      finalize_flagged<T, kRounds>(j0, row, f, D, lr, combiner, lane);
    } else {
      finalize_flagged<T, kRounds>(j1, row, f, D, lr, combiner, lane);
    }
    row = next_row;
    f = next_f;
  }
  if (bar != nullptr) grid_depart(bar);
}

// Resident blocks a multiprocessor holds of a finalize instantiation
// (once per library: this function has internal linkage).
template <typename T, int kRounds>
int finalize_occupancy() {
  static int blocks = 0;
  if (blocks == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, finalize_kernel<T, kRounds>,
                                                      kFinThreads, 0) != cudaSuccess ||
        n < 1) {
      n = 1;
    }
    blocks = n;
  }
  return blocks;
}

// `bar` (finalize_rows with rows of its own): a cooperative launch, so
// that every block is resident at the barrier.
template <typename T, int kRounds>
int launch_finalize_as(const Job<T>& j0, const Job<T>& j1, int njobs, int V, int D, float lr,
                       int combiner, unsigned* bar, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long units = (V + 3) / 4 * static_cast<long long>(njobs);
  const long long want = (units + kFinThreads / 32 - 1) / (kFinThreads / 32);
  const long long grid =
      std::max(1LL, std::min(want, static_cast<long long>(sms) * finalize_occupancy<T, kRounds>()));
  if (bar == nullptr) {
    finalize_kernel<T, kRounds><<<static_cast<unsigned>(grid), kFinThreads, 0, s>>>(
        j0, j1, njobs, V, D, lr, combiner, bar);
    return static_cast<int>(cudaGetLastError());
  }
  Job<T> a0 = j0, a1 = j1;
  void* args[] = {&a0, &a1, &njobs, &V, &D, &lr, &combiner, &bar};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      finalize_kernel<T, kRounds>, dim3(static_cast<unsigned>(grid)), dim3(kFinThreads), args,
      0, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Whole 16-byte table words (the table base is 16-byte aligned, which the
// wrapper checks): one round of 32 words, or two; else per element.
template <typename T>
int launch_finalize(const Job<T>& j0, const Job<T>& j1, int njobs, int V, int D, float lr,
                    int combiner, unsigned* bar, cudaStream_t s) {
  constexpr int W = TableWord<T>::kElems;
  if (D % W != 0) return launch_finalize_as<T, 0>(j0, j1, njobs, V, D, lr, combiner, bar, s);
  if (D / W <= 32) return launch_finalize_as<T, 1>(j0, j1, njobs, V, D, lr, combiner, bar, s);
  return launch_finalize_as<T, 2>(j0, j1, njobs, V, D, lr, combiner, bar, s);
}

const G2vRowSet kNoRows{};

}  // namespace

// acc[idx[r]] += [grads[r] | weights[r]] for R rows.
G2V_EXPORT int k4_scatter_rows(float* acc, const int* idx, const float* grads,
                               const float* weights, int R, int D, void* stream) {
  if (R == 0) return 0;
  const long long blocks = (static_cast<long long>(R) * 32 + kThreads - 1) / kThreads;
  scatter_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(acc, idx, grads, weights, R, D);
  return static_cast<int>(cudaGetLastError());
}

// Finalizes the rows of *set in `table` (V, D), flagged with `gen` in
// `flags` (V + 2 words: the rows', then the barrier's two counters), or
// every row where `flags` is null (*set then empty); bf16 / sr: the
// table's type and write-back, (s0, s1) its salts.
G2V_EXPORT int k4_finalize_rows(void* table, const float* acc, float lr, int combiner, int V,
                                int D, int bf16, int sr, uint32_t s0, uint32_t s1,
                                unsigned* flags, unsigned gen, const G2vRowSet* set,
                                void* stream) {
  if (static_cast<size_t>(V) * D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WriteBack wb{sr, s0, s1};
  // rows to flag: the cooperative launch with its barrier; none (an empty
  // set, or every row unflagged): a plain launch
  unsigned* bar = flags != nullptr && set_items(*set) > 0 ? flags + V : nullptr;
  if (bf16) {
    const Job<__nv_bfloat16> j{static_cast<__nv_bfloat16*>(table), acc, flags, gen, wb, *set};
    return launch_finalize(j, j, 1, V, D, lr, combiner, bar, s);
  }
  const Job<float> j{static_cast<float*>(table), acc, flags, gen, wb, *set};
  return launch_finalize(j, j, 1, V, D, lr, combiner, bar, s);
}

// Launch 1 scatters E examples into both accumulators and flags their
// rows and the rows of *set_emb / *set_ctx; launch 2 finalizes the
// flagged rows of both tables.
// bf16 / sr as k4_finalize_rows; (s0e, s1e) salt emb's write-back,
// (s0c, s1c) ctx's.
G2V_EXPORT int k4_row_update(void* emb, void* ctx, float* acc_emb, float* acc_ctx,
                             const int* centers, const int* contexts, const float* d_center,
                             const float* v, const float* g_pos, float lr, int combiner, int E,
                             int V, int D, int bf16, int sr, uint32_t s0e, uint32_t s1e,
                             uint32_t s0c, uint32_t s1c, unsigned* flags_emb, unsigned gen_emb,
                             const G2vRowSet* set_emb, unsigned* flags_ctx, unsigned gen_ctx,
                             const G2vRowSet* set_ctx,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long marks = set_items(*set_emb) + set_items(*set_ctx);
  const long long sb = (static_cast<long long>(E) * 32 + kThreads - 1) / kThreads;
  const long long mb = (marks + kThreads - 1) / kThreads;
  if (sb + mb > 0) {
    scatter_kernel<<<static_cast<unsigned>(sb + mb), kThreads, 0, s>>>(
        acc_emb, acc_ctx, centers, contexts, d_center, v, g_pos, E, D, static_cast<int>(sb),
        flags_emb, gen_emb, *set_emb, flags_ctx, gen_ctx, *set_ctx);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (static_cast<size_t>(V) * D == 0) return 0;
  const WriteBack we{sr, s0e, s1e}, wc{sr, s0c, s1c};
  if (bf16) {
    const Job<__nv_bfloat16> je{static_cast<__nv_bfloat16*>(emb), acc_emb, flags_emb, gen_emb,
                                we, kNoRows};
    const Job<__nv_bfloat16> jc{static_cast<__nv_bfloat16*>(ctx), acc_ctx, flags_ctx, gen_ctx,
                                wc, kNoRows};
    return launch_finalize(je, jc, 2, V, D, lr, combiner, nullptr, s);
  }
  const Job<float> je{static_cast<float*>(emb), acc_emb, flags_emb, gen_emb, we, kNoRows};
  const Job<float> jc{static_cast<float*>(ctx), acc_ctx, flags_ctx, gen_ctx, wc, kNoRows};
  return launch_finalize(je, jc, 2, V, D, lr, combiner, nullptr, s);
}
