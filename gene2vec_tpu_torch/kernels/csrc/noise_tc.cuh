// The noise terms on tensor cores: K2 (the stratified step's exact head),
// K3 (its tail blocks) and K5b (the shared grouped pool).
//
// All three compute, for G groups of Eg consecutive examples, each against
// its own slab of S context rows row_g(0) .. row_g(S - 1):
//   logit[e, s]  = v[e] . ctx[row_g(s)]
//   mask         = (row_g(s) != contexts[e])
//   g[e, s]      = (K * w[row]) * sigmoid(logit) * mask
//   loss[e]      = sum_s (K * w[row]) * mask * softplus(logit)
//   d_center[e]  (+)= sum_s g[e, s] * ctx[row_g(s)]
//   acc[row, :D] += sum_e g[e, s] * v[e]
//   acc[row,  D] += (K * w[row]) * (Eg - hits[g, s])
// The head is G = 1, row(s) = s, S = H, w = q (d_center = g_pos * u +
// ...); the tail is one drawn block a group, row_g(s) = start_g + s with
// start_g = min(head + blocks[g]*S, vn - S), w = tail_w (d_center += ...);
// the shared pool gathers, row_g(s) = pool[g * S + s], with no w (K = the
// pool's scale K*G/P; d_center = g_pos * u + ...).
//
// Arithmetic: float32 products on the tensor cores through a 3xTF32
// split, mma.sync m16n8k8 tf32 with float32 accumulation.  Each float32
// operand x becomes hi = rna(x) and lo = rna(x - hi) (rna: round to 10
// mantissa bits, ties away from zero), and each product is a_lo*b_hi +
// a_hi*b_lo + a_hi*b_hi: it misses only a_lo*b_lo and the rounding of the
// lo parts, about 2^-21 of |a||b|.  A bfloat16 table element is exact in
// tf32 (8 significant bits of 11), so it has no lo part and its products
// take two passes.  tests/test_torch_noise_split.py models this
// arithmetic in numpy and holds it against float64 at the step's shapes.
// The block's v tile is split once, when it lands; every other operand as
// its fragment is loaded from shared memory (there is no room for the
// chunks' lo parts), each fragment once for all the m-tiles it meets.
//
// Two launches a call:
//   launch 1 (logits_center_kernel): a block owns 64 examples of one
//     group (or, with Eg <= 32, two groups, one a 32-row half of the tile)
//     and walks the group's slab in chunks of NC rows (64 at the default
//     width), staged once each with cp.async into a double buffer beside
//     the block's v rows (row by row through the ids for a gathered
//     slab).  From each staged chunk it computes the logit tile (warp
//     pairs on 32 x NC/2 tiles, each warp half of d, the halves added
//     through shared memory), the epilogue in registers
//     (mask, K*w, sigmoid, softplus into the loss, the exact integer
//     hits), the g tile — written to shared memory and once to device
//     memory for launch 2 — and d_center += g_tile . chunk (32-row warp
//     tiles).  d_center and the loss are written once, by the block that
//     owns the rows, without atomics: d_center through shared memory, a
//     row at a time.
//   launch 2 (rows_kernel): acc rows of a 128-row tile of one group's
//     slab, contracting g^T v over the group's examples (or a range of
//     them: the head's 256 rows take E = 8192 examples, cut into ranges so
//     that about one block runs per SM), g and v staged by cp.async in a
//     ring of four 32-example chunks; the sums go into acc through shared
//     memory with float4 atomics, which repeated and clamped blocks and
//     pool rows drawn twice need anyway.
// g thus goes through device memory once (one write, one read).
//
// Wide rows: where even 16-row chunks of whole rows do not fit beside the
// v tile (float32 D > 584, bfloat16 D > 696), launch 1 stages the v tile
// and each chunk as 256-column d-slices instead (kWide), a (v slice, chunk
// slice) pair a stage of its double buffer, and sums the logits fragment
// across the slices in registers before the epilogue.  Every block of a
// chunk visits the slices from the one after its own d-slice round to its
// own, so that the slice its d_center product needs is the one in place
// when the g tile is.
//
// Warps: 8 a block.  Fragments come from shared memory with 4-byte loads,
// conflict-free: rows are padded to a stride of 4 mod 8 words, and where a
// fragment's k index runs down the rows of a staged operand (the d_center
// and acc products), k = t maps to row 2t and k = t + 4 to row 2t + 1 of
// each group of 8 (the same map on both operands, so the sum is unchanged)
// — the g tile's pairs are then adjacent and load as float2.  Columns past
// D and rows past the data are zero or hold finite stale rows that only
// ever meet a zero.
#pragma once

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace g2v {
namespace tc {

constexpr int kThreads = 256;
constexpr int kTileE = 64;   // examples a launch-1 block owns
constexpr int kTileS = 128;  // slab rows a launch-2 block owns
constexpr int kChunkE = 32;  // examples a launch-2 chunk stages
constexpr int kStages = 4;   // launch 2's ring of staged chunks
constexpr int kGs3 = kTileS + 4;  // launch 2's g-chunk row stride (4 mod 8)
constexpr size_t kMaxSmem = 232448;    // the H100's opt-in shared memory a block

struct Params {
  const float* v;         // (E, D) center rows
  const float* u;         // (E, D) positive context rows (K2)
  const float* g_pos;     // (E,) (K2)
  const int* contexts;    // (E,)
  const void* ctx;        // (V, D) context table, float or bfloat16
  const float* w;         // per-row noise weight: q (head) or tail_w
  const int* blocks;      // (G,) drawn block ids; null for the head
  const int* ids;         // (G, S) gathered slab rows (K5b's pool); null: contiguous
  float* g;               // (E, Sp) scratch: launch 1 writes, launch 2 reads
  int* hits;              // (G, S) masked-pair counts, zeroed before launch 1
  float* loss;            // (E,)
  float* d_center;        // (E, D)
  float* acc;             // (V, D+1)
  float kneg;
  int D, S, Sp, Eg, G, head, vn;
  int pair;               // 1: a launch-1 block owns two groups (Eg <= 32), 32 rows each
  int init_center;        // 1: d_center = g_pos*u + ...; 0: d_center += ...
  int sv, sc;             // launch 1: v-tile and chunk row strides
  int sv3, chunk_e, splits;  // launch 2: v-chunk stride; examples a range; ranges
};

// -- arithmetic --------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both tf32: hi = rna(x), lo = rna(x - hi) (x - hi is exact).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(x));
  lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));
}

// A staged table element as tf32 parts: float32 splits; bfloat16 is exact.
// Raw is what a shared-memory load gives, before the split.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr bool kExact = false;
  using Raw = float;
  __device__ static __forceinline__ Raw raw(const float* p) { return *p; }
  __device__ static __forceinline__ void parts(Raw x, uint32_t& hi, uint32_t& lo) {
    split(x, hi, lo);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kExact = true;
  using Raw = unsigned short;
  __device__ static __forceinline__ Raw raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned short*>(p);
  }
  __device__ static __forceinline__ void parts(Raw x, uint32_t& hi, uint32_t& lo) {
    hi = static_cast<uint32_t>(x) << 16;
    lo = 0u;
  }
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m][j] += a[m] . b[j] for MT m-tiles and NT n-tiles in 3xTF32 (2
// passes when b is exact in tf32), small terms first.  B's fragment j is
// at b + j*jstep (its two k halves `step` apart); it is loaded and split
// once for all MT m-tiles, 4 n-tiles at a time — the next 4 loaded while
// this 4's mma.sync run — and the mma.sync go pass by pass so that
// consecutive ones never wait on one another's accumulator.
template <bool kBExact, int MT, int NT, typename T>
__device__ __forceinline__ void mma_block(float (&acc)[MT][NT][4], const uint32_t (&ah)[MT][4],
                                          const uint32_t (&al)[MT][4], const T* b, int jstep,
                                          int step) {
  using E = Elem<T>;
  constexpr int kGroups = (NT + 3) / 4;
  typename E::Raw raw[2][4][2];
  const auto fetch = [&](int grp, typename E::Raw (&r)[4][2]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * grp + j < NT) {
        r[j][0] = E::raw(b + (4 * grp + j) * jstep);
        r[j][1] = E::raw(b + (4 * grp + j) * jstep + step);
      }
    }
  };
  fetch(0, raw[0]);
#pragma unroll
  for (int grp = 0; grp < kGroups; ++grp) {
    if (grp + 1 < kGroups) fetch(grp + 1, raw[(grp + 1) & 1]);
    const int j0 = 4 * grp;
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j0 + j < NT) {
        E::parts(raw[grp & 1][j][0], bh[j][0], bl[j][0]);
        E::parts(raw[grp & 1][j][1], bh[j][1], bl[j][1]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j0 + j < NT) mma(acc[m][j0 + j], al[m], bh[j][0], bh[j][1]);
      }
    }
    if constexpr (!kBExact) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j0 + j < NT) mma(acc[m][j0 + j], ah[m], bl[j][0], bl[j][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j0 + j < NT) mma(acc[m][j0 + j], ah[m], bh[j][0], bh[j][1]);
      }
    }
  }
}

// sigmoid(x) and softplus(x) from one exp(-|x|) (full-precision expf and
// log1pf, a 2-ulp division: jax.nn.sigmoid and jax.nn.softplus up to a
// few roundings).
__device__ __forceinline__ void sigmoid_softplus(float x, float& sig, float& sp) {
  const float e = expf(-fabsf(x));
  sig = __fdividef(x >= 0.0f ? 1.0f : e, 1.0f + e);
  sp = fmaxf(x, 0.0f) + log1pf(e);
}

// -- staging -----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block-wide copy of `rows` rows of n elements, row r from src +
// row_id(r) * ld to dst + r * ss (row stride ss in shared memory), a warp
// a row: 16-byte cp.async where every row is 16-byte aligned and a
// multiple of 16 bytes, else 4-byte cp.async for float32 and plain
// copies for bfloat16.
template <typename T, typename RowId>
__device__ __forceinline__ void gather_rows(T* dst, int ss, const T* src, size_t ld, int rows,
                                            int n, RowId row_id) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec = n % kPer == 0 && ld % kPer == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int r = warp; r < rows; r += kThreads / 32) {
    T* d = dst + static_cast<size_t>(r) * ss;
    const T* s = src + static_cast<size_t>(row_id(r)) * ld;
    if (vec) {
      for (int c = lane * kPer; c < n; c += 32 * kPer) cp16(d + c, s + c);
    } else {
      for (int c = lane; c < n; c += 32) {
        if constexpr (sizeof(T) == 4) {
          cp4(d + c, s + c);
        } else {
          d[c] = s[c];
        }
      }
    }
  }
}

// The same for rows r = 0 .. rows-1 of src, ld apart.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ss, const T* src, size_t ld, int rows,
                                          int n) {
  gather_rows(dst, ss, src, ld, rows, n, [](int r) { return r; });
}

__device__ __forceinline__ void zero_smem(unsigned char* p, size_t bytes) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (size_t i = threadIdx.x; i < bytes / 16; i += kThreads) q[i] = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ int group_start(const Params& p, int grp) {
  return p.blocks == nullptr ? 0 : min(p.head + p.blocks[grp] * p.S, p.vn - p.S);
}

// The table row of slab column s of group grp (whose start is `start`):
// contiguous (K2/K3), or through the pool's ids (kPool, K5b).
template <bool kPool>
__device__ __forceinline__ int slab_row(const Params& p, int grp, int start, int s) {
  if constexpr (kPool) {
    return __ldg(p.ids + static_cast<size_t>(grp) * p.S + s);
  } else {
    return start + s;
  }
}

// K * w[row] (K2/K3), or K alone: a pool slot has no weight table (K5b).
template <bool kPool>
__device__ __forceinline__ float slab_weight(const Params& p, int row) {
  if constexpr (kPool) {
    return p.kneg;
  } else {
    return p.kneg * __ldg(p.w + row);
  }
}

// -- launch 1: logits, epilogue, g, d_center ---------------------------------

// Whether launch 1 splits its v tile once, into hi and lo beside it, or as
// each fragment is loaded: the narrow tiles (D <= 208) have the room.
__host__ __device__ constexpr bool presplit(int NT2) { return NT2 < 8; }

// The launch-1 tile's rows: rows e0 .. e0 + 63 of group blockIdx.y (K2,
// K3; K5b where E/G > 32).
struct OneGroup {
  int grp, ne, start;
  size_t base;  // the tile's first example
  __device__ explicit OneGroup(const Params& p) {
    const int e0 = static_cast<int>(blockIdx.x) * kTileE;
    grp = static_cast<int>(blockIdx.y);
    ne = min(kTileE, p.Eg - e0);
    start = group_start(p, grp);
    base = static_cast<size_t>(grp) * p.Eg + e0;
  }
  __device__ int rows(int h) const { return max(0, min(32, ne - 32 * h)); }
  __device__ int group(int) const { return grp; }
  __device__ int first(int) const { return start; }
  __device__ bool valid(int m) const { return m < ne; }
  __device__ size_t example(int m) const { return base + m; }
};

// K5b's tile: one group as OneGroup, or (p.pair, E/G <= 32) two groups, a
// 32-row half each: half h is group 2 * blockIdx.y + h, its E/G examples
// in rows 32h ...
struct Halves {
  int grp[2], n[2], start[2];
  size_t base[2];
  __device__ explicit Halves(const Params& p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (p.pair) {
        grp[h] = 2 * static_cast<int>(blockIdx.y) + h;
        n[h] = grp[h] < p.G ? min(p.Eg, 32) : 0;
        base[h] = static_cast<size_t>(min(grp[h], p.G - 1)) * p.Eg;
      } else {
        const int e0 = static_cast<int>(blockIdx.x) * kTileE + 32 * h;
        grp[h] = static_cast<int>(blockIdx.y);
        n[h] = max(0, min(32, p.Eg - e0));
        base[h] = static_cast<size_t>(blockIdx.y) * p.Eg + e0;
      }
      start[h] = 0;  // a pool's rows come through its ids
    }
  }
  // by a half index known only at run time, without a local-memory array
  __device__ int rows(int h) const { return h ? n[1] : n[0]; }
  __device__ int group(int h) const { return h ? grp[1] : grp[0]; }
  __device__ int first(int h) const { return h ? start[1] : start[0]; }
  __device__ bool valid(int m) const { return (m & 31) < rows(m >> 5); }
  __device__ size_t example(int m) const { return (m >> 5 ? base[1] : base[0]) + (m & 31); }
};

// Shared memory: v tile [64][sv] (its tf32 hi parts, after the first
// wait, where presplit) | its lo parts [64][sv] (presplit; kWide: the
// second buffer of the v slice, [2][64][sv], sv for 256 columns) | chunks
// [2][NH][NC][sc] T (NH = 1 + pair: one chunk a half's group; kWide: of a
// d-slice) | g tile [64][NC + 8] f32, which first carries the logits'
// exchange | row losses [64] f32.  Grid (ceil(Eg/64), G, d-slices of 32 *
// NT2 columns), or (1, ceil(G/2), d-slices) with two groups a block.  In
// the logits the warps pair up (wt = warp & 3) on rows 32 (wt & 1) .. +32
// x chunk rows (wt >> 1) * NC/2 .. +NC/2, each warp of a pair over half of
// d; in d_center warp (wr, wc) of 2 x 4 takes rows 32 wr .. +32 and the slice's
// n-tiles wc * NT2 .. +NT2 (columns past D hold finite values that are
// never stored).  Either way a warp's rows lie in one half: one group,
// one slab.  kPool: K5b's gathered slab (and, with p.pair, two groups a
// block); K2/K3 compile without it.
template <typename T, int NC, int NT2, bool kPool, bool kWide = false>
__global__ void __launch_bounds__(kThreads) logits_center_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kExact = Elem<T>::kExact, kPre = presplit(NT2);
  static_assert(!kWide || !kPre, "a d-sliced v tile is split as loaded");
  constexpr int NT1 = NC / 16, GS = NC + 8;
  constexpr int W = 32 * NT2;  // columns of a d-slice
  const int dslice = blockIdx.z;
  const int nsl = kWide ? static_cast<int>(gridDim.z) : 1;  // slices a chunk is staged in
  const bool pair = kPool && p.pair;
  const std::conditional_t<kPool, Halves, OneGroup> hv(p);
  const int NH = 1 + pair;
  const int SV = p.sv, SC = p.sc;
  float* vt = reinterpret_cast<float*>(smem);
  uint32_t* vlo = reinterpret_cast<uint32_t*>(vt + kTileE * SV);
  T* cb = reinterpret_cast<T*>(vt + (kPre || kWide ? 2 : 1) * kTileE * SV);
  float* gt = reinterpret_cast<float*>(cb + 2 * NH * NC * SC);
  float* lsum = gt + kTileE * GS;
  zero_smem(smem, reinterpret_cast<unsigned char*>(lsum + kTileE) - smem);
  __syncthreads();

  const T* table = static_cast<const T*>(p.ctx);
  // stage u: chunk u (kWide: chunk u / nsl, d-slice slice_of(u)) in
  // buffer u & 1, beside (kWide) that slice of the v tile
  const auto chunk = [&](int u, int h) { return cb + ((u & 1) * NH + (pair ? h : 0)) * NC * SC; };
  const auto vbuf = [&](int u) { return kWide ? vt + (u & 1) * kTileE * SV : vt; };
  const auto slice_of = [&](int u) { return kWide ? (dslice + 1 + u % nsl) % nsl : 0; };
  const int nchunks = (p.S + NC - 1) / NC;
  const int nunits = nchunks * nsl;
  const auto stage = [&](int u) {
    const int c = u / nsl, r0 = c * NC, rows = min(NC, p.S - r0);
    const int d0 = slice_of(u) * W, wn = kWide ? min(W, p.D - d0) : p.D;
    if constexpr (kWide) {
      float* vd = vbuf(u);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        copy_rows(vd + 32 * h * SV, SV, p.v + hv.example(32 * h) * p.D + d0, p.D, hv.rows(h), wn);
      }
      // the slice's columns past D up to the k-steps' 8 meet stale chunk
      // columns: zero them in v
      for (int i = threadIdx.x; i < kTileE * ((8 - wn % 8) % 8); i += kThreads) {
        const int n = (8 - wn % 8) % 8;
        vd[(i / n) * SV + wn + i % n] = 0.0f;
      }
    }
    for (int h = 0; h < NH; ++h) {
      if (hv.rows(h) == 0) continue;
      if constexpr (kPool) {
        const int* ids = p.ids + static_cast<size_t>(hv.group(h)) * p.S + r0;
        gather_rows(chunk(u, h), SC, table + d0, p.D, rows, wn,
                    [&](int r) { return __ldg(ids + r); });
      } else {
        copy_rows(chunk(u, h), SC, table + static_cast<size_t>(hv.first(h) + r0) * p.D + d0, p.D,
                  rows, wn);
      }
    }
  };
  if constexpr (kPool && !kWide) {  // the whole v tile, once (kWide: a slice a stage)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      copy_rows(vt + 32 * h * SV, SV, p.v + hv.example(32 * h) * p.D, p.D, hv.rows(h), p.D);
    }
  } else if constexpr (!kWide) {
    copy_rows(vt, SV, p.v + hv.base * p.D, p.D, hv.ne, p.D);
  }
  stage(0);
  cp_commit();
  if (nunits > 1) stage(1);
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // logits: the pair of warps wt (= warp & 3) takes rows 32 (wt & 1) .. +32
  // x chunk rows nb .. nb + NC/2, each warp of it half of d (kh); each then
  // keeps m-tile kh, rows m0 and m0 + 8, with the partner's partial added
  const int wt = warp & 3, kh = warp >> 2;
  const int hl = wt & 1;  // the logits' half
  const int m0 = hl * 32 + kh * 16 + g;
  const int nb = (wt >> 1) * (NC / 2);
  const int r1 = (warp & 1) * 32 + g;  // d_center: rows r1 + 8i, i < 4 (half warp & 1)
  // its first column (kWide: in the staged slice, which is the block's own)
  const int dcol = (kWide ? 0 : dslice * 32 * NT2) + (warp >> 1) * 8 * NT2;
  int cm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) cm[h] = hv.valid(m0 + 8 * h) ? p.contexts[hv.example(m0 + 8 * h)] : -1;
  const int Dk = (p.D + 7) & ~7;
  const bool owner = dslice == 0;  // writes g, hits and the loss
  float lpart[2] = {0.0f, 0.0f};
  float acc2[2][NT2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < NT2; ++j) acc2[m][j][0] = acc2[m][j][1] = acc2[m][j][2] = acc2[m][j][3] = 0.0f;
  }

  int rid[NT1][2];  // kPool only
  float kw[NT1][2];
  float acc1[2][NT1][4];
  for (int u = 0; u < nunits; ++u) {
    const int c = u / nsl;  // the chunk (kWide: of this d-slice)
    cp_wait<1>();
    __syncthreads();  // stage u (and at u = 0 the v tile) in place
    if (kPre && u == 0) {  // split the v tile once: hi in place, lo beside it
      for (int i = threadIdx.x; i < kTileE * SV; i += kThreads) {
        uint32_t hi;
        split(vt[i], hi, vlo[i]);
        vt[i] = __uint_as_float(hi);
      }
      __syncthreads();
    }
    const int r0 = c * NC;
    if (u % nsl == 0) {  // a chunk's first stage
      // K * w of this lane's slab columns (and a pool's table rows), loaded
      // before the logits need them
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int s = min(r0 + nb + 8 * j + 2 * t + q, p.S - 1);
          if constexpr (kPool) {
            const bool live = hv.rows(hl) > 0;
            rid[j][q] = live ? slab_row<true>(p, hv.group(hl), 0, s) : -1;
            kw[j][q] = live ? slab_weight<true>(p, rid[j][q]) : 0.0f;
          } else {
            kw[j][q] = slab_weight<false>(p, hv.first(0) + s);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int j = 0; j < NT1; ++j) acc1[m][j][0] = acc1[m][j][1] = acc1[m][j][2] = acc1[m][j][3] = 0.0f;
      }
    }

    // logits: this warp's half of d (kWide: of the slice) for the pair's
    // 32 rows, summed into acc1 across a chunk's slices
    const int rp = hl * 32 + g;  // the pair's rows rp + 8i, i < 4
    const float* vf = vbuf(u) + rp * SV + t;
    const uint32_t* vh = reinterpret_cast<const uint32_t*>(vf);
    const uint32_t* vl = vlo + rp * SV + t;
    const T* ba = chunk(u, hl) + (nb + g) * SC + t;
    const int dk = kWide ? (min(W, p.D - slice_of(u) * W) + 7) & ~7 : Dk;
    const int khalf = ((dk >> 3) + 1) >> 1;  // k-steps of the first half
#pragma unroll 2
    for (int k0 = 8 * kh * khalf; k0 < (kh ? dk : 8 * khalf); k0 += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int o[4] = {k0 + 16 * m * SV, k0 + (16 * m + 8) * SV, k0 + 16 * m * SV + 4,
                          k0 + (16 * m + 8) * SV + 4};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (kPre) {
            ah[m][r] = vh[o[r]];
            al[m][r] = vl[o[r]];
          } else {
            split(vf[o[r]], ah[m][r], al[m][r]);
          }
        }
      }
      mma_block<kExact, 2, NT1>(acc1, ah, al, ba + k0, 8 * SC, 4);
    }
    if (u % nsl != nsl - 1) {  // kWide: more slices of this chunk to come
      __syncthreads();  // every warp is done with stage u's buffers
      if (u + 2 < nunits) stage(u + 2);
      cp_commit();
      continue;
    }
    // the pair's exchange, through the g tile's space: this warp hands
    // over its partial of m-tile 1 - kh and adds the partner's of m-tile kh
    // (the last chunk's g tile is free: every warp passed the loop's last
    // barrier after reading it)
    float* xc = gt + wt * 2 * NT1 * 128 + lane;  // [wt][m][j][i][lane]
#pragma unroll
    for (int j = 0; j < NT1; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xc[((1 - kh) * NT1 + j) * 128 + 32 * i] = kh ? acc1[0][j][i] : acc1[1][j][i];
      }
    }
    __syncthreads();
    float lg[NT1][4];  // this warp's logits: rows m0, m0 + 8 x chunk rows nb + 8j
#pragma unroll
    for (int j = 0; j < NT1; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lg[j][i] = (kh ? acc1[1][j][i] : acc1[0][j][i]) + xc[(kh * NT1 + j) * 128 + 32 * i];
      }
    }
    __syncthreads();  // the exchange is read: the g tile may be written

    // epilogue: g into the g tile (and device memory), the loss, hits
    uint32_t hits = 0;  // bit (2j + h) * 2 + q: this lane's pair (j, h, q) hit
#pragma unroll
    for (int j = 0; j < NT1; ++j) {
      const int n = nb + 8 * j + 2 * t;  // chunk row of this lane's pair
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * h;
        const bool live = hv.valid(m);
        float gv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int s = r0 + n + q;
          const bool in = live && s < p.S;
          const bool hit = (kPool ? rid[j][q] : hv.first(0) + s) == cm[h];
          // K * w * mask, 0 past the data: g = that * sigmoid, loss += that * softplus
          const float wm = in && !hit ? kw[j][q] : 0.0f;
          float sig, sp;
          sigmoid_softplus(lg[j][2 * h + q], sig, sp);
          gv[q] = wm * sig;
          lpart[h] += wm * sp;
          if (in && hit) hits |= 1u << ((2 * j + h) * 2 + q);
        }
        *reinterpret_cast<float2*>(gt + m * GS + n) = make_float2(gv[0], gv[1]);
        if (owner && live && r0 + n < p.Sp) {
          *reinterpret_cast<float2*>(p.g + hv.example(m) * p.Sp + r0 + n) =
              make_float2(gv[0], gv[1]);
        }
      }
    }
    if (hits && owner) {  // rare: a context inside the slab
      for (int b = 0; b < 4 * NT1; ++b) {
        if (hits >> b & 1) {
          atomicAdd(&p.hits[hv.group(hl) * p.S + r0 + nb + 8 * (b >> 2) + 2 * t + (b & 1)], 1);
        }
      }
    }
    __syncthreads();  // the g tile in place

    // d_center += g tile (rows r1 + 8i) . chunk (this warp's columns)
    const int kend = (min(NC, p.S - r0) + 7) & ~7;
    const float* ga = gt + r1 * GS + 2 * t;
    const T* bb = chunk(u, warp & 1) + 2 * t * SC + dcol + g;
#pragma unroll 2
    for (int kk = 0; kk < kend; kk += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float2 x0 = *reinterpret_cast<const float2*>(ga + 16 * m * GS + kk);
        const float2 x1 = *reinterpret_cast<const float2*>(ga + (16 * m + 8) * GS + kk);
        split(x0.x, ah[m][0], al[m][0]);
        split(x1.x, ah[m][1], al[m][1]);
        split(x0.y, ah[m][2], al[m][2]);
        split(x1.y, ah[m][3], al[m][3]);
      }
      mma_block<kExact, 2, NT2>(acc2, ah, al, bb + kk * SC, 8, SC);
    }
    __syncthreads();  // every warp is done with stage u and the g tile
    if (u + 2 < nunits) stage(u + 2);
    cp_commit();
  }

  // each row's loss: the 4 lanes of a row, then the two column warps
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lpart[h] += __shfl_xor_sync(0xffffffffu, lpart[h], 1);
    lpart[h] += __shfl_xor_sync(0xffffffffu, lpart[h], 2);
    if (t == 0) atomicAdd(&lsum[m0 + 8 * h], lpart[h]);
  }
  // d_center: the tile's sums through shared memory (over the v tile and
  // chunks, free now), then row by row, 4 rows a warp at a time (all in
  // one half) with every base loaded before any store, so that the loads
  // overlap
  constexpr int DT = 32 * NT2 + 4;  // the staged tile's row stride
  float* tile = vt;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NT2; ++j) {
      *reinterpret_cast<float2*>(tile + (r1 + 8 * i) * DT + (warp >> 1) * 8 * NT2 + 8 * j + 2 * t) =
          make_float2(acc2[i >> 1][j][2 * (i & 1)], acc2[i >> 1][j][2 * (i & 1) + 1]);
    }
  }
  __syncthreads();
  const int d0 = dslice * 32 * NT2, dn = min(32 * NT2, p.D - d0);
  constexpr int kCols = NT2;  // columns a lane: lane + 32k, k < NT2 (32 * NT2 in all)
  for (int rb = warp * 4; rb < kTileE; rb += 4 * (kThreads / 32)) {
    const int nh = hv.rows(rb >> 5), k0 = rb & 31;
    if (k0 >= nh) continue;  // warp-uniform
    const size_t e0 = hv.example(rb);
    float base[4][kCols];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const size_t er = e0 + min(rr, nh - 1 - k0);
      const size_t o = er * p.D + d0;
      if (p.init_center) {
        const float gp = p.g_pos[er];
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          base[rr][k] = __fmul_rn(gp, p.u[o + min(lane + 32 * k, dn - 1)]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k) base[rr][k] = p.d_center[o + min(lane + 32 * k, dn - 1)];
      }
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int c = lane + 32 * k;
        if (k0 + rr < nh && c < dn) {
          p.d_center[(e0 + rr) * p.D + d0 + c] = __fadd_rn(base[rr][k], tile[(rb + rr) * DT + c]);
        }
      }
    }
  }
  __syncthreads();
  const int m = threadIdx.x;
  if (owner && m < kTileE && hv.valid(m)) p.loss[hv.example(m)] = lsum[m];
}

// -- launch 2: acc rows ------------------------------------------------------

// Shared memory: a ring of kStages chunks, g [32][kGs3] f32 and v
// [32][sv3] f32 each | a 1 KB tail that the last row's unused columns may
// read.  Grid (ceil(S/128), G * splits, d-slices of 16 * NT3 columns).
// Warp (wr, wc) of 4 x 2 takes slab rows 32 wr .. +32 and the slice's
// n-tiles wc * NT3 .. +NT3.
template <int NT3, bool kPool>
__global__ void __launch_bounds__(kThreads) rows_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s0 = blockIdx.x * kTileS;
  const int grp = blockIdx.y / p.splits, split_id = blockIdx.y % p.splits;
  const int d0 = blockIdx.z * 16 * NT3, dn = min(16 * NT3, p.D - d0);
  const int start = group_start(p, grp);
  const int kb = split_id * p.chunk_e, ke = min(p.Eg, kb + p.chunk_e);
  const int SV3 = p.sv3;
  const int stage_floats = kChunkE * (kGs3 + SV3);
  float* ring = reinterpret_cast<float*>(smem);
  zero_smem(smem, static_cast<size_t>(kStages) * stage_floats * 4 + 1024);
  __syncthreads();

  const size_t grow = static_cast<size_t>(grp) * p.Eg;  // the group's first example
  const int ns = min(kTileS, p.Sp - s0);
  const int nchunks = ke > kb ? (ke - kb + kChunkE - 1) / kChunkE : 0;
  const auto stage = [&](int c) {
    if (c >= nchunks) return;
    const int e = kb + c * kChunkE, rows = min(kChunkE, ke - e);
    float* gd = ring + (c % kStages) * stage_floats;
    copy_rows(gd, kGs3, p.g + (grow + e) * p.Sp + s0, p.Sp, rows, ns);
    copy_rows(gd + kChunkE * kGs3, SV3, p.v + (grow + e) * p.D + d0, p.D, rows, dn);
    // rows past the range meet stale v rows: their g must be zero
    for (int i = rows * kGs3 + threadIdx.x; i < kChunkE * kGs3; i += kThreads) gd[i] = 0.0f;
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    stage(c);
    cp_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r1 = (warp & 3) * 32 + g;      // slab rows s0 + r1 + 8i, i < 4
  const int dcol = (warp >> 2) * 8 * NT3;  // this warp's first column in the slice
  float acc[2][NT3][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < NT3; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.0f;
  }

  for (int c = 0; c < nchunks; ++c) {
    cp_wait<kStages - 2>();  // chunk c landed
    __syncthreads();         // ... for every thread; chunk c - 1's slot is free
    stage(c + kStages - 1);
    cp_commit();
    const float* gd = ring + (c % kStages) * stage_floats;
    const float* ga = gd + 2 * t * kGs3 + r1;
    const float* bb = gd + kChunkE * kGs3 + 2 * t * SV3 + dcol + g;
#pragma unroll
    for (int kk = 0; kk < kChunkE; kk += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* a = ga + kk * kGs3 + 16 * m;
        split(a[0], ah[m][0], al[m][0]);
        split(a[8], ah[m][1], al[m][1]);
        split(a[kGs3], ah[m][2], al[m][2]);
        split(a[kGs3 + 8], ah[m][3], al[m][3]);
      }
      mma_block<false, 2, NT3>(acc, ah, al, bb + kk * SV3, 8, SV3);
    }
  }

  // the tile's sums through shared memory, then added a row at a time:
  // float4 atomics on the row's 16-byte aligned middle, scalar ones at its
  // ends (acc rows are D + 1 floats apart)
  __syncthreads();  // every warp is done with the ring
  const int TS = 16 * NT3 + 4;  // the tile's row stride
  float* tile = ring;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NT3; ++j) {
      *reinterpret_cast<float2*>(tile + (r1 + 8 * i) * TS + dcol + 8 * j + 2 * t) =
          make_float2(acc[i >> 1][j][2 * (i & 1)], acc[i >> 1][j][2 * (i & 1) + 1]);
    }
  }
  __syncthreads();
  const int D1 = p.D + 1;
  for (int r = warp; r < min(kTileS, p.S - s0); r += kThreads / 32) {
    float* arow = p.acc + static_cast<size_t>(slab_row<kPool>(p, grp, start, s0 + r)) * D1 + d0;
    const float* trow = tile + r * TS;
    g2v_add_row(arow, dn, lane, [&](int d) { return trow[d]; });
  }
  if (blockIdx.z == 0 && split_id == 0 && threadIdx.x < kTileS) {
    const int s = s0 + threadIdx.x;
    if (s < p.S) {
      const int row = slab_row<kPool>(p, grp, start, s);
      const int cnt = p.Eg - p.hits[grp * p.S + s];
      atomicAdd(&p.acc[static_cast<size_t>(row) * D1 + p.D],
                slab_weight<kPool>(p, row) * static_cast<float>(cnt));
    }
  }
}

// -- host --------------------------------------------------------------------

// The smallest stride >= n (words) that is 4 mod 8.
inline int stride_4mod8(int n) { return n + ((12 - n % 8) % 8); }

// Lets kKernel take the card's whole opt-in shared memory, once per device.
// Static, so that each library (K2's, K3's, K5b's) keeps its own flags: an inline
// function's static would be one object across every loaded library.
template <auto kKernel>
static int allow_smem() {
  static std::atomic<unsigned> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bit = 1u << (dev & 31);
  if (done.load() & bit) return 0;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err == cudaSuccess) done.fetch_or(bit);
  return static_cast<int>(err);
}

template <typename T, bool kPool, int NC, int NT2, int NT3, bool kWide = false>
inline int launch_at(Params p, int G, cudaStream_t stream) {
  const int dslices1 = (p.D + 32 * NT2 - 1) / (32 * NT2);
  const int dslices3 = (p.D + 16 * NT3 - 1) / (16 * NT3);
  const size_t bytes1 =
      4 * static_cast<size_t>(kTileE) * ((presplit(NT2) || kWide ? 2 : 1) * p.sv + NC + 8 + 1) +
      2 * static_cast<size_t>(1 + (kPool && p.pair)) * NC * p.sc * sizeof(T);
  p.sv3 = stride_4mod8((min(p.D, 16 * NT3) + 7) & ~7);
  const size_t bytes2 = static_cast<size_t>(kStages * kChunkE) * (kGs3 + p.sv3) * 4 + 1024;
  // launch 2's example ranges: whole chunks, as many as asked for
  p.chunk_e = ((p.Eg + p.splits - 1) / p.splits + kChunkE - 1) / kChunkE * kChunkE;
  p.splits = (p.Eg + p.chunk_e - 1) / p.chunk_e;
  if (bytes1 > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int status = allow_smem<logits_center_kernel<T, NC, NT2, kPool, kWide>>();
  if (status == 0) status = allow_smem<rows_kernel<NT3, kPool>>();
  if (status != 0) return status;
  cudaError_t err = cudaMemsetAsync(p.hits, 0, sizeof(int) * G * p.S, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1 = kPool && p.pair ? dim3(1, (G + 1) / 2, dslices1)
                                     : dim3((p.Eg + kTileE - 1) / kTileE, G, dslices1);
  logits_center_kernel<T, NC, NT2, kPool, kWide><<<grid1, kThreads, bytes1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_kernel<NT3, kPool><<<dim3((p.S + kTileS - 1) / kTileS, G * p.splits, dslices3),
                            kThreads, bytes2, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Chooses the layout for table element T and launches both kernels:
// n-tiles a warp by D, the v tile split once up to D = 200 (float32
// tables; 208 bf16), then d-slices of 256 columns and the v tile split as
// loaded, in chunks of 64 slab rows, or 32 / 16 where a wide D leaves no
// room for 64 (two groups a block stage two chunks of each).  Where two
// groups a block leave no room, K5b takes one; where whole rows leave no
// room for 16-row chunks (float32 D > 584, bfloat16 D > 696), launch 1
// stages the v tile and the chunks as 256-column d-slices (kWide), in
// chunks of 32 rows (float32) or 64 (bfloat16), at any D.  Returns a CUDA
// error code.
template <typename T, bool kPool>
inline int launch(Params p, int G, cudaStream_t stream) {
  if (p.Eg == 0 || G == 0) return 0;
  p.G = G;
  p.pair = kPool && p.pair;
  const int Dk = (p.D + 7) & ~7;
  p.sv = stride_4mod8(Dk);
  // chunk rows 4 mod 8 words apart (bfloat16: 8 mod 16 elements)
  p.sc = sizeof(T) == 4 ? stride_4mod8(Dk) : 2 * stride_4mod8((Dk + 1) / 2);
  const auto fits = [&](int nc, int vparts) {
    return 4 * static_cast<size_t>(kTileE) * (vparts * p.sv + nc + 8 + 1) +
               2 * static_cast<size_t>(1 + p.pair) * nc * p.sc * sizeof(T) <= kMaxSmem;
  };
  const int tiles = Dk / 8;  // 8-column n-tiles of d
  if (tiles <= 26 && fits(64, 2)) {
    if (tiles <= 8) return launch_at<T, kPool, 64, 2, 4>(p, G, stream);
    if (tiles <= 16) return launch_at<T, kPool, 64, 4, 8>(p, G, stream);
    return launch_at<T, kPool, 64, 7, 13>(p, G, stream);
  }
  if constexpr (kPool) {
    if (p.pair && tiles <= 26 && fits(32, 2)) {  // two float32 chunks of 64 rows do not fit
      if (tiles <= 8) return launch_at<T, kPool, 32, 2, 4>(p, G, stream);
      if (tiles <= 16) return launch_at<T, kPool, 32, 4, 8>(p, G, stream);
      return launch_at<T, kPool, 32, 7, 13>(p, G, stream);
    }
  }
  if (fits(64, 1)) return launch_at<T, kPool, 64, 8, 16>(p, G, stream);
  if (fits(32, 1)) return launch_at<T, kPool, 32, 8, 16>(p, G, stream);
  if (fits(16, 1)) return launch_at<T, kPool, 16, 8, 16>(p, G, stream);
  if (p.pair) {  // K5b: one group a block, then the narrow layouts again
    p.pair = 0;
    return launch<T, kPool>(p, G, stream);
  }
  p.sv = stride_4mod8(256);
  p.sc = sizeof(T) == 4 ? stride_4mod8(256) : 2 * stride_4mod8(128);
  return launch_at<T, kPool, sizeof(T) == 4 ? 32 : 64, 8, 16, true>(p, G, stream);
}

// kPool: K5b's gathered slabs (p.ids); K2 and K3 launch without.
template <bool kPool>
inline int launch_as(const Params& p, int G, int bf16, cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16, kPool>(p, G, stream) : launch<float, kPool>(p, G, stream);
}

}  // namespace tc
}  // namespace g2v
