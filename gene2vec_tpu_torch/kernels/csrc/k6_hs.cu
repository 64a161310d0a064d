// K6 — hierarchical softmax over each target's path, one launch.
//
// Replaces: gene2vec_tpu/sgns/cbow_hs.py:65-101 (hs_loss_and_grads) and
// the rest of hs_step (:149-160, :197-209), the cbow_hs_step hot path:
// v = emb[inputs]; for each example, the target's Huffman path.
//
// Each path entry (node n, sign s = 1 - 2*code) computes
//   logit = v . node[n],  loss += softplus(-s * logit),
//   g = sigmoid(logit) - (1 + s)/2,
//   d_input += g * node[n],  acc[n] += [g * v | 1].
// Deep entries come from the padded deep remainders (points, codes,
// lengths); with hs_dense_depth > 0 the shallow entries come from the
// compact shallow paths (huffman.shallow_paths: at most Ls node ids in
// [0, Ns) a token, in level order, with their signs; 0 past the path).
// The reference scores the shallow levels densely against the whole
// prefix (logit_s = v @ W_s^T with a sign row of mostly zeros); a zero
// sign feeds nothing (cbow_hs.py:122-131), so visiting only the path's
// entries computes the same function.  Losses: loss_deep over the deep
// entries, loss_shallow over the shallow ones (cbow_hs.py:159).
//
// Bound on the H100: bytes.  Per step the distinct input rows and the
// touched node rows read once, the touched accumulator rows read and
// written once, v, d_input and the losses: ~9 us at E = 8192, D = 200
// on the bench vocab (hs_dense_depth 10, ~10.4 entries an example,
// float32 tables), against ~0.1 GFLOP of on-path float32 work (~1.5 us
// at 67 TFLOP/s; both counted by chip_smoke.py's hs_work).
//
// Design: one warp per example, 16 consecutive examples a block of 8
// warps, at most 64 registers a thread so that 4 blocks share an SM (32
// warps hide the path's dependent loads).  A lane owns columns lane + 32j;
// v, the d_input row and the current entry's node values live in its
// registers, so a node row is read once for both its dot product and
// d_input (a second pass re-reading it, through shared memory, cost 3x).
// Accumulator rows: every path passes the root, and a level-l node sees
// about E / 2^l examples; per-example global atomics serialize there
// (same-address updates queue at one L2 slice).  The entries of the top
// `hot` levels are left in shared memory instead — g and the slot
// (2^l - 1) + (the path's first l codes read as a binary number), a heap
// numbering of the levels, so no table is needed — and after the block's
// examples each thread adds its columns of every visited slot in example
// order (no atomics), then one float4 flush a visited row.  Entries below
// the hot levels and the deep entries add [g * v | 1] into acc straight
// away: float4 atomics on the row's 16-byte aligned middle, scalar ones
// at its ends (acc rows are D + 1 floats apart).  The table element type
// T (float or bfloat16, emb and node alike) is upcast on load.
//
// Wide rows (D > 512, hs_wide_kernel): a lane's columns no longer fit its
// registers, so each entry walks the row in 512-column parts twice — once
// for the dot product, whose lane partials run on across the parts and
// are summed by the warp only after the last one (the logit is whole
// before the epilogue), then for d_input, carried in the example's own
// d_input row (each lane reads back only what it wrote) — with v re-read
// from the input row (L1) instead of held.  Hot levels as above, as many
// as the shared memory holds at that width: the launcher lowers `hot`
// until the hot rows fit, at either width.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // blocks an SM must hold (the register budget)

struct HsParams {
  const void* emb;
  const void* node;
  const int* inputs;
  const int* targets;
  const int* points;         // (V, L) deep node ids
  const float* codes;        // (V, L)
  const int* lengths;        // (V,) deep lengths
  const int* sids;           // (V, Ls) shallow node ids, or null
  const signed char* ssigns; // (V, Ls)
  float* d_input;            // (E, D)
  float* loss_deep;          // (E,)
  float* loss_shallow;       // (E,)
  float* acc;                // (n_nodes, D + 1), 16-byte aligned
  int L, Ls, E, D;
  int hot;                   // levels reduced in shared memory (0..7)
  int per_block;             // examples a block
};

// A read-only table element as float32, through the non-coherent path
// (no store of the kernel can alias it, so loads move freely).
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// sigmoid(x) as jax.nn.sigmoid forms it, 1 / (1 + exp(-x)), and
// softplus(-s * x) for s = +-1, sharing the exponential where x >= 0.
// The same rounding of sigmoid as the reference's matters: a node row
// visited by one input through both of its branches sums g = sigmoid and
// g = sigmoid - 1 terms that cancel, and there any other rounding of
// sigmoid is multiplied by the visits instead of cancelling.
__device__ __forceinline__ void sigmoid_softplus(float x, float s, float& sig, float& sp) {
  const float em = expf(-x);
  sig = 1.0f / (1.0f + em);
  sp = fmaxf(-s * x, 0.0f) + log1pf(x >= 0.0f ? em : expf(x));
}

// Shared memory: hot rows [nhot][D + 1] f32 | their node ids [nhot] |
// the block's v rows [per_block][D] f32 | each example's hot entries: g
// [per_block][hot] f32 and slot [per_block][hot] int (-1 past the path).
struct Smem {
  float* hacc;
  int* hid;
  float* vrow;
  float* gh;
  int* sl;
  __device__ Smem(float* base, int nhot, int D, int per_block, int hot) {
    hacc = base;
    hid = reinterpret_cast<int*>(hacc + nhot * (D + 1));
    vrow = reinterpret_cast<float*>(hid + nhot);
    gh = vrow + per_block * D;
    sl = reinterpret_cast<int*>(gh + per_block * hot);
  }
};

// NJ: columns a lane owns (d = lane + 32 j, j < NJ; D <= 32 NJ).  C: path
// entries scored together, their C x NJ node values held in registers for
// both the dot products and d_input.
template <typename T, int NJ, int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks) hs_kernel(HsParams p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, D1 = D + 1, H = p.hot;
  const int nhot = (1 << H) - 1;
  const Smem sm(smem, nhot, D, p.per_block, H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < nhot * D1; i += kThreads) sm.hacc[i] = 0.0f;
  for (int i = threadIdx.x; i < nhot; i += kThreads) sm.hid[i] = -1;
  __syncthreads();

  const T* emb = static_cast<const T*>(p.emb);
  const T* node = static_cast<const T*>(p.node);
  const int e_begin = static_cast<int>(blockIdx.x) * p.per_block;
  const int ne = min(p.E - e_begin, p.per_block);
  for (int k = warp; k < ne; k += kWarps) {
    const int e = e_begin + k;
    const T* er = emb + static_cast<size_t>(__ldg(p.inputs + e)) * D;
    const int t = __ldg(p.targets + e);
    float* vr = sm.vrow + k * D;
    float v[NJ], din[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      v[j] = d < D ? ldg(er + d) : 0.0f;
      din[j] = 0.0f;
      if (d < D) vr[d] = v[j];
    }
    // the shallow entries: a prefix of the token's row (level order)
    int ns = 0;
    unsigned cbits = 0;  // bit l: the level-l code (sign -1)
    if (p.sids != nullptr) {
      for (int j0 = 0; j0 < p.Ls; j0 += 32) {
        const int j = j0 + lane;
        const int s = j < p.Ls ? __ldg(p.ssigns + static_cast<size_t>(t) * p.Ls + j) : 0;
        ns += __popc(__ballot_sync(0xffffffffu, s != 0));
        if (j0 == 0) cbits = __ballot_sync(0xffffffffu, s < 0);
      }
    }
    if (lane < H) sm.sl[k * H + lane] = -1;
    const int n = ns + min(__ldg(p.lengths + t), p.L);
    __syncwarp();  // vr in place for the accumulator rows
    float loss_s = 0.0f, loss_d = 0.0f;
    for (int c0 = 0; c0 < n; c0 += C) {
      const int nc = min(C, n - c0);
      // this chunk's entries: node id and sign
      int id[C];
      float sg[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = c0 + min(c, nc - 1);
        if (i < ns) {
          const size_t o = static_cast<size_t>(t) * p.Ls + i;
          id[c] = __ldg(p.sids + o);
          sg[c] = static_cast<float>(__ldg(p.ssigns + o));
        } else {
          const size_t o = static_cast<size_t>(t) * p.L + (i - ns);
          id[c] = __ldg(p.points + o);
          sg[c] = 1.0f - 2.0f * __ldg(p.codes + o);
        }
      }
      float w[C][NJ];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const T* wr = node + static_cast<size_t>(id[c]) * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          w[c][j] = c < nc && d < D ? ldg(wr + d) : 0.0f;
        }
      }
      float g[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) dot = fmaf(v[j], w[c][j], dot);
        float sig, sp;
        sigmoid_softplus(g2v_warp_sum(dot), sg[c], sig, sp);
        g[c] = c < nc ? sig - (1.0f + sg[c]) * 0.5f : 0.0f;
        if (c < nc) {
          if (c0 + c < ns) {
            loss_s += sp;
          } else {
            loss_d += sp;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) din[j] = fmaf(g[c], w[c][j], din[j]);
      }
      // the accumulator rows: a hot entry is left for the block's pass
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c >= nc) break;
        const int i = c0 + c;
        const float gc = g[c];
        if (i < H && i < ns) {
          if (lane == 0) {
            const int slot = (1 << i) - 1 + (i ? __brev(cbits << (32 - i)) : 0);
            sm.hid[slot] = id[c];
            sm.gh[k * H + i] = gc;
            sm.sl[k * H + i] = slot;
          }
        } else {
          g2v_add_row(p.acc + static_cast<size_t>(id[c]) * D1, D1, lane,
                  [&](int d) { return d < D ? __fmul_rn(gc, vr[d]) : 1.0f; });
        }
      }
    }
    float* di = p.d_input + static_cast<size_t>(e) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) di[d] = din[j];
    }
    if (lane == 0) {
      p.loss_deep[e] = loss_d;
      if (p.sids != nullptr) p.loss_shallow[e] = loss_s;
    }
  }
  if (H == 0) return;
  // the hot rows: each thread owns columns of every slot (no atomics),
  // adding the block's examples in order; then one flush a visited row
  __syncthreads();
  for (int d = threadIdx.x; d < D1; d += kThreads) {
    for (int k = 0; k < ne; ++k) {
      const float x = d < D ? sm.vrow[k * D + d] : 1.0f;
      for (int i = 0; i < H; ++i) {
        const int slot = sm.sl[k * H + i];
        if (slot < 0) break;
        float* a = sm.hacc + slot * D1 + d;
        *a += d < D ? __fmul_rn(sm.gh[k * H + i], x) : 1.0f;
      }
    }
  }
  __syncthreads();
  for (int slot = warp; slot < nhot; slot += kWarps) {
    const int n = sm.hid[slot];
    if (n < 0) continue;
    const float* row = sm.hacc + slot * D1;
    g2v_add_row(p.acc + static_cast<size_t>(n) * D1, D1, lane, [&](int d) { return row[d]; });
  }
}

// Shared memory of hs_wide_kernel: hot rows [nhot][D + 1] f32 | their
// node ids [nhot] | each example's hot entries: g [per_block][hot] f32 and
// slot [per_block][hot] int (-1 past the path).  No v rows.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) hs_wide_kernel(HsParams p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NJ = 16;  // columns a lane takes of a 512-column part
  const int D = p.D, D1 = D + 1, H = p.hot;
  const int nhot = (1 << H) - 1;
  float* hacc = smem;
  int* hid = reinterpret_cast<int*>(hacc + nhot * D1);
  float* gh = reinterpret_cast<float*>(hid + nhot);
  int* sl = reinterpret_cast<int*>(gh + p.per_block * H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < nhot * D1; i += kThreads) hacc[i] = 0.0f;
  for (int i = threadIdx.x; i < nhot; i += kThreads) hid[i] = -1;
  __syncthreads();

  const T* emb = static_cast<const T*>(p.emb);
  const T* node = static_cast<const T*>(p.node);
  const int e_begin = static_cast<int>(blockIdx.x) * p.per_block;
  const int ne = min(p.E - e_begin, p.per_block);
  for (int k = warp; k < ne; k += kWarps) {
    const int e = e_begin + k;
    const T* er = emb + static_cast<size_t>(__ldg(p.inputs + e)) * D;
    const int t = __ldg(p.targets + e);
    int ns = 0;
    unsigned cbits = 0;  // bit l: the level-l code (sign -1)
    if (p.sids != nullptr) {
      for (int j0 = 0; j0 < p.Ls; j0 += 32) {
        const int j = j0 + lane;
        const int s = j < p.Ls ? __ldg(p.ssigns + static_cast<size_t>(t) * p.Ls + j) : 0;
        ns += __popc(__ballot_sync(0xffffffffu, s != 0));
        if (j0 == 0) cbits = __ballot_sync(0xffffffffu, s < 0);
      }
    }
    if (lane < H) sl[k * H + lane] = -1;
    const int n = ns + min(__ldg(p.lengths + t), p.L);
    float* di = p.d_input + static_cast<size_t>(e) * D;
    float loss_s = 0.0f, loss_d = 0.0f;
    for (int i = 0; i < n; ++i) {
      int id;
      float sg;
      if (i < ns) {
        const size_t o = static_cast<size_t>(t) * p.Ls + i;
        id = __ldg(p.sids + o);
        sg = static_cast<float>(__ldg(p.ssigns + o));
      } else {
        const size_t o = static_cast<size_t>(t) * p.L + (i - ns);
        id = __ldg(p.points + o);
        sg = 1.0f - 2.0f * __ldg(p.codes + o);
      }
      const T* wr = node + static_cast<size_t>(id) * D;
      float dot = 0.0f;
      for (int d0 = 0; d0 < D; d0 += 32 * NJ) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = d0 + lane + 32 * j;
          if (d < D) dot = fmaf(ldg(er + d), ldg(wr + d), dot);
        }
      }
      float sig, sp;
      sigmoid_softplus(g2v_warp_sum(dot), sg, sig, sp);
      const float g = sig - (1.0f + sg) * 0.5f;
      if (i < ns) {
        loss_s += sp;
      } else {
        loss_d += sp;
      }
      for (int d0 = 0; d0 < D; d0 += 32 * NJ) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = d0 + lane + 32 * j;
          if (d < D) di[d] = fmaf(g, ldg(wr + d), i ? di[d] : 0.0f);
        }
      }
      if (i < H && i < ns) {  // a hot entry is left for the block's pass
        if (lane == 0) {
          const int slot = (1 << i) - 1 + (i ? __brev(cbits << (32 - i)) : 0);
          hid[slot] = id;
          gh[k * H + i] = g;
          sl[k * H + i] = slot;
        }
      } else {
        g2v_add_row(p.acc + static_cast<size_t>(id) * D1, D1, lane,
                    [&](int d) { return d < D ? __fmul_rn(g, ldg(er + d)) : 1.0f; });
      }
    }
    if (n == 0) {
      for (int d = lane; d < D; d += 32) di[d] = 0.0f;
    }
    if (lane == 0) {
      p.loss_deep[e] = loss_d;
      if (p.sids != nullptr) p.loss_shallow[e] = loss_s;
    }
  }
  if (H == 0) return;
  __syncthreads();
  for (int d = threadIdx.x; d < D1; d += kThreads) {
    for (int k = 0; k < ne; ++k) {
      const float x =
          d < D ? ldg(emb + static_cast<size_t>(__ldg(p.inputs + e_begin + k)) * D + d) : 1.0f;
      for (int i = 0; i < H; ++i) {
        const int slot = sl[k * H + i];
        if (slot < 0) break;
        float* a = hacc + slot * D1 + d;
        *a += d < D ? __fmul_rn(gh[k * H + i], x) : 1.0f;
      }
    }
  }
  __syncthreads();
  for (int slot = warp; slot < nhot; slot += kWarps) {
    const int n = hid[slot];
    if (n < 0) continue;
    const float* row = hacc + slot * D1;
    g2v_add_row(p.acc + static_cast<size_t>(n) * D1, D1, lane, [&](int d) { return row[d]; });
  }
}

constexpr size_t kMaxSmem = 232448;  // the H100's opt-in shared memory a block
constexpr int kMaxNarrowD = 512;     // widths hs_kernel holds in registers

// Shared memory of a block: hs_kernel's, with the block's v rows, or
// hs_wide_kernel's, without.
size_t smem_bytes(int hot, int D, int per_block) {
  const size_t nhot = (1u << hot) - 1;
  const size_t vrows = D <= kMaxNarrowD ? static_cast<size_t>(D) : 0;
  return 4 * (nhot * (D + 1) + nhot + static_cast<size_t>(per_block) * (vrows + 2 * hot));
}

// Lets kKernel take the card's whole opt-in shared memory, once per
// device.
template <auto kKernel>
int allow_smem() {
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

template <auto kKernel>
int launch_at(const HsParams& p, size_t bytes, cudaStream_t stream) {
  const int status = allow_smem<kKernel>();
  if (status != 0) return status;
  const int blocks = (p.E + p.per_block - 1) / p.per_block;
  kKernel<<<blocks, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Columns a lane by D (up to 512; past it the wide kernel), and entries a
// chunk so that a chunk's node values take ~32 registers; hot levels
// lowered until the block's shared memory fits.
template <typename T>
int launch(HsParams p, cudaStream_t stream) {
  while (p.hot > 0 && smem_bytes(p.hot, p.D, p.per_block) > kMaxSmem) --p.hot;
  const size_t bytes = smem_bytes(p.hot, p.D, p.per_block);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (p.D <= 64) return launch_at<hs_kernel<T, 2, 8>>(p, bytes, stream);
  if (p.D <= 128) return launch_at<hs_kernel<T, 4, 4>>(p, bytes, stream);
  if (p.D <= 224) return launch_at<hs_kernel<T, 7, 1>>(p, bytes, stream);
  if (p.D <= 256) return launch_at<hs_kernel<T, 8, 1>>(p, bytes, stream);
  if (p.D <= kMaxNarrowD) return launch_at<hs_kernel<T, 16, 1>>(p, bytes, stream);
  return launch_at<hs_wide_kernel<T>>(p, bytes, stream);
}

}  // namespace

// sids/ssigns null: no shallow levels (loss_shallow untouched).  hot:
// levels reduced in shared memory, 0..7, at most Ls.  per_block: examples
// a block.  bf16: 0 for float32 tables, 1 for bfloat16 (emb and node).
// Takes any D (past 512 the wide kernel).  Returns a CUDA error code.
G2V_EXPORT int k6_hs(const void* emb, const void* node, const int* inputs,
                     const int* targets, const int* points, const float* codes,
                     const int* lengths, int L, const int* sids,
                     const signed char* ssigns, int Ls, float* d_input,
                     float* loss_deep, float* loss_shallow, float* acc_node, int E,
                     int D, int hot, int per_block, int bf16, void* stream) {
  if (E == 0) return 0;
  HsParams p{};
  p.emb = emb;
  p.node = node;
  p.inputs = inputs;
  p.targets = targets;
  p.points = points;
  p.codes = codes;
  p.lengths = lengths;
  p.sids = sids;
  p.ssigns = ssigns;
  p.d_input = d_input;
  p.loss_deep = loss_deep;
  p.loss_shallow = loss_shallow;
  p.acc = acc_node;
  p.L = L;
  p.Ls = Ls;
  p.E = E;
  p.D = D;
  p.hot = sids != nullptr ? max(0, min(hot, min(Ls, 7))) : 0;
  p.per_block = max(per_block, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}
