// K6 — hierarchical softmax, in two phases.
//
// Replaces: gene2vec_tpu/sgns/cbow_hs.py:65-101 (hs_loss_and_grads) and
// the rest of hs_step (:149-160, :197-209), the cbow_hs_step hot path:
// v = emb[inputs]; for each example, the target's padded Huffman path.
//
// Deep phase (the path's node rows, gathered): for l < lengths[t],
//   logit = v . node[points[t, l]],  sign = 1 - 2*codes[t, l],
//   loss_deep += softplus(-sign * logit),
//   g = sigmoid(logit) - (1 - codes[t, l]),
//   d_input += g * node[points[t, l]],
//   acc[points[t, l]] += [g * v | 1].
// Padded entries (l >= length) carry weight 0 and index row 0 in the
// reference; they add exact zeros there, so they are skipped here.
//
// Shallow phase (with hs_dense_depth > 0, the Ns nodes of the first tree
// levels as a contiguous node prefix, one int8 sign row per token):
//   logit_s = v @ W_s^T,  s = sign[targets],
//   loss_shallow = sum |s| * softplus(-s * logit_s),
//   g_s = |s| * (sigmoid(logit_s) - (1 + s)/2),
//   d_input += g_s @ W_s,  acc[:Ns, :D] += g_s^T @ v,  acc[:Ns, D] += sum |s|.
// The step's loss is mean(loss_deep) + mean(loss_shallow) (cbow_hs.py:159).
//
// Bound on the H100: operations, in the shallow phase — three E x Ns x D
// products, 3 * 2 * 8192 * 606 * 200 = 6.0 GFLOP at the bench vocab's
// Ns = 606 (hs_dense_depth 10), ~89 us at the 67 TFLOP/s float32 peak.
// The deep phase moves bytes: v (E x D gathered and written), and per
// example its ~2 deep path nodes read and scattered.
//
// Design: the deep phase is one warp per example, as K1 (which it also
// replaces for this objective: the node table has V - 1 rows, so K1's
// ctx gather does not apply); it writes v for the shallow phase.  The
// shallow phase is noise_gemm.cuh's three GEMMs with the sign epilogue:
// phase 1 writes g_s and counts on-path examples per node, phase 2 adds
// g_s @ W_s into d_input, phase 3 adds the node rows and their weights.
// Both phases take the tables' element type T (emb and node alike): the
// deep phase loads input and node rows element-wise as float32, the
// shallow GEMMs stage the node prefix through noise_gemm.cuh's T.
#include "noise_gemm.cuh"

namespace {

template <typename T>
__global__ void hs_deep_kernel(const T* __restrict__ emb,
                               const T* __restrict__ node,
                               const int* __restrict__ inputs,
                               const int* __restrict__ targets,
                               const int* __restrict__ points,
                               const float* __restrict__ codes,
                               const int* __restrict__ lengths, int L, int E,
                               int D, float* __restrict__ v_out,
                               float* __restrict__ d_input,
                               float* __restrict__ loss_deep,
                               float* __restrict__ acc) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= E) return;  // warp-uniform
  const T* er = emb + static_cast<size_t>(inputs[e]) * D;
  float* vr = v_out + static_cast<size_t>(e) * D;
  float* di = d_input + static_cast<size_t>(e) * D;
  for (int d = lane; d < D; d += 32) {
    vr[d] = g2v_ld(er + d);
    di[d] = 0.0f;
  }
  const int t = targets[e];
  const int len = min(lengths[t], L);
  const int D1 = D + 1;
  float loss = 0.0f;
  for (int l = 0; l < len; ++l) {
    const int n = points[static_cast<size_t>(t) * L + l];
    const float code = codes[static_cast<size_t>(t) * L + l];
    const T* wr = node + static_cast<size_t>(n) * D;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(g2v_ld(er + d), g2v_ld(wr + d), s);
    s = g2v_warp_sum(s);
    const float sign = 1.0f - 2.0f * code;
    loss += g2v_softplus(-sign * s);
    const float g = g2v_sigmoid(s) - (1.0f - code);
    float* ar = acc + static_cast<size_t>(n) * D1;
    for (int d = lane; d < D; d += 32) {
      di[d] = fmaf(g, g2v_ld(wr + d), di[d]);
      atomicAdd(&ar[d], __fmul_rn(g, g2v_ld(er + d)));
    }
    if (lane == 0) atomicAdd(&ar[D], 1.0f);
  }
  if (lane == 0) loss_deep[e] = loss;
}

}  // namespace

// bf16: 0 for float32 tables, 1 for bfloat16 tables (emb and node alike).
G2V_EXPORT int k6_hs(const void* emb, const void* node, const int* inputs,
                     const int* targets, const int* points, const float* codes,
                     const int* lengths, int L, const signed char* sign, int Ns,
                     float* v_out, float* d_input, float* loss_deep,
                     float* loss_shallow, float* g_scratch, int* hits,
                     float* acc_node, int E, int D, int splits, int bf16,
                     void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (E * 32 + threads - 1) / threads;
  if (bf16) {
    hs_deep_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(emb), static_cast<const __nv_bfloat16*>(node),
        inputs, targets, points, codes, lengths, L, E, D, v_out, d_input, loss_deep,
        acc_node);
  } else {
    hs_deep_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(emb), static_cast<const float*>(node), inputs,
        targets, points, codes, lengths, L, E, D, v_out, d_input, loss_deep, acc_node);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || Ns == 0) return static_cast<int>(err);
  g2v::NoiseParams p{};
  p.v = v_out;
  p.ctx = node;          // the shallow nodes are rows [0, Ns)
  p.sign = sign;
  p.targets = targets;
  p.g = g_scratch;
  p.hits = hits;
  p.loss = loss_shallow;
  p.d_center = d_input;
  p.acc = acc_node;
  p.D = D;
  p.S = Ns;
  p.Eg = E;
  p.splits = splits;
  p.init_center = 0;     // d_input = deep + g_s @ W_s
  return g2v::launch_noise_as<g2v::Slab::kSign>(p, 1, bf16, s);
}
