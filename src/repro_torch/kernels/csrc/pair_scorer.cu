// Fused (UE, server) pair scorer of the entity route policy, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pair_scorer.py::
// pair_scorer_pallas (_scorer_kernel). For N UEs and E servers it computes
// the fleet-wide occupancy per_slot = sum(active) / (E C), the server rows
// [g0, g1, g2 / EDGE_SLOW_NORM, per_slot] and their tanh embedding (E, S),
// and for every (UE, server) pair the three edge features (distance,
// clean-rate proxy, edge seconds) and the pair MLP whose first layer is
// split by input block:
//   logit = tanh(ue W1u + srv_e W1s + edge W1e + b1) . w2 + b2.
//
// Bound on the H100: at the serving size (N = 1024, E = 3, d_ue = 128,
// S = 32, H = 48) the least work is ~14 MFLOP and ~0.6 MB, a fraction of a
// microsecond of either, so the launch itself bounds it. The design keeps
// it one launch: the TPU's sequential 256-row grid becomes 8-row blocks
// that run in parallel (128 blocks at N = 1024, so every SM holds one and
// the dependent FMA chains of many blocks overlap); the fleet-wide occupancy,
// which the TPU kernel recomputes in every block from the full active row,
// is recomputed the same way here (each block sums all N values in one
// fixed order, exact for 0/1 values below 2^24), so no atomics, no grid
// sync and no second pass; equal occupancy gives bitwise-equal logits by
// construction. Every block computes the (E, S) embeddings and their W1s
// term into shared memory; only block 0 writes the embeddings out.
// Products are f32 FMA on the SIMT cores (the reference's 1e-5 tolerance
// rules out TF32): the ue term (8 rows x 128) @ (128 x 48) once per block
// from shared memory, then one warp per (UE, server) pair with lanes over
// the hidden units and a shuffle reduction for the logit.
//
// C interface for ctypes: pointers as void*, the CUDA stream as void*, and
// the return value is cudaGetLastError() after the launch. Nothing is
// allocated here.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;        // UEs per block: 128 blocks at N = 1024
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSrvRow = 4;      // [dist_scale, bw_scale, slowness, per_slot]
constexpr int kEdge = 3;        // [distance, rate proxy, edge seconds]

// consts layout (MECEnv._scorer_consts)
constexpr int C_PATHLOSS = 0, C_PMAX = 1, C_SIGMA = 2, C_RATE_SCALE = 3;
constexpr int C_T0 = 4, C_SLOT_DIV = 5, C_DIST_NORM = 6, C_SLOW_INV = 7;

size_t smem_floats(int n_srv, int d_ue, int s_dim, int hid) {
  return (size_t)(d_ue + s_dim + kEdge) * hid   // W1
         + (size_t)n_srv * s_dim                 // server embeddings
         + (size_t)n_srv * hid                   // their W1s term
         + (size_t)kRows * d_ue                  // the block's UE rows
         + (size_t)kRows * hid                   // their W1u term
         + kWarps + 1;                           // occupancy partials
}

__global__ void __launch_bounds__(kThreads)
pair_scorer_kernel(const float* __restrict__ ue, const float* __restrict__ d,
                   const float* __restrict__ work, const float* __restrict__ active,
                   const float* __restrict__ geom, const float* __restrict__ consts,
                   const float* __restrict__ w_srv, const float* __restrict__ b_srv,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   float* __restrict__ logits, float* __restrict__ srv_out,
                   int n, int n_srv, int d_ue, int s_dim, int hid) {
  extern __shared__ float sm[];
  float* w1_s = sm;
  float* semb = w1_s + (d_ue + s_dim + kEdge) * hid;
  float* srvh = semb + n_srv * s_dim;
  float* ue_s = srvh + n_srv * hid;
  float* ueh = ue_s + kRows * d_ue;
  float* red = ueh + kRows * hid;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);

  // 1. occupancy over the FULL fleet, the same fixed order in every block
  float part = 0.0f;
  for (int i = tid; i < n; i += kThreads) part += active[i];
  for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o);
  if (lane == 0) red[warp] = part;
  for (int i = tid; i < (d_ue + s_dim + kEdge) * hid; i += kThreads) w1_s[i] = w1[i];
  for (int i = tid; i < rows * d_ue; i += kThreads) ue_s[i] = ue[(size_t)row0 * d_ue + i];
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += red[w];
    red[kWarps] = __fdiv_rn(total, consts[C_SLOT_DIV]);
  }
  __syncthreads();
  const float per_slot = red[kWarps];

  // 2. server rows and their tanh embedding
  const float slow_inv = consts[C_SLOW_INV];
  for (int i = tid; i < n_srv * s_dim; i += kThreads) {
    const int e = i / s_dim, j = i - e * s_dim;
    const float row[kSrvRow] = {geom[e * 3 + 0], geom[e * 3 + 1],
                                geom[e * 3 + 2] * slow_inv, per_slot};
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kSrvRow; ++k) acc = fmaf(row[k], w_srv[k * s_dim + j], acc);
    const float v = tanhf(acc + b_srv[j]);
    semb[i] = v;
    if (blockIdx.x == 0) srv_out[i] = v;
  }
  // 3. the ue block of the first layer: once per UE, not per pair
  for (int i = tid; i < rows * hid; i += kThreads) {
    const int r = i / hid, h = i - r * hid;
    const float* x = ue_s + r * d_ue;
    float acc = 0.0f;
    for (int k = 0; k < d_ue; ++k) acc = fmaf(x[k], w1_s[k * hid + h], acc);
    ueh[i] = acc;
  }
  __syncthreads();
  // 4. the server block of the first layer
  for (int i = tid; i < n_srv * hid; i += kThreads) {
    const int e = i / hid, h = i - e * hid;
    float acc = 0.0f;
    for (int j = 0; j < s_dim; ++j) acc = fmaf(semb[e * s_dim + j], w1_s[(d_ue + j) * hid + h], acc);
    srvh[i] = acc;
  }
  __syncthreads();

  // 5. one warp per (UE, server) pair: edge columns, tanh layer, logit
  const float* w1e = w1_s + (d_ue + s_dim) * hid;
  const float pathloss = consts[C_PATHLOSS], pmax = consts[C_PMAX];
  const float sigma = consts[C_SIGMA], rate_scale = consts[C_RATE_SCALE];
  const float t0 = consts[C_T0], dist_norm = consts[C_DIST_NORM];
  for (int p = warp; p < rows * n_srv; p += kWarps) {
    const int r = p / n_srv, e = p - r * n_srv;
    const int row = row0 + r;
    const float g0 = geom[e * 3 + 0], g1 = geom[e * 3 + 1], g2 = geom[e * 3 + 2];
    const float dist = d[row] * g0;
    const float gain = powf(fmaxf(dist, 1.0f), -pathloss);
    const float rate = g1 * rate_scale * log2f(1.0f + pmax * gain / sigma);
    const float te = work[row] * g2 / t0;
    const float dn = dist / dist_norm;
    float acc = 0.0f;
    for (int h = lane; h < hid; h += 32) {
      const float edge = fmaf(te, w1e[2 * hid + h], fmaf(rate, w1e[hid + h], dn * w1e[h]));
      const float pre = ueh[r * hid + h] + srvh[e * hid + h] + edge + b1[h];
      acc = fmaf(tanhf(pre), w2[h], acc);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) logits[(size_t)row * n_srv + e] = acc + b2[0];
  }
}

}  // namespace

// ue: (n, d_ue); d, work, active: (n,); geom: (n_srv, 3); consts: (8,);
// w_srv: (4, s_dim); b_srv: (s_dim,); w1: (d_ue + s_dim + 3, hid); b1:
// (hid,); w2: (hid, 1); b2: (1,); logits: (n, n_srv); srv: (n_srv, s_dim).
// All float32, contiguous.
extern "C" int repro_pair_scorer(const void* ue, const void* d, const void* work,
                                 const void* active, const void* geom, const void* consts,
                                 const void* w_srv, const void* b_srv, const void* w1,
                                 const void* b1, const void* w2, const void* b2,
                                 void* logits, void* srv, int n, int n_srv, int d_ue,
                                 int s_dim, int hid, void* stream) {
  if (n <= 0 || n_srv <= 0 || d_ue <= 0 || s_dim <= 0 || hid <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(n_srv, d_ue, s_dim, hid) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pair_scorer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  pair_scorer_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ue), static_cast<const float*>(d),
      static_cast<const float*>(work), static_cast<const float*>(active),
      static_cast<const float*>(geom), static_cast<const float*>(consts),
      static_cast<const float*>(w_srv), static_cast<const float*>(b_srv),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(logits), static_cast<float*>(srv), n, n_srv, d_ue, s_dim, hid);
  return (int)cudaGetLastError();
}
