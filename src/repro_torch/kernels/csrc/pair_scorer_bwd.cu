// Backward of the fused (UE, server) pair scorer (pair_scorer.cu), for
// Hopper (sm_90a).
//
// The reference has no backward kernel: on the CPU it differentiates
// src/repro/kernels/pair_scorer.py::pair_scorer_xla. This kernel computes,
// for incoming gradients g = d logits (B, N, E) and gs = d srv (B, E, S),
// with a = ue W1u + srv_e W1s + edge W1e + b1, h = tanh(a) and
// da = g w2 tanh'(a) for every (env, UE, server) pair:
//   u       = sum_e da                        (B, N, H), per UE;
//   dW1s    = sum_{b,e} srv^T (sum_n da)      the server rows of dW1;
//   dW1e    = sum edge^T da, db1 = sum da, dw2 = sum g h, db2 = sum g;
//   d srv   = (sum_n da) W1s^T + gs, through the server tanh into
//   dw_srv  = sum rows^T dpre and db_srv = sum dpre, with rows the server
//             rows [g0, g1, g2 / EDGE_SLOW_NORM, per_slot].
// tanh'(x) is taken as sech^2 x = 4 t / (1 + t)^2 with t = exp(-2|x|), from
// the pre-activation, not as 1 - tanh^2: where tanh rounds to 1 in float32
// (|x| > 9, as the server rows' per_slot term of a 1024-UE fleet gives)
// 1 - tanh^2 is 0 and the float32 gradient loses every digit, while sech^2
// keeps its own (the float64 twin agrees to 1e-5 of each gradient).
//
// The two products with W1u (d ue = u W1u^T, dW1u = ue^T u) are left to
// the caller (plain GEMMs, as the reference's dots outside its kernel).
//
// Design: one launch on the forward's grid (N / 8, B). A block of 8 UEs of
// one env loads W1 and its rows, recomputes the ue and server terms of the
// first layer and each pair's edge triple exactly as the forward does,
// forms da and g h per (pair, hidden unit) in shared memory, writes u for
// its UEs and its partial sums (the env's server sums E x H, the edge
// weights 3 x H, b1, w2, b2) to a workspace. The env's blocks then take an
// integer ticket; the last to arrive sums the env's partials in block
// order, computes the env's per_slot (every active value, in one fixed
// order), d srv and the server tail, and writes one result of S H + 5 S +
// 5 H + 1 floats. The envs' results are summed by a tree of tails of 16:
// the last of each 16 to arrive sums the 16 in order, up to one. Every sum
// runs in a fixed order and no float is added atomically, so the same call
// gives the same bits (the integer tickets only choose which block sums).
// Products are f32 FMA on the SIMT cores.
//
// C interface for ctypes: pointers as void*, the CUDA stream as void*, and
// the return value is cudaGetLastError() after the launch. The workspace
// and the zeroed tickets are the caller's, sized by
// repro_pair_scorer_backward_plan.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr int kRows = 8;          // UEs a block, as the forward
constexpr int kThreads = 256;
constexpr int kFan = 16;          // results a tail of the tree sums
constexpr int kEdge = 3;          // [distance, rate proxy, edge seconds]

// consts layout (MECEnv._scorer_consts)
constexpr int C_PATHLOSS = 0, C_PMAX = 1, C_SIGMA = 2, C_RATE_SCALE = 3;
constexpr int C_T0 = 4, C_SLOT_DIV = 5, C_DIST_NORM = 6, C_SLOW_INV = 7;

// tanh'(x) = sech^2 x, accurate where tanh x rounds to +-1
__device__ __forceinline__ float dtanh(float x) {
  const float t = expf(-2.0f * fabsf(x)), u = 1.0f + t;
  return 4.0f * t / (u * u);
}

// Shared memory, in floats. kernels/pair_scorer.py reads the total from
// repro_pair_scorer_backward_plan.
struct BwdLayout {
  int w1, ue, ueh, srv, srvh, b1, w2, g, edge, da, gh, vs, ps, dpre, rows, red, flag, floats;
  __host__ __device__ BwdLayout(int n_srv, int d_ue, int s_dim, int hid) {
    const int k1 = d_ue + s_dim + kEdge, pairs = kRows * n_srv;
    int o = 0;
    w1 = o;   o += k1 * hid;          // W1: d_ue ue rows, S server rows, 3 edge rows
    ue = o;   o += kRows * d_ue;      // the block's UE rows (zero past N)
    ueh = o;  o += kRows * hid;       // their W1u term
    srv = o;  o += n_srv * s_dim;     // the env's server embeddings
    srvh = o; o += n_srv * hid;       // their W1s term
    b1 = o;   o += hid;
    w2 = o;   o += hid;
    g = o;    o += pairs;             // d logits of the block's pairs (zero past N)
    edge = o; o += pairs * kEdge;
    da = o;   o += pairs * hid;
    gh = o;   o += pairs * hid;       // g h, for dw2
    vs = o;   o += n_srv * hid;       // tail: the env's sum_n da
    ps = o;   o += 5 * hid + 1;       // tail: the env's edge-weight and bias sums
    dpre = o; o += n_srv * s_dim;     // tail: d srv through the tanh
    rows = o; o += n_srv * 4;         // tail: the server rows
    red = o;  o += kThreads;          // tail: the occupancy's partial sums
    flag = o; o += 1;                 // an int: this block arrived last (no static
                                      // shared memory: the opt-in takes the whole block)
    floats = o;
  }
  size_t bytes() const { return (size_t)floats * sizeof(float); }
};

// A block's partials: [sum_n da: E H][edge weights: 3 H][b1: H][w2: H][b2: 1];
// an env's (and a tree node's) result: [dW1s: S H][dw_srv: 4 S][db_srv: S]
// then the same 5 H + 1 as a block's tail.
__host__ __device__ inline int part_floats(int n_srv, int hid) { return n_srv * hid + 5 * hid + 1; }
__host__ __device__ inline int result_floats(int s_dim, int hid) {
  return s_dim * hid + 5 * s_dim + 5 * hid + 1;
}

struct Grads {
  float *dw_srv, *db_srv, *dw1, *db1, *dw2, *db2;
  int d_ue, s_dim, hid;
  // element j of a result, to its place in the outputs
  __device__ void put(int j, float v) const {
    const int sh = s_dim * hid;
    if (j < sh) {
      dw1[(size_t)d_ue * hid + j] = v;              // rows d_ue .. d_ue + S
    } else if (j < sh + 4 * s_dim) {
      dw_srv[j - sh] = v;
    } else if (j < sh + 5 * s_dim) {
      db_srv[j - sh - 4 * s_dim] = v;
    } else {
      const int k = j - sh - 5 * s_dim;
      if (k < 3 * hid) dw1[(size_t)(d_ue + s_dim) * hid + k] = v;   // the 3 edge rows
      else if (k < 4 * hid) db1[k - 3 * hid] = v;
      else if (k < 5 * hid) dw2[k - 4 * hid] = v;
      else db2[0] = v;
    }
  }
};

// Every thread's writes are made visible, then one ticket is taken; true in
// every thread of the block that arrives last of `members` (which then sees
// the others' writes).
__device__ __forceinline__ bool last_to_arrive(int* ticket, int members, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(ticket, 1) == members - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

__global__ void __launch_bounds__(kThreads)
pair_scorer_backward_kernel(const float* __restrict__ ue, const float* __restrict__ d,
                            const float* __restrict__ work, const float* __restrict__ active,
                            const float* __restrict__ geom, const float* __restrict__ consts,
                            const float* __restrict__ w_srv, const float* __restrict__ b_srv,
                            const float* __restrict__ w1, const float* __restrict__ b1,
                            const float* __restrict__ w2, const float* __restrict__ srv_in,
                            const float* __restrict__ g_logits, const float* __restrict__ g_srv,
                            float* __restrict__ u_out, Grads out, float* ws, int* tickets,
                            int n, int n_srv, int d_ue, int s_dim, int hid, int batch) {
  extern __shared__ __align__(16) float sm[];
  const BwdLayout L(n_srv, d_ue, s_dim, hid);
  int* last = reinterpret_cast<int*>(sm + L.flag);
  const int tid = threadIdx.x;
  const int env = blockIdx.y, bx = blockIdx.x, nbx = gridDim.x;
  const int row0 = bx * kRows, rows = min(kRows, n - row0);
  const int pairs = kRows * n_srv, k1 = d_ue + s_dim + kEdge;
  const int pb = part_floats(n_srv, hid), res = result_floats(s_dim, hid);
  const size_t n_parts = (size_t)nbx * batch;
  const float* ue_b = ue + ((size_t)env * n + row0) * d_ue;
  const float* d_b = d + (size_t)env * n;
  const float* work_b = work + (size_t)env * n;
  const float* act_b = active + (size_t)env * n;
  const float* geom_b = geom + (size_t)env * n_srv * 3;
  const float* srv_b = srv_in + (size_t)env * n_srv * s_dim;
  const float* g_b = g_logits + ((size_t)env * n + row0) * n_srv;
  const float* gs_b = g_srv + (size_t)env * n_srv * s_dim;
  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = consts[k];

  for (int i = tid; i < k1 * hid; i += kThreads) sm[L.w1 + i] = w1[i];
  for (int i = tid; i < kRows * d_ue; i += kThreads)
    sm[L.ue + i] = i / d_ue < rows ? ue_b[i] : 0.0f;
  for (int i = tid; i < n_srv * s_dim; i += kThreads) sm[L.srv + i] = srv_b[i];
  for (int i = tid; i < hid; i += kThreads) {
    sm[L.b1 + i] = b1[i];
    sm[L.w2 + i] = w2[i];
  }
  for (int i = tid; i < pairs; i += kThreads) sm[L.g + i] = i / n_srv < rows ? g_b[i] : 0.0f;
  __syncthreads();

  // the first layer's ue and server terms, and each pair's edge triple as
  // the forward builds it
  for (int i = tid; i < kRows * hid; i += kThreads) {
    const int r = i / hid, h = i - r * hid;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < d_ue; ++k) acc = fmaf(sm[L.ue + r * d_ue + k], sm[L.w1 + k * hid + h], acc);
    sm[L.ueh + i] = acc;
  }
  for (int i = tid; i < n_srv * hid; i += kThreads) {
    const int e = i / hid, h = i - e * hid;
    float acc = 0.0f;
#pragma unroll 8
    for (int s = 0; s < s_dim; ++s)
      acc = fmaf(sm[L.srv + e * s_dim + s], sm[L.w1 + (d_ue + s) * hid + h], acc);
    sm[L.srvh + i] = acc;
  }
  for (int i = tid; i < pairs; i += kThreads) {
    const int r = i / n_srv, e = i - r * n_srv;
    const bool valid = r < rows;
    const float dd = valid ? d_b[row0 + r] : 0.0f, ww = valid ? work_b[row0 + r] : 0.0f;
    const float dist = dd * geom_b[e * 3 + 0];
    const float gain = powf(fmaxf(dist, 1.0f), -c[C_PATHLOSS]);
    float* o = sm + L.edge + i * kEdge;
    o[0] = dist / c[C_DIST_NORM];
    o[1] = geom_b[e * 3 + 1] * c[C_RATE_SCALE] * log2f(1.0f + c[C_PMAX] * gain / c[C_SIGMA]);
    o[2] = ww * geom_b[e * 3 + 2] / c[C_T0];
  }
  __syncthreads();

  // da and g h for every (pair, hidden unit)
  const float* w1e = sm + L.w1 + (d_ue + s_dim) * hid;
  for (int i = tid; i < pairs * hid; i += kThreads) {
    const int p = i / hid, h = i - p * hid;
    const int r = p / n_srv, e = p - r * n_srv;
    const float* ed = sm + L.edge + p * kEdge;
    const float ew = fmaf(ed[2], w1e[2 * hid + h], fmaf(ed[1], w1e[hid + h], ed[0] * w1e[h]));
    const float pre = sm[L.ueh + r * hid + h] + sm[L.srvh + e * hid + h] + ew + sm[L.b1 + h];
    const float gp = sm[L.g + p];
    sm[L.da + i] = gp * sm[L.w2 + h] * dtanh(pre);
    sm[L.gh + i] = gp * tanhf(pre);
  }
  __syncthreads();

  // u for the block's UEs; the block's partials, each in pair order
  for (int i = tid; i < rows * hid; i += kThreads) {
    const int r = i / hid, h = i - r * hid;
    float acc = 0.0f;
    for (int e = 0; e < n_srv; ++e) acc += sm[L.da + (r * n_srv + e) * hid + h];
    u_out[((size_t)env * n + row0 + r) * hid + h] = acc;
  }
  float* part = ws + ((size_t)env * nbx + bx) * pb;
  for (int i = tid; i < n_srv * hid; i += kThreads) {
    const int e = i / hid, h = i - e * hid;
    float acc = 0.0f;
    for (int r = 0; r < kRows; ++r) acc += sm[L.da + (r * n_srv + e) * hid + h];
    part[i] = acc;
  }
  for (int i = tid; i < 5 * hid + 1; i += kThreads) {
    float acc = 0.0f;
    if (i < 3 * hid) {
      const int k = i / hid, h = i - k * hid;
      for (int p = 0; p < pairs; ++p) acc = fmaf(sm[L.edge + p * kEdge + k], sm[L.da + p * hid + h], acc);
    } else if (i < 4 * hid) {
      for (int p = 0; p < pairs; ++p) acc += sm[L.da + p * hid + i - 3 * hid];
    } else if (i < 5 * hid) {
      for (int p = 0; p < pairs; ++p) acc += sm[L.gh + p * hid + i - 4 * hid];
    } else {
      for (int p = 0; p < pairs; ++p) acc += sm[L.g + p];
    }
    part[n_srv * hid + i] = acc;
  }
  if (!last_to_arrive(tickets + env, nbx, last)) return;

  // ---- the env's tail, in the env's last block
  const float* parts = ws + (size_t)env * nbx * pb;
  for (int i = tid; i < pb; i += kThreads) {
    float acc = 0.0f;
#pragma unroll 8
    for (int b = 0; b < nbx; ++b) acc += __ldcg(parts + (size_t)b * pb + i);
    sm[(i < n_srv * hid ? L.vs : L.ps - n_srv * hid) + i] = acc;
  }
  // the occupancy over the env's fleet, in one fixed order
  float occ = 0.0f;
  for (int i = tid; i < n; i += kThreads) occ += act_b[i];
  sm[L.red + tid] = occ;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (tid < o) sm[L.red + tid] += sm[L.red + tid + o];
    __syncthreads();
  }
  const float per_slot = __fdiv_rn(sm[L.red], c[C_SLOT_DIV]);
  for (int i = tid; i < n_srv * 4; i += kThreads) {
    const int e = i / 4, r = i - e * 4;
    sm[L.rows + i] = r < 2 ? geom_b[e * 3 + r] : r == 2 ? geom_b[e * 3 + 2] * c[C_SLOW_INV]
                                                          : per_slot;
  }
  __syncthreads();
  for (int i = tid; i < n_srv * s_dim; i += kThreads) {
    const int e = i / s_dim, s = i - e * s_dim;
    float acc = 0.0f;
#pragma unroll 8
    for (int h = 0; h < hid; ++h)
      acc = fmaf(sm[L.vs + e * hid + h], sm[L.w1 + (d_ue + s) * hid + h], acc);
    // the server row's pre-activation, summed as the forward sums it
    const float* row = sm + L.rows + e * 4;
    const float pre = fmaf(row[3], w_srv[3 * s_dim + s],
                           fmaf(row[2], w_srv[2 * s_dim + s],
                                fmaf(row[1], w_srv[s_dim + s], fmaf(row[0], w_srv[s], 0.0f)))) +
                      b_srv[s];
    sm[L.dpre + i] = (acc + gs_b[i]) * dtanh(pre);
  }
  __syncthreads();
  float* env_res = ws + n_parts * pb + (size_t)env * res;
  const int sh = s_dim * hid;
  for (int j = tid; j < res; j += kThreads) {
    float acc = 0.0f;
    if (j < sh) {
      const int s = j / hid, h = j - s * hid;
      for (int e = 0; e < n_srv; ++e) acc = fmaf(sm[L.srv + e * s_dim + s], sm[L.vs + e * hid + h], acc);
    } else if (j < sh + 4 * s_dim) {
      const int r = (j - sh) / s_dim, s = j - sh - r * s_dim;
      for (int e = 0; e < n_srv; ++e) acc = fmaf(sm[L.rows + e * 4 + r], sm[L.dpre + e * s_dim + s], acc);
    } else if (j < sh + 5 * s_dim) {
      for (int e = 0; e < n_srv; ++e) acc += sm[L.dpre + e * s_dim + j - sh - 4 * s_dim];
    } else {
      acc = sm[L.ps + j - sh - 5 * s_dim];
    }
    if (batch == 1) out.put(j, acc);
    else env_res[j] = acc;
  }
  if (batch == 1) return;

  // ---- the tree of tails over the envs' results
  const float* src = ws + n_parts * pb;
  size_t next_buf = n_parts * pb + (size_t)batch * res;
  int count = batch, idx = env, tick = batch;
  while (count > 1) {
    const int group = idx / kFan, members = min(kFan, count - group * kFan);
    const int next = (count + kFan - 1) / kFan;
    if (!last_to_arrive(tickets + tick + group, members, last)) return;
    float* dst = next > 1 ? ws + next_buf : nullptr;
    for (int j = tid; j < res; j += kThreads) {
      float acc = 0.0f;
      for (int m = 0; m < members; ++m) acc += __ldcg(src + (size_t)(group * kFan + m) * res + j);
      if (dst) dst[(size_t)group * res + j] = acc;
      else out.put(j, acc);
    }
    src = dst;
    if (next > 1) next_buf += (size_t)next * res;
    tick += next;
    idx = group;
    count = next;
  }
}

}  // namespace

// The backward's needs for these sizes: its dynamic shared memory, the
// float workspace (each block's partials, each env's result and each
// group result of the tree's levels below its root) and the int tickets
// (one an env, one a group), which the caller zeroes.
extern "C" int repro_pair_scorer_backward_plan(int n, int n_srv, int batch, int d_ue, int s_dim,
                                               int hid, long long* smem_bytes,
                                               long long* workspace, int* tickets) {
  if (n <= 0 || n_srv <= 0 || batch <= 0 || d_ue <= 0 || s_dim <= 0 || hid <= 0)
    return (int)cudaErrorInvalidValue;
  *smem_bytes = (long long)BwdLayout(n_srv, d_ue, s_dim, hid).bytes();
  const long long res = result_floats(s_dim, hid);
  long long floats = (long long)((n + kRows - 1) / kRows) * batch * part_floats(n_srv, hid) +
                     (long long)batch * res;
  int count = batch, ints = batch;
  while (count > 1) {          // the tree's levels, as the kernel walks them
    count = (count + kFan - 1) / kFan;
    ints += count;
    if (count > 1) floats += (long long)count * res;
  }
  *workspace = floats;
  *tickets = ints;
  return 0;
}

// ue: (batch, n, d_ue); d, work, active: (batch, n); geom: (batch, n_srv,
// 3); consts: (8,); w_srv: (4, s_dim); b_srv: (s_dim,); w1: (d_ue + s_dim
// + 3, hid); b1:
// (hid,); w2: (hid, 1); b2: (1,) (not read); srv: (batch, n_srv, s_dim),
// the forward's; g: (batch, n, n_srv); gs: (batch, n_srv, s_dim). Out: u
// (batch, n, hid); dw_srv (4, s_dim); db_srv (s_dim,); dw1 (d_ue + s_dim +
// 3, hid), all but its first d_ue rows; db1 (hid,); dw2 (hid, 1); db2 (1,).
// ws and tickets as repro_pair_scorer_backward_plan sizes them, tickets
// zeroed. All float32,
// contiguous. smem_bytes: the planner's, checked against the layout.
extern "C" int repro_pair_scorer_backward(
    const void* ue, const void* d, const void* work, const void* active, const void* geom,
    const void* consts, const void* w_srv, const void* b_srv, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* srv, const void* g, const void* gs, void* u,
    void* dw_srv, void* db_srv, void* dw1, void* db1, void* dw2, void* db2, void* ws,
    void* tickets, int n, int n_srv, int d_ue, int s_dim, int hid, int batch,
    long long smem_bytes, void* stream) {
  (void)b2;
  if (n <= 0 || n_srv <= 0 || d_ue <= 0 || s_dim <= 0 || hid <= 0 || batch <= 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const BwdLayout L(n_srv, d_ue, s_dim, hid);
  if ((long long)L.bytes() != smem_bytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<pair_scorer_backward_kernel>(L.bytes());
  if (err != cudaSuccess) {
    (void)cudaGetLastError();   // do not leave it for the next launch's check
    return (int)err;
  }
  Grads out{static_cast<float*>(dw_srv), static_cast<float*>(db_srv), static_cast<float*>(dw1),
            static_cast<float*>(db1),    static_cast<float*>(dw2),    static_cast<float*>(db2),
            d_ue, s_dim, hid};
  const dim3 grid((n + kRows - 1) / kRows, batch);
  pair_scorer_backward_kernel<<<grid, kThreads, L.bytes(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ue), static_cast<const float*>(d),
      static_cast<const float*>(work), static_cast<const float*>(active),
      static_cast<const float*>(geom), static_cast<const float*>(consts),
      static_cast<const float*>(w_srv), static_cast<const float*>(b_srv),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(srv),
      static_cast<const float*>(g), static_cast<const float*>(gs), static_cast<float*>(u), out,
      static_cast<float*>(ws), static_cast<int*>(tickets), n, n_srv, d_ue, s_dim, hid, batch);
  return (int)cudaGetLastError();
}
