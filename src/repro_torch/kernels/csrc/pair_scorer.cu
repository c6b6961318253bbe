// Fused (UE, server) pair scorer of the entity route policy, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pair_scorer.py::
// pair_scorer_pallas (_scorer_kernel), and the reference's vmap of it over
// envs: the grid is (N / 8, B), block (x, b) scoring 8 UEs of env b and
// reading only that env's rows. For each env's N UEs and E servers it
// computes
// the fleet-wide occupancy per_slot = sum(active) / (E C), the server rows
// [g0, g1, g2 / EDGE_SLOW_NORM, per_slot] and their tanh embedding (E, S),
// and for every (UE, server) pair the three edge features (distance,
// clean-rate proxy, edge seconds) and the pair MLP whose first layer is
// split by input block:
//   logit = tanh(ue W1u + srv_e W1s + edge W1e + b1) . w2 + b2.
//
// Bound on the H100: at the serving size (N = 1024, E = 3, d_ue = 128,
// S = 32, H = 48) the least work is ~14 MFLOP and ~0.6 MB, a fraction of a
// microsecond of either. What bounds the kernel is the length of its
// critical path inside one launch: the weight copy's latency, then chains
// of dependent FMAs and loads, each phase waiting for the last. The design
// shortens that path:
//   * one launch of 8-UE blocks (128 at N = 1024, one an SM), times B envs;
//   * at entry the first lanes of two warps start bulk copies of W1 and of
//     the block's UE rows into shared memory on an mbarrier (ordinary
//     loads where a size or an address is not a multiple of 16 bytes: the
//     "loads" route, chosen before the launch by kernels/pair_scorer.py);
//   * the work splits by warp with no barrier between independent phases:
//     six warps load b1, w2 and their pair's edge inputs while the copy is
//     in flight, then compute the ue term (8 x d_ue) @ (d_ue x H), each
//     thread a 2 x 4 register tile over a quarter of K, its partial sums
//     joined by a fixed-order lane butterfly (serial depth 32, not 128),
//     then each pair's edge triple once; meanwhile two warps compute the
//     occupancy (every block sums all N values of active in one fixed
//     order, exact for 0/1 values below 2^24: no atomics, no grid sync, and
//     equal occupancy gives bitwise-equal logits by construction), the
//     server rows' terms that do not need it, the (E, S) embedding and its
//     W1s term; one block barrier joins the two sides;
//   * the pair stage spreads (pair, hidden unit) over 8 lanes a pair, with
//     no transcendental repeated, and sums each pair's dot with w2 by a
//     fixed-order butterfly.
// Measured on the H100 (PERF.md; clock64 stamps in a copy of this kernel):
// the copies land about 0.8 us after entry; the ue term and the edge
// triples then take about 1.8 us and set the join; the pair stage takes
// about 0.75 us. The edge triples on the server warps made the kernel
// slower on the card.
// Products are f32 FMA on the SIMT cores (the reference's 1e-5 tolerance
// rules out single TF32).
//
// C interface for ctypes: pointers as void*, the CUDA stream as void*, and
// the return value is cudaGetLastError() after the launch. Nothing is
// allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr int kRows = 8;          // UEs a block: 128 blocks at N = 1024
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUeWarps = 6;       // the ue term; the other two warps the server side
constexpr int kUeThreads = kUeWarps * 32;
constexpr int kSrvThreads = kThreads - kUeThreads;
constexpr int kTileRows = 2;      // a thread's ue-term tile: 2 rows x 4 columns
constexpr int kPairLanes = 8;     // lanes a (UE, server) pair
constexpr int kOccUnroll = 16;    // occupancy loads in flight a thread (N = 1024: all)
constexpr int kSrvRow = 4;        // [dist_scale, bw_scale, slowness, per_slot]
constexpr int kEdge = 3;          // [distance, rate proxy, edge seconds]

// consts layout (MECEnv._scorer_consts)
constexpr int C_PATHLOSS = 0, C_PMAX = 1, C_SIGMA = 2, C_RATE_SCALE = 3;
constexpr int C_T0 = 4, C_SLOT_DIV = 5, C_DIST_NORM = 6, C_SLOW_INV = 7;

// A barrier of the `threads` threads (whole warps) that use barrier `id`
// (0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// acc[r][c] += sum over k in [k0, k1) of a[r lda + k] w[k ldw + c], for TR
// rows and 4 columns: 4 TR independent FMA chains a thread. a, w, lda, ldw,
// k0 and k1 are multiples of 4 floats (16-byte shared loads); each
// accumulator sums in k order.
template <int TR>
__device__ __forceinline__ void tile_dot(const float* a, int lda, const float* w, int ldw,
                                         int k0, int k1, float (&acc)[TR][4]) {
  for (int k = k0; k < k1; k += 4) {
    float4 av[TR], wv[4];
#pragma unroll
    for (int r = 0; r < TR; ++r) av[r] = *reinterpret_cast<const float4*>(a + r * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wv[kk] = *reinterpret_cast<const float4*>(w + (k + kk) * ldw);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float x[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[r][0] = fmaf(x[kk], wv[kk].x, acc[r][0]);
        acc[r][1] = fmaf(x[kk], wv[kk].y, acc[r][1]);
        acc[r][2] = fmaf(x[kk], wv[kk].z, acc[r][2]);
        acc[r][3] = fmaf(x[kk], wv[kk].w, acc[r][3]);
      }
    }
  }
}

// Sum each accumulator over the `parts` lanes (a power of two) whose lane
// indices differ by multiples of `stride` = 32 / parts: a butterfly in one
// fixed order, after which every lane of the group holds the same bits
// (a + b and b + a round alike). Every lane of the warp must call it.
template <int TR>
__device__ __forceinline__ void sum_parts(float (&acc)[TR][4], int parts, int stride) {
  for (int o = stride; o < stride * parts; o <<= 1) {
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
  }
}

// acc[v / 4][v % 4] for a run-time v, by selects (an indexed register
// array would go to local memory)
template <int TR>
__device__ __forceinline__ float pick(const float (&acc)[TR][4], int v) {
  float out = acc[0][0];
#pragma unroll
  for (int u = 1; u < TR * 4; ++u)
    if (u == v) out = acc[u / 4][u % 4];
  return out;
}

// Shared memory, in floats: d_ue and H padded to multiples of 4 (d4, h4;
// pads zero, so 16-byte loads need no edge case), then the mbarrier.
// kernels/pair_scorer.py::smem_bytes computes the same total.
struct Layout {
  int d4, h4, k1;   // padded d_ue and H; W1's rows: d4 + S + 3
  int w1, ue, ueh, srvh, b1, w2, semb, srow, edge, red, floats;
  __host__ __device__ Layout(int n_srv, int d_ue, int s_dim, int hid) {
    d4 = up4(d_ue);
    h4 = up4(hid);
    k1 = d4 + s_dim + kEdge;
    int o = 0;
    w1 = o;   o += k1 * h4;                      // W1: ue rows (padded), S rows, 3 edge rows
    ue = o;   o += kRows * d4;                   // the block's UE rows
    ueh = o;  o += kRows * h4;                   // their W1u term
    srvh = o; o += n_srv * h4;                   // the servers' W1s term
    b1 = o;   o += h4;
    w2 = o;   o += h4;
    semb = o; o += up4(n_srv * s_dim);           // server embeddings
    srow = o; o += up4(2 * s_dim);               // w_srv's per_slot row, b_srv
    edge = o; o += up4(kRows * n_srv * kEdge);   // each pair's edge triple
    red = o;  o += 4;                            // occupancy partials
    floats = o;
  }
  size_t bytes() const { return (size_t)floats * sizeof(float) + sizeof(uint64_t); }
};

__global__ void __launch_bounds__(kThreads)
pair_scorer_fused_kernel(const float* __restrict__ ue, const float* __restrict__ d,
                         const float* __restrict__ work, const float* __restrict__ active,
                         const float* __restrict__ geom, const float* __restrict__ consts,
                         const float* __restrict__ w_srv, const float* __restrict__ b_srv,
                         const float* __restrict__ w1, const float* __restrict__ b1,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         float* __restrict__ logits, float* __restrict__ srv_out, int n,
                         int n_srv, int d_ue, int s_dim, int hid, int ue_split, int bulk) {
  extern __shared__ __align__(16) float sm[];
  const Layout L(n_srv, d_ue, s_dim, hid);
  // this block's env: every per-env pointer moves to its rows
  const size_t env = blockIdx.y;
  ue += env * n * d_ue;
  d += env * n;
  work += env * n;
  active += env * n;
  geom += env * n_srv * 3;
  logits += env * n * n_srv;
  srv_out += env * n_srv * s_dim;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L.floats);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const float bias2 = b2[0];

  // W1 and the UE rows land on bar: by bulk copy (the first lanes of warps
  // 0 and 1 each start one, in parallel, with its arrival and bytes) or by
  // the ue warps' ordinary loads (one arrival each)
  if (tid == 0) {
    mbar_init(bar, bulk ? 2 : kUeThreads);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < kUeWarps) {
    if (bulk) {
      if (tid == 0) {
        const uint32_t w1_bytes = (uint32_t)(L.k1 * L.h4 * sizeof(float));
        mbar_arrive_expect_tx(bar, w1_bytes);
        bulk_copy(sm + L.w1, w1, w1_bytes, bar);
      } else if (tid == 32) {
        const uint32_t ue_bytes = (uint32_t)(rows * L.d4 * sizeof(float));
        mbar_arrive_expect_tx(bar, ue_bytes);
        bulk_copy(sm + L.ue, ue + (size_t)row0 * d_ue, ue_bytes, bar);
      }
    } else {
      for (int i = tid; i < L.k1 * L.h4; i += kUeThreads) {
        const int k = i / L.h4, h = i - k * L.h4;
        const bool pad = h >= hid || (k >= d_ue && k < L.d4);
        const int src = k < L.d4 ? k : k - (L.d4 - d_ue);
        sm[L.w1 + i] = pad ? 0.0f : w1[(size_t)src * hid + h];
      }
      for (int i = tid; i < rows * L.d4; i += kUeThreads) {
        const int r = i / L.d4, k = i - r * L.d4;
        sm[L.ue + i] = k < d_ue ? ue[(size_t)(row0 + r) * d_ue + k] : 0.0f;
      }
      mbar_arrive(bar);
    }
    // while the copy is in flight: the loads of the edge triple that this
    // thread computes after the ue term, then b1 and w2
    const bool has_edge = tid < rows * n_srv;
    const int er = has_edge ? tid / n_srv : 0, ee = has_edge ? tid - er * n_srv : 0;
    const float ed = has_edge ? d[row0 + er] : 0.0f, ew = has_edge ? work[row0 + er] : 0.0f;
    const float g0 = geom[ee * 3 + 0], g1 = geom[ee * 3 + 1], g2 = geom[ee * 3 + 2];
    float c[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = consts[k];
    for (int i = tid; i < L.h4; i += kUeThreads) {
      sm[L.b1 + i] = i < hid ? b1[i] : 0.0f;
      sm[L.w2 + i] = i < hid ? w2[i] : 0.0f;
    }
    mbar_wait(bar, 0);

    // the ue term: 2 x 4 tiles, K split over ue_split lanes of a warp
    // parts is a power of two: shifts and masks, no integer division
    const int parts = ue_split, log_parts = __ffs(parts) - 1;
    const int stride = 32 >> log_parts, q = lane >> (5 - log_parts), j = lane & (stride - 1);
    const int n_cg = L.h4 / 4, tiles = (kRows / kTileRows) * n_cg;
    const int chunk = up4((L.d4 + parts - 1) >> log_parts);
    const int k0 = min(L.d4, q * chunk), k1 = min(L.d4, k0 + chunk);
    for (int tb = warp * stride; tb < tiles; tb += kUeWarps * stride) {
      const int t = tb + j;
      const bool valid = t < tiles;
      const int rg = valid ? t / n_cg : 0, cg = valid ? t - rg * n_cg : 0;
      float acc[kTileRows][4] = {};
      if (valid)
        tile_dot<kTileRows>(sm + L.ue + rg * kTileRows * L.d4, L.d4, sm + L.w1 + 4 * cg, L.h4,
                            k0, k1, acc);
      sum_parts<kTileRows>(acc, parts, stride);
      if (valid)
#pragma unroll 1
        for (int v = q; v < kTileRows * 4; v += parts)
          sm[L.ueh + (rg * kTileRows + v / 4) * L.h4 + 4 * cg + v % 4] = pick(acc, v);
    }
    // each pair's edge triple, once (a thread a pair; pairs past the ue
    // threads load their inputs here)
    for (int i = tid; i < rows * n_srv; i += kUeThreads) {
      const int r = i / n_srv, e = i - r * n_srv;
      const float dist = (i == tid ? ed : d[row0 + r]) * (i == tid ? g0 : geom[e * 3 + 0]);
      const float gain = powf(fmaxf(dist, 1.0f), -c[C_PATHLOSS]);
      float* out = sm + L.edge + i * kEdge;
      out[0] = dist / c[C_DIST_NORM];
      out[1] = (i == tid ? g1 : geom[e * 3 + 1]) * c[C_RATE_SCALE] *
               log2f(1.0f + c[C_PMAX] * gain / c[C_SIGMA]);
      out[2] = (i == tid ? ew : work[row0 + r]) * (i == tid ? g2 : geom[e * 3 + 2]) / c[C_T0];
    }
  } else {
    const int st = tid - kUeThreads, sw = warp - kUeWarps;
    // the occupancy's loads first, the longest wait on this side
    float occ[kOccUnroll];
    int i0 = st;
#pragma unroll
    for (int u = 0; u < kOccUnroll; ++u) {
      const int i = i0 + u * kSrvThreads;
      occ[u] = i < n ? active[i] : 0.0f;
    }

    // meanwhile the server rows' terms that do not need the occupancy (the
    // sum runs in k order, per_slot last), and the per_slot row of w_srv
    // and b_srv for the finish
    const float slow_inv = consts[C_SLOW_INV];
#pragma unroll 2
    for (int i = st; i < n_srv * s_dim; i += kSrvThreads) {
      const int e = i / s_dim, j = i - e * s_dim;
      float acc = fmaf(geom[e * 3 + 0], w_srv[j], 0.0f);
      acc = fmaf(geom[e * 3 + 1], w_srv[s_dim + j], acc);
      sm[L.semb + i] = fmaf(geom[e * 3 + 2] * slow_inv, w_srv[2 * s_dim + j], acc);
    }
    for (int j = st; j < s_dim; j += kSrvThreads) {
      sm[L.srow + j] = w_srv[(kSrvRow - 1) * s_dim + j];
      sm[L.srow + s_dim + j] = b_srv[j];
    }
    // the occupancy over the FULL fleet, in one fixed order in every block
    float part = 0.0f;
    for (;;) {
#pragma unroll
      for (int u = 0; u < kOccUnroll; ++u) part += occ[u];
      i0 += kOccUnroll * kSrvThreads;
      if (i0 >= n) break;
#pragma unroll
      for (int u = 0; u < kOccUnroll; ++u) {
        const int i = i0 + u * kSrvThreads;
        occ[u] = i < n ? active[i] : 0.0f;
      }
    }
    for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o);
    if (lane == 0) sm[L.red + sw] = part;
    named_barrier(1, kSrvThreads);
    const float per_slot = __fdiv_rn(sm[L.red] + sm[L.red + 1], consts[C_SLOT_DIV]);
    // the server embedding
#pragma unroll 2
    for (int i = st; i < n_srv * s_dim; i += kSrvThreads) {
      const int j = i % s_dim;
      const float v = tanhf(fmaf(per_slot, sm[L.srow + j], sm[L.semb + i]) + sm[L.srow + s_dim + j]);
      sm[L.semb + i] = v;
      if (blockIdx.x == 0) srv_out[i] = v;
    }
    named_barrier(1, kSrvThreads);
    mbar_wait(bar, 0);
    // its W1s term, 4 hidden units a thread
    const int n_cg = L.h4 / 4;
    for (int i = st; i < n_srv * n_cg; i += kSrvThreads) {
      const int e = i / n_cg, cg = i - e * n_cg;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
      for (int j = 0; j < s_dim; ++j) {
        const float s = sm[L.semb + e * s_dim + j];
        const float4 w = *reinterpret_cast<const float4*>(sm + L.w1 + (L.d4 + j) * L.h4 + 4 * cg);
        acc.x = fmaf(s, w.x, acc.x);
        acc.y = fmaf(s, w.y, acc.y);
        acc.z = fmaf(s, w.z, acc.z);
        acc.w = fmaf(s, w.w, acc.w);
      }
      *reinterpret_cast<float4*>(sm + L.srvh + e * L.h4 + 4 * cg) = acc;
    }
  }
  __syncthreads();

  // the pair stage: 8 lanes a pair over the hidden units, then the logit
  const float* w1e = sm + L.w1 + (L.d4 + s_dim) * L.h4;
  const int pairs = rows * n_srv;
  const int sub = lane / kPairLanes, pl = lane - sub * kPairLanes;
  for (int pb = warp * (32 / kPairLanes); pb < pairs; pb += kWarps * (32 / kPairLanes)) {
    const int p = pb + sub;
    const bool valid = p < pairs;
    float acc = 0.0f;
    if (valid) {
      const int r = p / n_srv, e = p - r * n_srv;
      const float dn = sm[L.edge + p * kEdge], rate = sm[L.edge + p * kEdge + 1];
      const float te = sm[L.edge + p * kEdge + 2];
#pragma unroll 2
      for (int h = pl; h < hid; h += kPairLanes) {
        const float ew = fmaf(te, w1e[2 * L.h4 + h], fmaf(rate, w1e[L.h4 + h], dn * w1e[h]));
        const float pre = sm[L.ueh + r * L.h4 + h] + sm[L.srvh + e * L.h4 + h] + ew + sm[L.b1 + h];
        acc = fmaf(tanhf(pre), sm[L.w2 + h], acc);
      }
    }
    for (int o = 1; o < kPairLanes; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (valid && pl == 0) logits[(size_t)row0 * n_srv + p] = acc + bias2;
  }
}

}  // namespace

// ue: (batch, n, d_ue); d, work, active: (batch, n); geom: (batch, n_srv,
// 3); consts: (8,); w_srv: (4, s_dim); b_srv: (s_dim,); w1: (d_ue + s_dim +
// 3, hid); b1: (hid,); w2: (hid, 1); b2: (1,); logits: (batch, n, n_srv);
// srv: (batch, n_srv, s_dim).
// All float32, contiguous. ue_split: lanes that split the ue term's K (a
// power of two <= 32); bulk: 1 for the bulk-copy route (d_ue and hid
// multiples of 4, ue and w1 16-byte aligned), 0 for ordinary loads;
// smem_bytes: the planner's shared memory, checked against the layout.
extern "C" int repro_pair_scorer(const void* ue, const void* d, const void* work,
                                 const void* active, const void* geom, const void* consts,
                                 const void* w_srv, const void* b_srv, const void* w1,
                                 const void* b1, const void* w2, const void* b2,
                                 void* logits, void* srv, int n, int n_srv, int d_ue,
                                 int s_dim, int hid, int batch, int ue_split, int bulk,
                                 long long smem_bytes, void* stream) {
  if (n <= 0 || n_srv <= 0 || d_ue <= 0 || s_dim <= 0 || hid <= 0 || batch <= 0 ||
      batch > 65535 || ue_split < 1 ||
      ue_split > 32 || (ue_split & (ue_split - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (bulk && (d_ue % 4 != 0 || hid % 4 != 0 || reinterpret_cast<uintptr_t>(ue) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(w1) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const Layout L(n_srv, d_ue, s_dim, hid);
  if ((long long)L.bytes() != smem_bytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<pair_scorer_fused_kernel>(L.bytes());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kRows - 1) / kRows, batch);
  pair_scorer_fused_kernel<<<grid, kThreads, L.bytes(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ue), static_cast<const float*>(d),
      static_cast<const float*>(work), static_cast<const float*>(active),
      static_cast<const float*>(geom), static_cast<const float*>(consts),
      static_cast<const float*>(w_srv), static_cast<const float*>(b_srv),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(logits), static_cast<float*>(srv), n, n_srv, d_ue, s_dim, hid,
      ue_split, bulk);
  return (int)cudaGetLastError();
}
