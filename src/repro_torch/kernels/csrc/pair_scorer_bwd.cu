// Backward of the fused (UE, server) pair scorer (pair_scorer.cu), for
// Hopper (sm_90a).
//
// The reference has no backward kernel: on the CPU it differentiates
// src/repro/kernels/pair_scorer.py::pair_scorer_xla. This kernel computes,
// for incoming gradients g = d logits (B, N, E) and gs = d srv (B, E, S),
// with a = ue W1u + srv_e W1s + edge W1e + b1, h = tanh(a) and
// da = g w2 tanh'(a) for every (env, UE, server) pair:
//   u       = sum_e da                        (B, N, H), per UE;
//   d ue    = u W1u^T,  dW1u = sum ue^T u;
//   dW1s    = sum_{b,e} srv^T (sum_n da)      the server rows of dW1;
//   dW1e    = sum edge^T da, db1 = sum da, dw2 = sum g h, db2 = sum g;
//   d srv   = (sum_n da) W1s^T + gs, through the server tanh into
//   dw_srv  = sum rows^T dpre and db_srv = sum dpre, with rows the server
//             rows [g0, g1, g2 / EDGE_SLOW_NORM, per_slot].
// tanh'(x) is taken as sech^2 x = 4 t / (1 + t)^2 with t = exp(-2|x|), from
// the pre-activation, not as 1 - tanh^2: where tanh rounds to 1 in float32
// (|x| > 9, as the server rows' per_slot term of a 1024-UE fleet gives)
// 1 - tanh^2 is 0 and the float32 gradient loses every digit, while sech^2
// keeps its own.
//
// Bound on the H100: at the fleet demo's minibatch (B, N, E) = (256, 4, 2)
// with d_ue 128, S 32, H 48 the least work is ~45 MFLOP (the recomputed ue
// term and both W1u products are 90 % of it) and ~1.2 MB, under a
// microsecond of either. What bounds the kernel is the length of its
// critical path in one launch, and the design is one launch, one wave:
//   * a persistent grid of at most one 512-thread block an SM (cooperative
//     launch, so every block is resident); a block takes units of at most
//     32 UE rows, whole envs where N <= 32 (2 envs of 4 UEs at the
//     minibatch, 128 units), else a chunk of one env, in a fixed order; W1
//     comes into shared memory once a block and the unit's UE rows once a
//     unit, by bulk copies on an mbarrier (ordinary loads where a width or
//     an address is not a multiple of 16 bytes: the "loads" route);
//   * the products read four neighbours as one float4 (rows padded to a
//     multiple of four floats): the first layer's ue term a thread four
//     hidden units over a quarter of K, the quarters joined by a
//     fixed-order butterfly; d ue = u W1u^T (from a transposed copy of W1u)
//     four columns a thread and the unit's dW1u = ue^T u four hidden units
//     a thread, in the block: no GEMM outside the kernel;
//   * the pair stage puts a unit's rows on the lanes of a warp (a
//     power-of-two group of lanes a hidden unit) and the hidden units on
//     the warps, so every per-hidden-unit sum over pairs (db1, dw2, dW1e) is
//     a lane butterfly and each env's sum_n da a fixed-order shuffle pass
//     over its rows;
//   * where a unit holds whole envs, the env's tail (per_slot, d srv
//     through the server tanh, dW1s, dw_srv, db_srv) runs in the same
//     block from shared memory; a block's partial sums stay in shared
//     memory across its units;
//   * one grid barrier (two where envs span units: the envs' tails run
//     between them), then every block sums a slice of the outputs, four at
//     a time, over the blocks' partials in block order and writes it.
// What is left (PERF.md, a clock64-stamped copy under the ignored build/):
// a chain of dependent phases, each short and latency-bound, then the grid
// barrier and the final sum's L2 round trips.
// Every sum runs in a fixed order and no float is added atomically, so the
// same call on the same card gives the same bits. The barrier's count
// returns to zero in every launch and its generation only grows; blocks
// wait for the generation to differ from the one they read, so neither
// word needs a reset and the generation's wrap-around is harmless.
// Products are f32 FMA on the SIMT cores.
//
// C interface for ctypes: pointers as void*, the CUDA stream as void*, and
// the return value is the launch's cudaError_t. The workspace (the blocks'
// partials, the split envs' sums and the barrier's two words, zero when
// first made) is the caller's, sized by repro_pair_scorer_backward_plan.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr int kMaxRows = 32;      // UE rows of a unit: one a lane of a warp
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kEdge = 3;          // [distance, rate proxy, edge seconds]
constexpr int kKSplit = 4;        // lanes an output of the ue term and of d srv
constexpr unsigned kFull = 0xffffffffu;

// consts layout (MECEnv._scorer_consts)
constexpr int C_PATHLOSS = 0, C_PMAX = 1, C_SIGMA = 2, C_RATE_SCALE = 3;
constexpr int C_T0 = 4, C_SLOT_DIV = 5, C_DIST_NORM = 6, C_SLOW_INV = 7;

// tanh'(x) = sech^2 x, accurate where tanh x rounds to +-1
__device__ __forceinline__ float dtanh(float x) {
  const float t = expf(-2.0f * fabsf(x)), u = 1.0f + t;
  return 4.0f * t / (u * u);
}

// A block's partial sums, in floats: [dW1 (d_ue + S + 3) x H][db1 H][dw2 H]
// [db2 1][dw_srv 4 x S][db_srv S]; the first block is laid out as dw1.
struct Part {
  int dw1, db1, dw2, db2, dw_srv, db_srv, floats;
  __host__ __device__ Part(int d_ue, int s_dim, int hid) {
    dw1 = 0;
    db1 = (d_ue + s_dim + kEdge) * hid;
    dw2 = db1 + hid;
    db2 = dw2 + hid;
    dw_srv = db2 + 1;
    db_srv = dw_srv + 4 * s_dim;
    floats = db_srv + s_dim;
  }
};

// Row strides in shared memory, each a multiple of four floats so a thread
// reads four neighbours as one float4: W1's rows (H to a multiple of 4, the
// padding zero), W1u^T's rows (d_ue to a multiple of 4, plus 4), and the
// rows of the ue term and of u (H to a multiple of 4, plus 4: the pair
// stage's lanes, 8 rows x 4 hidden units, fall on distinct banks).
__host__ __device__ constexpr int w1_ld(int hid) { return up4(hid); }
__host__ __device__ constexpr int w1ut_ld(int d_ue) { return up4(d_ue) + 4; }
__host__ __device__ constexpr int row_ld(int hid) { return up4(hid) + 4; }

// Shared memory, in floats, each region on a 16-byte boundary; `envs` is a
// unit's most envs (1 where envs span units). kernels/pair_scorer.py reads
// the total from repro_pair_scorer_backward_plan.
struct BwdLayout {
  int w1, ue, w1ut, t, u, g, edge, act, srv, srvh, v, b1, w2, wsrv, gsr, geo, part, rows, dpre,
      pslot, red, bar, floats;
  __host__ __device__ BwdLayout(int n_srv, int d_ue, int s_dim, int hid, int envs) {
    const int k1 = d_ue + s_dim + kEdge, es = envs * n_srv;
    int o = 0;
    w1 = o;    o += k1 * w1_ld(hid);            // W1, rows of up4(H): ue, server, edge rows
    ue = o;    o += up4(kMaxRows * d_ue);       // the unit's UE rows
    w1ut = o;  o += up4(hid) * w1ut_ld(d_ue);   // W1u^T
    t = o;     o += kMaxRows * row_ld(hid);     // the rows' ue term
    u = o;     o += kMaxRows * row_ld(hid);     // the rows' sum_e da
    g = o;     o += up4(kMaxRows * n_srv);      // d logits of the unit's pairs
    edge = o;  o += up4(kMaxRows * n_srv * kEdge);
    act = o;   o += kMaxRows;                   // the unit's active values
    srv = o;   o += up4(es * s_dim);            // the envs' server embeddings
    srvh = o;  o += up4(es * hid);              // their W1s term
    v = o;     o += up4(es * hid);              // the envs' sum_n da
    b1 = o;    o += up4(hid);
    w2 = o;    o += up4(hid);
    wsrv = o;  o += up4(5 * s_dim);             // w_srv's 4 rows, then b_srv
    gsr = o;   o += up4(es * s_dim);            // the envs' d srv from outside
    geo = o;   o += up4(es * 3);                // the envs' geometry
    part = o;  o += up4(Part(d_ue, s_dim, hid).floats);
    rows = o;  o += up4(es * 4);                // the envs' server rows
    dpre = o;  o += up4(es * s_dim);            // d srv through the tanh
    pslot = o; o += up4(envs);                  // the envs' per_slot
    red = o;   o += kThreads;                   // per_slot of a split env
    bar = o;   o += 4;                          // the mbarrier (no static shared
                                                // memory: the opt-in takes the block)
    floats = o;
  }
  size_t bytes() const { return (size_t)floats * sizeof(float); }
};

struct BwdParams {
  const float *ue, *d, *work, *active, *geom, *consts, *w_srv, *b_srv, *w1, *b1, *w2, *srv, *g,
      *gs;
  float *due, *dw_srv, *db_srv, *dw1, *db1, *dw2, *db2;
  float* part;       // (grid, up4(Part::floats)): each block's partial sums
  float* vpart;      // (B, chunks, E, H): each chunk's sum_n da (envs spanning units)
  unsigned* sync;    // the grid barrier's [count, generation]
  int n, n_srv, d_ue, s_dim, hid, batch;
  int envs_per_unit;   // > 0: units of whole envs
  int chunk_rows;      // > 0: units of chunk_rows rows of one env
  int units, bulk;
};

// Every block arrives, the last to arrive resets the count and opens the
// next generation; writes before it are seen by every block after it (the
// block barrier orders the block's writes before its first thread's fence,
// whose release covers them, as cooperative groups' grid sync does).
__device__ __forceinline__ void grid_sync(unsigned* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned gen = atomicAdd(sync + 1, 0u);
    __threadfence();
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      while (*reinterpret_cast<volatile unsigned*>(sync + 1) == gen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The tail of `nenv` envs whose sum_n da (v), embeddings (srv), incoming
// d srv (gsr), geometry and per_slot are in shared memory: d srv through
// the server tanh, then their dW1s, dw_srv and db_srv into the block's
// partials, in env order.
__device__ void env_tail(float* sm, const BwdLayout& L, const Part& P, const BwdParams& p,
                         const float* c, int nenv) {
  const int E = p.n_srv, S = p.s_dim, H = p.hid, D = p.d_ue, tid = threadIdx.x;
  const int es = nenv * E;
  // d srv of each (env, server, s): kKSplit lanes over the hidden units,
  // joined by a butterfly (every lane runs the same rounds)
  const int slot = tid % kKSplit, stride = kThreads / kKSplit;
  for (int base = 0; base < es * S; base += stride) {
    const int i = base + tid / kKSplit, pe = i / S, s = i - pe * S;
    float acc = 0.0f;
    if (i < es * S) {
#pragma unroll 4
      for (int h = slot; h < H; h += kKSplit)
        acc = fmaf(sm[L.v + pe * H + h], sm[L.w1 + (D + s) * w1_ld(H) + h], acc);
    }
#pragma unroll
    for (int m = kKSplit / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(kFull, acc, m);
    if (slot != 0 || i >= es * S) continue;
    const float* geom = sm + L.geo + pe * 3;
    const float row[4] = {geom[0], geom[1], geom[2] * c[C_SLOW_INV], sm[L.pslot + pe / E]};
    if (s == 0)
      for (int q = 0; q < 4; ++q) sm[L.rows + pe * 4 + q] = row[q];
    // the server row's pre-activation, summed as the forward sums it
    const float* w = sm + L.wsrv;
    const float pre = fmaf(row[3], w[3 * S + s],
                           fmaf(row[2], w[2 * S + s],
                                fmaf(row[1], w[S + s], fmaf(row[0], w[s], 0.0f)))) + w[4 * S + s];
    sm[L.dpre + i] = (acc + sm[L.gsr + i]) * dtanh(pre);
  }
  __syncthreads();
  float* part = sm + L.part;
  for (int i = tid; i < S * H; i += kThreads) {
    const int s = i / H, h = i - s * H;
    float acc = part[(D + s) * H + h];
#pragma unroll 4
    for (int pe = 0; pe < es; ++pe) acc = fmaf(sm[L.srv + pe * S + s], sm[L.v + pe * H + h], acc);
    part[(D + s) * H + h] = acc;
  }
  for (int i = tid; i < 5 * S; i += kThreads) {
    float acc = part[P.dw_srv + i];
    if (i < 4 * S) {
      const int q = i / S, s = i - q * S;
      for (int pe = 0; pe < es; ++pe) acc = fmaf(sm[L.rows + pe * 4 + q], sm[L.dpre + pe * S + s], acc);
    } else {
      for (int pe = 0; pe < es; ++pe) acc += sm[L.dpre + pe * S + i - 4 * S];
    }
    part[P.dw_srv + i] = acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) pair_scorer_backward_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float sm[];
  const int E = p.n_srv, S = p.s_dim, H = p.hid, D = p.d_ue, N = p.n;
  const int K1 = D + S + kEdge, H4 = w1_ld(H), WS = w1ut_ld(D), US = row_ld(H);
  const bool split = p.chunk_rows > 0;
  const int envs = split ? 1 : p.envs_per_unit;
  const BwdLayout L(E, D, S, H, envs);
  const Part P(D, S, H);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L.bar);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int unit_rows = split ? p.chunk_rows : envs * N;
  int rp = 1;                          // lanes a hidden unit: the unit's rows, to a power of two
  while (rp < unit_rows) rp *= 2;
  const int per_warp = 32 / rp;        // hidden units a warp takes at once
  const int chunks = split ? (N + p.chunk_rows - 1) / p.chunk_rows : 1;
  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = p.consts[k];
  float* part = sm + L.part;

  if (tid == 0 && p.bulk) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  // the constants of every unit; the first unit's barrier publishes them
  for (int i = tid; i < up4(P.floats); i += kThreads) part[i] = 0.0f;
  for (int i = tid; i < H; i += kThreads) {
    sm[L.b1 + i] = p.b1[i];
    sm[L.w2 + i] = p.w2[i];
  }
  for (int i = tid; i < 5 * S; i += kThreads) sm[L.wsrv + i] = i < 4 * S ? p.w_srv[i] : p.b_srv[i - 4 * S];
  // u's columns past H stay zero: d ue sums them against W1u^T's padding
  for (int i = tid; i < kMaxRows * (US - H); i += kThreads) {
    const int r = i / (US - H);
    sm[L.u + r * US + H + i - r * (US - H)] = 0.0f;
  }

  uint32_t phase = 0;
  bool have_w1 = false;
  for (int unit = blockIdx.x; unit < p.units; unit += gridDim.x) {
    int env0, nenv, r0, ru, chunk = 0;
    if (split) {
      env0 = unit / chunks;
      chunk = unit - env0 * chunks;
      nenv = 1;
      r0 = env0 * N + chunk * p.chunk_rows;
      ru = min(p.chunk_rows, N - chunk * p.chunk_rows);
    } else {
      env0 = unit * envs;
      nenv = min(envs, p.batch - env0);
      r0 = env0 * N;
      ru = nenv * N;
    }
    // W1 (first unit) and the unit's UE rows: by bulk copy, or loads
    if (p.bulk) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const uint32_t w1_bytes = have_w1 ? 0u : (uint32_t)(K1 * H * 4);
        const uint32_t ue_bytes = (uint32_t)(ru * D * 4);
        mbar_arrive_expect_tx(bar, w1_bytes + ue_bytes);
        if (!have_w1) bulk_copy(sm + L.w1, p.w1, w1_bytes, bar);
        bulk_copy(sm + L.ue, p.ue + (size_t)r0 * D, ue_bytes, bar);
      }
    } else {
      if (!have_w1)
        for (int i = tid; i < K1 * H4; i += kThreads) {
          const int k = i / H4, h = i - k * H4;
          sm[L.w1 + i] = h < H ? p.w1[k * H + h] : 0.0f;
        }
      for (int i = tid; i < ru * D; i += kThreads) sm[L.ue + i] = p.ue[(size_t)r0 * D + i];
    }
    // meanwhile: d logits, each pair's edge triple as the forward builds
    // it (zero past the unit's rows), the envs' embeddings
    for (int i = tid; i < kMaxRows * E; i += kThreads) {
      const int r = i / E, e = i - r * E;
      float* o = sm + L.edge + i * kEdge;
      if (r >= ru) {
        sm[L.g + i] = 0.0f;
        o[0] = o[1] = o[2] = 0.0f;
        continue;
      }
      const int row = r0 + r;
      const float* geom = p.geom + ((size_t)(row / N) * E + e) * 3;
      sm[L.g + i] = p.g[(size_t)row * E + e];
      const float dist = p.d[row] * geom[0];
      const float gain = powf(fmaxf(dist, 1.0f), -c[C_PATHLOSS]);
      o[0] = dist / c[C_DIST_NORM];
      o[1] = geom[1] * c[C_RATE_SCALE] * log2f(1.0f + c[C_PMAX] * gain / c[C_SIGMA]);
      o[2] = p.work[row] * geom[2] / c[C_T0];
    }
    for (int i = tid; i < nenv * E * S; i += kThreads) {
      sm[L.srv + i] = p.srv[(size_t)env0 * E * S + i];
      sm[L.gsr + i] = p.gs[(size_t)env0 * E * S + i];
    }
    for (int i = tid; i < nenv * E * 3; i += kThreads) sm[L.geo + i] = p.geom[(size_t)env0 * E * 3 + i];
    for (int i = tid; i < ru; i += kThreads) sm[L.act + i] = p.active[(size_t)r0 + i];
    __syncthreads();
    if (p.bulk) {
      mbar_wait(bar, phase);
      phase ^= 1u;
    }
    if (!have_w1) {
      for (int i = tid; i < D * H4; i += kThreads) {
        const int k = i / H4, h = i - k * H4;
        sm[L.w1ut + h * WS + k] = sm[L.w1 + i];
      }
      have_w1 = true;
    }
    // the ue term, a thread four hidden units of a row over a quarter of K,
    // the four quarters joined by a butterfly (every lane runs the same
    // number of rounds)
    {
      const int slot = tid % kKSplit, stride = kThreads / kKSplit, quads = H4 / 4;
      const int outs = rp * quads;
      for (int base = 0; base < outs; base += stride) {
        const int o = base + tid / kKSplit, r = o / quads, h = 4 * (o - r * quads);
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (o < outs && r < ru) {
#pragma unroll 8
          for (int k = slot; k < D; k += kKSplit) {
            const float a = sm[L.ue + r * D + k];
            const float4 w = *reinterpret_cast<const float4*>(sm + L.w1 + k * H4 + h);
            acc[0] = fmaf(a, w.x, acc[0]);
            acc[1] = fmaf(a, w.y, acc[1]);
            acc[2] = fmaf(a, w.z, acc[2]);
            acc[3] = fmaf(a, w.w, acc[3]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int m = kKSplit / 2; m > 0; m >>= 1) acc[q] += __shfl_xor_sync(kFull, acc[q], m);
        if (slot == 0 && o < outs)
          *reinterpret_cast<float4*>(sm + L.t + r * US + h) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    // the envs' server term
    for (int i = tid; i < nenv * E * H; i += kThreads) {
      const int pe = i / H, h = i - pe * H;
      float acc = 0.0f;
#pragma unroll 8
      for (int s = 0; s < S; ++s) acc = fmaf(sm[L.srv + pe * S + s], sm[L.w1 + (D + s) * H4 + h], acc);
      sm[L.srvh + i] = acc;
    }
    __syncthreads();

    // the pair stage: lane = (hidden unit of the warp's group, row)
    {
      const int r = lane % rp, hs = lane / rp;
      const int seg = split ? rp : N;                       // rows an env sum runs over
      const int seg0 = hs * rp + (split ? 0 : (r / N) * N);  // its first lane
      const int el = split ? 0 : r / N;
      const bool head = r < ru && (split ? r == 0 : r % N == 0);
      const float* w1e = sm + L.w1 + (D + S) * H4;
      for (int h0 = warp * per_warp; h0 < H; h0 += kWarps * per_warp) {
        const int h = h0 + hs;
        const bool hv = h < H, valid = hv && r < ru;
        const float tr = valid ? sm[L.t + r * US + h] : 0.0f;
        const float b1h = hv ? sm[L.b1 + h] : 0.0f, w2h = hv ? sm[L.w2 + h] : 0.0f;
        const float we0 = hv ? w1e[h] : 0.0f, we1 = hv ? w1e[H4 + h] : 0.0f;
        const float we2 = hv ? w1e[2 * H4 + h] : 0.0f;
        float su = 0.0f, sgh = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
        for (int e = 0; e < E; ++e) {
          const float* ed = sm + L.edge + (r * E + e) * kEdge;
          float da = 0.0f, gh = 0.0f;
          if (valid) {
            const float ew = fmaf(ed[2], we2, fmaf(ed[1], we1, ed[0] * we0));
            const float pre = tr + sm[L.srvh + (el * E + e) * H + h] + ew + b1h;
            const float gp = sm[L.g + r * E + e];
            da = gp * w2h * dtanh(pre);
            gh = gp * tanhf(pre);
          }
          su += da;
          sgh += gh;
          s0 = fmaf(ed[0], da, s0);
          s1 = fmaf(ed[1], da, s1);
          s2 = fmaf(ed[2], da, s2);
          // the env's sum_n da, over its rows in order
          float vs = 0.0f;
          for (int i = 0; i < seg; ++i) vs += __shfl_sync(kFull, da, (seg0 + i) & 31);
          if (hv && head) sm[L.v + (el * E + e) * H + h] = vs;
        }
        if (valid) sm[L.u + r * US + h] = su;
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
          if (m >= rp) continue;
          su += __shfl_xor_sync(kFull, su, m);
          sgh += __shfl_xor_sync(kFull, sgh, m);
          s0 += __shfl_xor_sync(kFull, s0, m);
          s1 += __shfl_xor_sync(kFull, s1, m);
          s2 += __shfl_xor_sync(kFull, s2, m);
        }
        if (hv && r == 0) {
          part[P.db1 + h] += su;
          part[P.dw2 + h] += sgh;
          part[(D + S) * H + h] += s0;
          part[(D + S + 1) * H + h] += s1;
          part[(D + S + 2) * H + h] += s2;
        }
      }
    }
    __syncthreads();

    // d ue = u W1u^T, a thread four neighbouring columns of a row; the
    // unit's dW1u = ue^T u, a thread four neighbouring hidden units of a
    // row of dW1u; db2. Each float4 read feeds four FMAs.
    {
      const int quads = WS / 4 - 1, tiles = ru * quads;
      for (int i = tid; i < tiles; i += kThreads) {
        const int r = i / quads, k = 4 * (i - r * quads);
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int h = 0; h < H4; h += 4) {
          const float4 u4 = *reinterpret_cast<const float4*>(sm + L.u + r * US + h);
          const float uh[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 w = *reinterpret_cast<const float4*>(sm + L.w1ut + (h + q) * WS + k);
            acc[0] = fmaf(uh[q], w.x, acc[0]);
            acc[1] = fmaf(uh[q], w.y, acc[1]);
            acc[2] = fmaf(uh[q], w.z, acc[2]);
            acc[3] = fmaf(uh[q], w.w, acc[3]);
          }
        }
        float* out = p.due + (size_t)(r0 + r) * D + k;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k + q < D) out[q] = acc[q];
      }
    }
    {
      const int quads = H4 / 4, tiles = D * quads;
      for (int i = tid; i < tiles; i += kThreads) {
        const int k = i / quads, h = 4 * (i - k * quads);
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int r = 0; r < ru; ++r) {
          const float a = sm[L.ue + r * D + k];
          const float4 u4 = *reinterpret_cast<const float4*>(sm + L.u + r * US + h);
          acc[0] = fmaf(a, u4.x, acc[0]);
          acc[1] = fmaf(a, u4.y, acc[1]);
          acc[2] = fmaf(a, u4.z, acc[2]);
          acc[3] = fmaf(a, u4.w, acc[3]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (h + q < H) part[k * H + h + q] += acc[q];
      }
    }
    if (tid == 0) {
      float acc = part[P.db2];
      for (int i = 0; i < ru * E; ++i) acc += sm[L.g + i];
      part[P.db2] = acc;
    }
    if (split) {
      float* vp = p.vpart + ((size_t)env0 * chunks + chunk) * E * H;
      for (int i = tid; i < E * H; i += kThreads) vp[i] = sm[L.v + i];
    } else {
      // each env's per_slot: its N active values in order
      for (int el = tid; el < nenv; el += kThreads) {
        float occ = 0.0f;
        for (int i = 0; i < N; ++i) occ += sm[L.act + el * N + i];
        sm[L.pslot + el] = __fdiv_rn(occ, c[C_SLOT_DIV]);
      }
      __syncthreads();
      env_tail(sm, L, P, p, c, nenv);
    }
    __syncthreads();
  }

  if (split) {
    grid_sync(p.sync);
    for (int env = blockIdx.x; env < p.batch; env += gridDim.x) {
      for (int i = tid; i < E * H; i += kThreads) {
        const float* src = p.vpart + (size_t)env * chunks * E * H + i;
        float acc = 0.0f;
#pragma unroll 16
        for (int k = 0; k < chunks; ++k) acc += __ldcg(src + (size_t)k * E * H);
        sm[L.v + i] = acc;
      }
      for (int i = tid; i < E * S; i += kThreads) {
        sm[L.srv + i] = p.srv[(size_t)env * E * S + i];
        sm[L.gsr + i] = p.gs[(size_t)env * E * S + i];
      }
      for (int i = tid; i < E * 3; i += kThreads) sm[L.geo + i] = p.geom[(size_t)env * E * 3 + i];
      // per_slot over the env's fleet, in one fixed order
      float occ = 0.0f;
      for (int i = tid; i < N; i += kThreads) occ += p.active[(size_t)env * N + i];
      sm[L.red + tid] = occ;
      __syncthreads();
      for (int o = kThreads / 2; o > 0; o >>= 1) {
        if (tid < o) sm[L.red + tid] += sm[L.red + tid + o];
        __syncthreads();
      }
      if (tid == 0) sm[L.pslot] = __fdiv_rn(sm[L.red], c[C_SLOT_DIV]);
      __syncthreads();
      env_tail(sm, L, P, p, c, 1);
    }
  }
  // this block's partials to the workspace, a row of `stride` floats
  const int stride = up4(P.floats), groups = stride / 4;
  float4* mine = reinterpret_cast<float4*>(p.part + (size_t)blockIdx.x * stride);
  for (int i = tid; i < groups; i += kThreads) mine[i] = reinterpret_cast<const float4*>(part)[i];
  grid_sync(p.sync);

  // the outputs, four at a time, each the sum of the blocks' partials in
  // block order: `ks` lanes a group of four, each lane the blocks slot,
  // slot + ks, ... with eight loads in flight (the sum's L2 round trips set
  // its length; a zero past the last block adds nothing), joined by a
  // butterfly
  const int total = gridDim.x * kThreads, G = gridDim.x;
  int ks = 1;
  while (ks < 32 && groups * ks * 2 <= total) ks *= 2;
  const int gt = blockIdx.x * kThreads + tid, slot = gt % ks, step = total / ks;
  const float4* all = reinterpret_cast<const float4*>(p.part);
  for (int base = 0; base < groups; base += step) {
    const int o4 = base + gt / ks;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (o4 < groups) {
      for (int b = slot; b < G; b += 8 * ks) {
        float4 v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          v[q] = b + q * ks < G ? __ldcg(all + (size_t)(b + q * ks) * groups + o4)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          acc[0] += v[q].x;
          acc[1] += v[q].y;
          acc[2] += v[q].z;
          acc[3] += v[q].w;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      for (int m = ks / 2; m > 0; m >>= 1) acc[q] += __shfl_xor_sync(kFull, acc[q], m);
    if (slot != 0 || o4 >= groups) continue;
    for (int q = 0; q < 4; ++q) {
      const int o = 4 * o4 + q;
      if (o >= P.floats) break;
      if (o < P.db1) p.dw1[o] = acc[q];
      else if (o < P.dw2) p.db1[o - P.db1] = acc[q];
      else if (o < P.db2) p.dw2[o - P.dw2] = acc[q];
      else if (o == P.db2) p.db2[0] = acc[q];
      else if (o < P.db_srv) p.dw_srv[o - P.dw_srv] = acc[q];
      else p.db_srv[o - P.db_srv] = acc[q];
    }
  }
}

}  // namespace

// The backward's needs for a launch whose units are `envs_per_unit` whole
// envs (> 0, N <= 32) or `chunk_rows`-row chunks of one env (> 0): its
// dynamic shared memory, the floats of one block's partials and of the
// split envs' sums, and the blocks the card holds at once (the grid's
// limit: the launch is cooperative). A block's partials are a row of
// part_floats, a multiple of four.
extern "C" int repro_pair_scorer_backward_plan(int n, int n_srv, int batch, int d_ue, int s_dim,
                                               int hid, int envs_per_unit, int chunk_rows,
                                               long long* smem_bytes, long long* part_floats,
                                               long long* vpart_floats, int* resident) {
  const bool split = chunk_rows > 0;
  if (n <= 0 || n_srv <= 0 || batch <= 0 || d_ue <= 0 || s_dim <= 0 || hid <= 0 ||
      split == (envs_per_unit > 0) || (split ? chunk_rows : envs_per_unit * n) > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const BwdLayout L(n_srv, d_ue, s_dim, hid, split ? 1 : envs_per_unit);
  *smem_bytes = (long long)L.bytes();
  *part_floats = up4(Part(d_ue, s_dim, hid).floats);
  *vpart_floats =
      split ? (long long)batch * ((n + chunk_rows - 1) / chunk_rows) * n_srv * hid : 0;
  cudaError_t err = allow_smem<pair_scorer_backward_kernel>(L.bytes());
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_scorer_backward_kernel,
                                                        kThreads, L.bytes());
  if (err != cudaSuccess) {
    (void)cudaGetLastError();   // do not leave it for the next launch's check
    return (int)err;
  }
  *resident = per_sm * sms;
  return 0;
}

// ue: (batch, n, d_ue); d, work, active: (batch, n); geom: (batch, n_srv,
// 3); consts: (8,); w_srv: (4, s_dim); b_srv: (s_dim,); w1: (d_ue + s_dim
// + 3, hid); b1: (hid,); w2: (hid, 1); srv: (batch, n_srv, s_dim), the
// forward's; g: (batch, n, n_srv); gs: (batch, n_srv, s_dim). Out: due
// (batch, n, d_ue); dw_srv (4, s_dim); db_srv (s_dim,); dw1 (d_ue + s_dim +
// 3, hid); db1 (hid,); dw2 (hid, 1); db2 (1,). All float32, contiguous.
// part: grid x part_floats; vpart: vpart_floats; sync: two unsigned words
// [count, generation], zero when first made (the count ends each launch at
// zero; the generation grows by one a barrier). bulk 1: W1 and the UE rows by bulk copy (d_ue and
// hid multiples of 4, ue and w1 on 16-byte boundaries). units and grid as
// kernels/pair_scorer.py plans them (grid <= resident); smem_bytes: the
// plan's, checked against the layout.
extern "C" int repro_pair_scorer_backward(
    const void* ue, const void* d, const void* work, const void* active, const void* geom,
    const void* consts, const void* w_srv, const void* b_srv, const void* w1, const void* b1,
    const void* w2, const void* srv, const void* g, const void* gs, void* due, void* dw_srv,
    void* db_srv, void* dw1, void* db1, void* dw2, void* db2, void* part, void* vpart,
    void* sync, int n, int n_srv, int d_ue, int s_dim, int hid, int batch, int envs_per_unit,
    int chunk_rows, int units, int grid, int bulk, long long smem_bytes, void* stream) {
  const bool split = chunk_rows > 0;
  if (n <= 0 || n_srv <= 0 || d_ue <= 0 || s_dim <= 0 || hid <= 0 || batch <= 0 ||
      split == (envs_per_unit > 0) || (split ? chunk_rows : envs_per_unit * n) > kMaxRows ||
      units <= 0 || grid <= 0 || grid > units ||
      (bulk && (d_ue % 4 != 0 || hid % 4 != 0 || reinterpret_cast<uintptr_t>(ue) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(w1) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const BwdLayout L(n_srv, d_ue, s_dim, hid, split ? 1 : envs_per_unit);
  if ((long long)L.bytes() != smem_bytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<pair_scorer_backward_kernel>(L.bytes());
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)err;
  }
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto w = [](void* q) { return static_cast<float*>(q); };
  BwdParams prm{f(ue),    f(d),     f(work),   f(active), f(geom),   f(consts),
                f(w_srv), f(b_srv), f(w1),     f(b1),     f(w2),     f(srv),
                f(g),     f(gs),    w(due),    w(dw_srv), w(db_srv), w(dw1),
                w(db1),   w(dw2),   w(db2),    w(part),   w(vpart),
                static_cast<unsigned*>(sync),
                n,        n_srv,    d_ue,      s_dim,     hid,       batch,
                envs_per_unit, chunk_rows, units, bulk};
  void* args[] = {&prm};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(pair_scorer_backward_kernel),
                                    dim3(grid), dim3(kThreads), args, L.bytes(),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
