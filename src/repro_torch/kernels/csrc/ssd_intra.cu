// Mamba-2 SSD intra-chunk term for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_intra.py::ssd_intra
// (_kernel): for every (batch, chunk, head),
//   y[i, :] = sum_{j <= i} (C_i . B_j) * exp(la_i - la_j) * dt_j * x[j, :]
// with x (B, NC, Q, H, P), dt and la (B, NC, Q, H) f32, B and C (B, NC, Q, N)
// and y (B, NC, Q, H, P) f32.
//
// Bound on the H100: bytes, once the products run on the tensor cores. At
// the serving shape (B = 2, NC = 4, Q = 256, H = 64, P = 64, N = 128) the
// causal half is 2.3 GFLOP, 94 % of it the (Q x Q lower triangle) x (Q x P)
// product of every head, against 70.25 MB of traffic: 0.034 ms in f32 FMA
// (67 TFLOP/s), 0.015 ms in 3xTF32 on the tensor cores (495 TFLOP/s), 0.021
// ms over 3.35 TB/s. One TF32 product misses the reference's 1e-5, so both
// products run 3xTF32 (tf32_mma.cuh): each f32 operand split into TF32 hi
// and lo, lo.hi + hi.lo + hi.hi summed in f32; a bf16 operand is exact in
// TF32, so the Gram of bf16 B and C takes one product and W x of bf16 x two
// (W stays f32). What holds the kernel above that bound is the building of
// the weights and the split of x: about a dozen dependent instructions an
// element on 8 warps an SM, next to which the tensor cores idle (PERF.md).
//
// ssd_intra_mma_kernel, one launch a call, the kernel of every shape it
// takes (Q <= 256, a row of P a whole number of 16-byte units with x on a
// 16-byte boundary, N a multiple of 4 with B and C on a four-element one):
//   * a block owns one chunk, a pair of 64-row tiles (lo, nt - 1 - lo) and
//     a group of heads (and 64 columns of P): every block does nt + 1 tile
//     products a head, so the causal triangle is split evenly; the wrapper's
//     planner (ssd_intra.plan) sizes the head group so the grid fills the
//     card in one wave (8 chunks x 2 pairs x 8 groups of 8 heads = 128
//     blocks at the serving shape, 32 x 2 x 2 groups of 32 at B = 8);
//   * the TPU kernel's idea on a thread block: the block first computes its
//     tiles' Gram strip C_i B_j^T for every column tile j <= i into shared
//     memory (3xTF32 wgmma, B and C staged 32 columns of N at a time through
//     a 2-stage cp.async ring), then reuses it for every head of its group;
//     nothing goes through device memory between the two products;
//   * the two warpgroups then work apart, each on every other head of the
//     group with its own x ring, so one's weight building overlaps the
//     other's products with no block-wide barrier; x tiles (64 rows of P,
//     one row per j, strided by H P) come in by TMA (zeros past Q and P),
//     the tile's la and dt by cp.async, the next tile's while one is
//     multiplied; a head's column tiles are walked from its diagonal down,
//     so la_i of each row tile arrives with the first x tile that needs it;
//   * per x tile a warpgroup splits x into TF32 hi and lo, transposed into
//     the K-major layout wgmma reads TF32 from (x is (j, p) row-major, p
//     contiguous, so it cannot be read as it is);
//   * the weights W[i][j] = G[i][j] exp(la_i - la_j) dt_j are built straight
//     into wgmma's register A fragments: each thread reads its four Gram
//     values with one ldmatrix and computes them (ex2.approx of (la_i - la_j)
//     log2 e, see w_values) while the last two k8 steps' products run, then
//     splits them hi / lo into fragment registers, double-buffered (a third
//     buffer costs registers the kernel does not have: it spills);
//     the three products of both row tiles of a k8 step are one commit group
//     of asynchronous m64n64k8 wgmma; only the diagonal tile is masked; each
//     W element is built once, so the exponentials are Q (Q + 1) / 2 H a
//     chunk plus the diagonal tiles' upper halves;
//   * a head's sums stay in the accumulators (started by wgmma itself, so
//     ptxas can pipeline the products) until it is done, then go to y with
//     float2 stores.
//
// gram_kernel + intra_kernel, the shape-chosen route for what the tensor-core
// kernel cannot take: the lower triangle of C B^T in a (B NC, Q, Q) f32
// scratch that the wrapper allocates, then 64 x 64 output tiles in SIMT f32
// FMA that walk only the column tiles on or below the diagonal. The wrapper
// chooses by shape and address before the launch (ssd_intra.route), never
// because a launch failed.
//
// C interface for ctypes: pointers and the CUDA stream as void*, and the
// return value is the launch's cudaError_t. Nothing is allocated.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mbarrier.cuh"
#include "tf32_mma.cuh"
#include "wgmma.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int T = 64;             // tile edge: rows i, columns j, columns p

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// ------------------------------------------------------------ tensor cores
constexpr int kMaxNt = 4;          // row tiles of a chunk the kernel takes: Q <= 256
constexpr int kMmaThreads = 256;   // 2 warpgroups of 4 warps
constexpr int kStages = 2;         // x ring
constexpr int kKC = 32;            // Gram: columns of N a stage
constexpr int kGStages = 2;        // Gram: B, C ring
constexpr int kSliceBytes = 8 * T * 4;   // one k8 slice of a 64-column B operand

// Shared memory for nt row tiles, in bytes. The Gram strip comes first: the
// hi tile's 64 rows of (hi + 1) 64 columns, then the lo tile's, each row
// padded by 4 floats so a fragment's 8 rows x 4 columns fall on 32 distinct
// banks. Behind it one region holds first the Gram's B, C ring (rows padded
// the same way) and C operand, then each warpgroup's x ring (x tile, then
// the tile's (la, dt) pairs) and its x^T hi and lo in the wgmma B layout.
// The x rings' mbarriers come last.
template <typename XIn, typename BCIn>
struct Layout {
  static constexpr int kCLd = kKC + (sizeof(BCIn) == 4 ? 4 : 8);   // B, C stage row (elements)
  static constexpr int kXBytes = T * T * (int)sizeof(XIn);
  static constexpr int kStageBytes = kXBytes + T * 8;
  static constexpr int kXtBytes = 2 * 8 * kSliceBytes;   // [hi, lo][k8 slice]
  static constexpr int kWgBytes = kStages * kStageBytes + kXtBytes;   // one warpgroup's
  // the Gram's C operand: [hi, lo][k8 slice of the stage] of 128 rows
  static constexpr int kCtSlice = 8 * 2 * T * 4;
  static constexpr int kCtBytes = 2 * (kKC / 8) * kCtSlice;
  __host__ __device__ static constexpr int gram_bytes(int nt) { return T * ((nt + 1) * T + 8) * 4; }
  // C rows of both tiles, then B rows of every column tile
  __host__ __device__ static constexpr int gstage_elems(int nt) { return (2 * T + nt * T) * kCLd; }
  __host__ __device__ static constexpr int bar_offset(int nt) {
    return gram_bytes(nt) + cmax(kGStages * gstage_elems(nt) * (int)sizeof(BCIn) + kCtBytes,
                                 2 * kWgBytes);
  }
  __host__ __device__ static constexpr int bytes(int nt) {
    return bar_offset(nt) + 8 * 2 * kStages;
  }
};
static_assert(Layout<float, float>::kStageBytes % 128 == 0 &&
                  Layout<__nv_bfloat16, float>::kStageBytes % 128 == 0,
              "x tiles land by TMA on 128-byte boundaries");

template <int N>
using Int = std::integral_constant<int, N>;

// The A fragment's values of W[i][j] = G[i][j] exp(la_i - la_j) dt_j for a
// warp's 16 rows of one row tile and one k8 step (column col = jt 64 + kk 8
// of the strip), in registers: G from the strip by one ldmatrix, (la_j,
// dt_j) from the stage, masked above the diagonal on the diagonal tile (the
// caller splits them hi / lo). The exponential is ex2.approx of (la_i -
// la_j) log2 e: within 2 ulp of expf wherever the result is a normal float
// (la_i - la_j <= 0 on and below the diagonal, so the term is at most 1),
// and 0 below 2^-126, far under f32's resolution of any sum it joins.
template <bool kDiag>
__device__ __forceinline__ void w_values(float (&w)[4], const float* gram, int ld, int col,
                                         int kk, const float2* lt, const float (&la_i)[2],
                                         int rg, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t gv[4];
  ldmatrix_x4(gv, gram + (rg * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + col +
                      4 * (lane >> 4));
  const float2 c0 = lt[kk * 8 + t], c1 = lt[kk * 8 + t + 4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 c = (r >> 1) ? c1 : c0;
    w[r] = __uint_as_float(gv[r]) * exp2_ftz((la_i[r & 1] - c.x) * 1.4426950408889634f) * c.y;
    if constexpr (kDiag) {
      if (kk * 8 + t + 4 * (r >> 1) > rg * 16 + g + 8 * (r & 1)) w[r] = 0.0f;
    }
  }
}


// one box of a 4-D tensor map into shared memory; bar counts its bytes
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// Grid: BC * ceil(nt / 2) * ceil(H / hpb) * ceil(P / 64) blocks, ordered
// (chunk, pair, head group, P tile) with the P tile fastest; the planner in
// kernels/ssd_intra.py walks the same order. The row tiles (lo, hi) of a
// block are template arguments of the Gram phase, so its loops unroll
// without branches.
template <typename XIn, typename BCIn>
__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_intra_mma_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ dt,
                     const float* __restrict__ la, const BCIn* __restrict__ bm,
                     const BCIn* __restrict__ cm, float* __restrict__ y, int Q, int H, int P,
                     int N, int hpb) {
  using L = Layout<XIn, BCIn>;
  constexpr bool kXF32 = sizeof(XIn) == 4, kBCF32 = sizeof(BCIn) == 4;
  extern __shared__ __align__(128) unsigned char smem[];

  // the block's work: chunk bc, row tiles lo <= hi (lo + hi = nt - 1),
  // heads [h0, h0 + nh), columns [p0, p0 + 64)
  const int nt = (Q + T - 1) / T;
  const int n_pairs = (nt + 1) / 2, n_groups = (H + hpb - 1) / hpb, n_ptiles = (P + T - 1) / T;
  long long blk = blockIdx.x;
  const int pt = (int)(blk % n_ptiles);
  blk /= n_ptiles;
  const int grp = (int)(blk % n_groups);
  blk /= n_groups;
  const int lo = (int)(blk % n_pairs);
  const long long bc = blk / n_pairs;
  const int hi = nt - 1 - lo;
  const bool two = lo < hi;
  const int h0 = grp * hpb, nh = min(H, h0 + hpb) - h0;
  const int p0 = pt * T;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ld_hi = (hi + 1) * T + 4, ld_lo = (lo + 1) * T + 4;
  float* gram_hi = reinterpret_cast<float*>(smem);   // [64][ld_hi]: G of tile hi's rows
  float* gram_lo = gram_hi + T * ld_hi;              // [64][ld_lo]: G of tile lo's rows
  unsigned char* region = smem + L::gram_bytes(nt);
  // [warpgroup][x ring slot]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_offset(nt));
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // 1. The Gram strip, on wgmma, as G^T[j][i] = sum_n B[j][n] C[i][n]: A is
  // the B rows of one column tile (registers, split hi / lo), B the C rows
  // of the block's row tiles (shared memory: C is K-major as it stands, so
  // each stage of 32 columns of N is only split and laid out in core
  // matrices). A column tile on or below both tiles' diagonals takes one
  // N = 128 product over both row tiles, any other N = 64 over tile hi.
  // Warpgroup w takes the column tiles w and w + 2 (at most two).
  {
    const int wg = warp >> 2, rw = warp & 3;
    BCIn* gring = reinterpret_cast<BCIn*>(region);
    const int gelems = L::gstage_elems(nt);
    unsigned char* ct = region + kGStages * gelems * (int)sizeof(BCIn);   // [hi, lo][4 slices]
    const uint64_t ct_desc = kmajor_desc(ct);
    const int c_rows = two ? 2 * T : T;   // C rows of tile hi, then of tile lo
    const int b_rows = (hi + 1) * T;      // B rows of column tiles 0 .. hi
    auto load_gram_stage = [&](int slot, int kc) {
      BCIn* Cs = gring + slot * gelems;
      BCIn* Bs = Cs + 2 * T * L::kCLd;
      const int k0 = kc * kKC;
      for (int q = tid; q < c_rows * (kKC / 4); q += kMmaThreads) {
        const int r = q / (kKC / 4), c = (q % (kKC / 4)) * 4;
        const int i = (r < T ? hi : lo) * T + (r & (T - 1));
        const bool ok = i < Q && k0 + c < N;
        cp_async_chunk(Cs + r * L::kCLd + c, ok ? cm + (bc * Q + i) * N + k0 + c : cm, ok);
      }
      for (int q = tid; q < b_rows * (kKC / 4); q += kMmaThreads) {
        const int j = q / (kKC / 4), c = (q % (kKC / 4)) * 4;
        const bool ok = j < Q && k0 + c < N;
        cp_async_chunk(Bs + j * L::kCLd + c, ok ? bm + (bc * Q + j) * N + k0 + c : bm, ok);
      }
    };
    auto gram_phase = [&](auto hi_c, auto lo_c, auto wg_c) {
      constexpr int kHi = decltype(hi_c)::value, kLo = decltype(lo_c)::value;
      constexpr int kWg = decltype(wg_c)::value;
      constexpr bool kTwo = kLo < kHi;
      constexpr int kC0 = kWg, kC1 = kWg + 2;               // this warpgroup's column tiles
      constexpr int kN0 = kTwo && kC0 <= kLo ? 2 * T : T;   // their product widths
      constexpr int kN1 = kTwo && kC1 <= kLo ? 2 * T : T;
      float acc0[kN0 / 2], acc1[kN1 / 2];
      // the B rows of column tile c, k8 step kk: the A fragment, split
      auto a_frag = [&](const BCIn* Bs, int c, int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          to_tf32<kBCF32>(to_f32(Bs[(c * T + rw * 16 + g + 8 * (r & 1)) * L::kCLd + kk * 8 + t +
                                    4 * (r >> 1)]),
                          ah[r], al[r]);
      };
      const int n_kc = (N + kKC - 1) / kKC;
      load_gram_stage(0, 0);
      cp_async_commit();
      for (int kc = 0; kc < n_kc; ++kc) {
        cp_async_wait<0>();
        __syncthreads();   // stage kc has landed; stage kc - 1's products are done
        if (kc + 1 < n_kc) {
          load_gram_stage((kc + 1) % kGStages, kc + 1);
          cp_async_commit();
        }
        const BCIn* Cs = gring + (kc % kGStages) * gelems;
        const BCIn* Bs = Cs + 2 * T * L::kCLd;
        // C rows into the B operand: item (row i, 4 columns) to one 16-byte
        // chunk of hi and one of lo
        for (int q = tid; q < c_rows * (kKC / 4); q += kMmaThreads) {
          const int i = q % c_rows, c4 = q / c_rows;
          uint32_t hv[4], lv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) to_tf32<kBCF32>(to_f32(Cs[i * L::kCLd + 4 * c4 + e]), hv[e],
                                                      lv[e]);
          const int off = (c4 >> 1) * L::kCtSlice + kmajor_offset(4 * (c4 & 1), i);
          *reinterpret_cast<uint4*>(ct + off) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
          if constexpr (kBCF32)
            *reinterpret_cast<uint4*>(ct + (kKC / 8) * L::kCtSlice + off) =
                make_uint4(lv[0], lv[1], lv[2], lv[3]);
        }
        fence_proxy_async();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kKC / 8; ++kk) {
          const uint64_t b_hi = ct_desc + ((kk * L::kCtSlice) >> 4);
          const uint64_t b_lo = ct_desc + (((kKC / 8 + kk) * L::kCtSlice) >> 4);
          const int accumulate = kc != 0 || kk != 0;   // 0 starts the sums
          uint32_t ah[2][4], al[2][4];
          if constexpr (kC0 <= kHi) a_frag(Bs, kC0, kk, ah[0], al[0]);
          if constexpr (kC1 <= kHi) a_frag(Bs, kC1, kk, ah[1], al[1]);
          wgmma_fence();
          if constexpr (kC0 <= kHi) {
            if constexpr (kBCF32) {
              wgmma_tf32<kN0>(acc0, al[0], b_hi, accumulate);
              wgmma_tf32<kN0>(acc0, ah[0], b_lo);
              wgmma_tf32<kN0>(acc0, ah[0], b_hi);
            } else {
              wgmma_tf32<kN0>(acc0, ah[0], b_hi, accumulate);
            }
          }
          if constexpr (kC1 <= kHi) {
            if constexpr (kBCF32) {
              wgmma_tf32<kN1>(acc1, al[1], b_hi, accumulate);
              wgmma_tf32<kN1>(acc1, ah[1], b_lo);
              wgmma_tf32<kN1>(acc1, ah[1], b_hi);
            } else {
              wgmma_tf32<kN1>(acc1, ah[1], b_hi, accumulate);
            }
          }
          wgmma_commit();
        }
        wgmma_wait<0>();   // before the next stage's C rows replace these
      }
      // G^T's fragments into the strip as G: row j (M) of column tile c,
      // column i (N): i < 64 in tile hi, else tile lo
      auto store = [&](auto n_c, const float* a, int c) {
        constexpr int kN = decltype(n_c)::value;
#pragma unroll
        for (int n8 = 0; n8 < kN / 8; ++n8)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = c * T + rw * 16 + g + 8 * (r >> 1), i = n8 * 8 + 2 * t + (r & 1);
            if (i < T)
              gram_hi[i * ld_hi + j] = a[4 * n8 + r];
            else
              gram_lo[(i - T) * ld_lo + j] = a[4 * n8 + r];
          }
      };
      if constexpr (kC0 <= kHi) store(Int<kN0>{}, acc0, kC0);
      if constexpr (kC1 <= kHi) store(Int<kN1>{}, acc1, kC1);
    };
    auto by_wg = [&](auto hi_c, auto lo_c) {
      if (wg == 0)
        gram_phase(hi_c, lo_c, Int<0>{});
      else
        gram_phase(hi_c, lo_c, Int<1>{});
    };
    static_assert(kMaxNt == 4, "the cases below list every (lo, hi) of nt <= 4");
    switch (lo * kMaxNt + hi) {
      case 0: by_wg(Int<0>{}, Int<0>{}); break;          // nt 1
      case 1: by_wg(Int<1>{}, Int<0>{}); break;          // nt 2
      case 2: by_wg(Int<2>{}, Int<0>{}); break;          // nt 3
      case kMaxNt + 1: by_wg(Int<1>{}, Int<1>{}); break; // nt 3, the middle tile
      case 3: by_wg(Int<3>{}, Int<0>{}); break;          // nt 4
      case kMaxNt + 2: by_wg(Int<2>{}, Int<1>{}); break; // nt 4
    }
    __syncthreads();   // the strip is whole, and the B, C ring is free for x
  }

  // 2. W x on wgmma. The two warpgroups work apart, warpgroup w on heads
  // h0 + w, h0 + w + 2, ... (warp rg of it rows rg 16 .. + 16 of both row
  // tiles), each with its own x ring, so one's weight building overlaps the
  // other's products with no block-wide barrier. Per x tile a warpgroup
  // splits the tile into TF32 hi and lo, transposed into the wgmma B layout;
  // then per k8 step it builds W's A fragments in registers and issues the
  // three products of each row tile asynchronously, building the next
  // step's W meanwhile. A head's sums stay in the accumulators until it is
  // done and go to y from there.
  const int wg = warp >> 2, rg = warp & 3, wt = tid & 127;
  unsigned char* ring = region + wg * L::kWgBytes;
  unsigned char* xt = ring + kStages * L::kStageBytes;   // [hi, lo][k8 slice]
  uint64_t* wfull = full + wg * kStages;
  const uint64_t xt_desc = kmajor_desc(xt);
  const int ncol = hi + 1;                 // column tiles a head, walked from hi down to 0
  const int n_stages = (nh - wg + 1) / 2 * ncol;

  // stage s into slot s % 2: the x tile by TMA (the warpgroup's first
  // thread; zeros past Q and P), the (la_j, dt_j) pairs by cp.async
  auto head_of = [&](int s) { return h0 + wg + 2 * (s / ncol); };
  auto load_x = [&](int s) {
    const int slot = s % kStages;
    mbar_arrive_expect_tx(&wfull[slot], L::kXBytes);
    tma_load_4d(ring + slot * L::kStageBytes, &xmap, p0, head_of(s), (hi - s % ncol) * T,
                (int)bc, &wfull[slot]);
  };
  auto load_lt = [&](int s) {
    float* lt = reinterpret_cast<float*>(ring + (s % kStages) * L::kStageBytes + L::kXBytes);
    const int r = wt & (T - 1), j = (hi - s % ncol) * T + r;
    const bool ok = j < Q;
    const float* src = (wt < T ? la : dt) + (bc * Q + j) * H + head_of(s);
    cp_async_f32(lt + 2 * r + (wt >= T ? 1 : 0), ok ? src : la, ok);
  };

  float acc[2][32] = {};     // [tile: hi, lo][per n8 tile, its C fragment]
  float la_i[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  // the products of one x tile; each row tile idle (0), full (1) or on its
  // diagonal (2), where W is masked above the diagonal
  auto stage = [&](auto hi_c, auto lo_c, const float2* lt, int jt) {
    constexpr int kHi = decltype(hi_c)::value, kLo = decltype(lo_c)::value;
    uint32_t w_hi[2][2][4], w_lo[2][2][4];   // [k8 step parity][tile]
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      uint32_t(&wh)[2][4] = w_hi[m & 1];
      uint32_t(&wl)[2][4] = w_lo[m & 1];
      // the weights' values while steps m - 2 and m - 1 may still run; only
      // their split into the fragment registers waits for step m - 2 (of this
      // tile or the last), which read those registers
      float wv[2][4];
      if constexpr (kHi != 0)
        w_values<kHi == 2>(wv[0], gram_hi, ld_hi, jt * T + m * 8, m, lt, la_i[0], rg, lane);
      if constexpr (kLo != 0)
        w_values<kLo == 2>(wv[1], gram_lo, ld_lo, jt * T + m * 8, m, lt, la_i[1], rg, lane);
      wgmma_wait<1>();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (kHi != 0) split_tf32(wv[0][r], wh[0][r], wl[0][r]);
        if constexpr (kLo != 0) split_tf32(wv[1][r], wh[1][r], wl[1][r]);
      }
      wgmma_fence();
      const uint64_t b_hi = xt_desc + ((m * kSliceBytes) >> 4);
      const uint64_t b_lo = xt_desc + (((8 + m) * kSliceBytes) >> 4);
      // a row tile's first product of a head (its diagonal tile, first k8
      // step) starts its sum
      if constexpr (kHi != 0) {
        wgmma_tf32<64>(acc[0], wl[0], b_hi, kHi != 2 || m != 0);
        if constexpr (kXF32) wgmma_tf32<64>(acc[0], wh[0], b_lo);
        wgmma_tf32<64>(acc[0], wh[0], b_hi);
      }
      if constexpr (kLo != 0) {
        wgmma_tf32<64>(acc[1], wl[1], b_hi, kLo != 2 || m != 0);
        if constexpr (kXF32) wgmma_tf32<64>(acc[1], wh[1], b_lo);
        wgmma_tf32<64>(acc[1], wh[1], b_hi);
      }
      wgmma_commit();
    }
  };

  // y rows of one row tile from a head's accumulators
  auto store_y = [&](const float(&a)[32], int tile, int hh) {
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int i = tile * T + rg * 16 + g + 8 * r2;
      if (i >= Q) continue;
      float* yrow = y + ((bc * Q + i) * H + hh) * P + p0;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (p0 + col < P)
          *reinterpret_cast<float2*>(yrow + col) =
              make_float2(a[4 * n + 2 * r2], a[4 * n + 2 * r2 + 1]);
      }
    }
  };

  if (n_stages > 0) {
    if (wt == 0) load_x(0);
    load_lt(0);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<0>();                              // stage s's (la, dt) have landed
    mbar_wait(&wfull[s % kStages], (s / kStages) & 1);   // and its x tile
    warpgroup_sync(wg);   // the warpgroup is done reading stage s - 1's slot
    if (wt == 0 && s + 1 < n_stages) load_x(s + 1);
    const int hh = head_of(s), jt = hi - s % ncol;
    const XIn* Xs = reinterpret_cast<const XIn*>(ring + (s % kStages) * L::kStageBytes);
    const float2* lt =
        reinterpret_cast<const float2*>(ring + (s % kStages) * L::kStageBytes + L::kXBytes);
    if (jt == hi) {   // a head's first tile: tile hi's diagonal, which holds its la_i
      la_i[0][0] = lt[rg * 16 + g].x;
      la_i[0][1] = lt[rg * 16 + g + 8].x;
    }
    if (two && jt == lo) {
      la_i[1][0] = lt[rg * 16 + g].x;
      la_i[1][1] = lt[rg * 16 + g + 8].x;
    }
    // the x tile (k = j) into x^T hi and lo, once the last tile's products
    // have read them: a thread takes column n = p of four rows and writes
    // one 16-byte chunk of each
    wgmma_wait<0>();
    {
      const int n = wt & 63;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = 4 * (2 * e + (wt >> 6));   // 0, 4, .., 60
        uint32_t hv[4], lv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) to_tf32<kXF32>(to_f32(Xs[(k + c) * T + n]), hv[c], lv[c]);
        const int off = (k >> 3) * kSliceBytes + kmajor_offset(k & 7, n);
        *reinterpret_cast<uint4*>(xt + off) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
        if constexpr (kXF32)
          *reinterpret_cast<uint4*>(xt + 8 * kSliceBytes + off) =
              make_uint4(lv[0], lv[1], lv[2], lv[3]);
      }
    }
    fence_proxy_async();
    warpgroup_sync(wg);
    // the next (la, dt), issued after the fence so it does not wait on them
    if (s + 1 < n_stages) load_lt(s + 1);
    cp_async_commit();
    if (jt == hi)
      stage(Int<2>{}, Int<0>{}, lt, jt);
    else if (!two || jt > lo)
      stage(Int<1>{}, Int<0>{}, lt, jt);
    else if (jt == lo)
      stage(Int<1>{}, Int<2>{}, lt, jt);
    else
      stage(Int<1>{}, Int<1>{}, lt, jt);
    if (jt == 0) {   // the head is done
      wgmma_wait<0>();
      store_y(acc[0], hi, hh);
      if (two) store_y(acc[1], lo, hh);
    }
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                          cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// x (B NC, Q, H, P) as the 4-D tensor (P, H, Q, B NC), boxes of (64, 1, 64,
// 1): one chunk's 64 rows of one head, 64 columns of P; zeros past Q and P
template <typename XIn>
bool x_map(CUtensorMap* map, const void* x, int BC, int Q, int H, int P) {
  const cuuint64_t es = sizeof(XIn);
  const cuuint64_t dims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)Q, (cuuint64_t)BC};
  const cuuint64_t strides[3] = {P * es, (cuuint64_t)H * P * es, (cuuint64_t)Q * H * P * es};
  const cuuint32_t box[4] = {(cuuint32_t)T, 1, (cuuint32_t)T, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = sizeof(XIn) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_tiled() != nullptr &&
         encode_tiled()(map, type, 4, const_cast<void*>(x), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename XIn, typename BCIn>
cudaError_t launch_mma(const void* x, const float* dt, const float* la, const void* bm,
                       const void* cm, float* y, int BC, int Q, int H, int P, int N, int hpb,
                       cudaStream_t s) {
  using L = Layout<XIn, BCIn>;
  static const cudaError_t smem_err =
      cudaFuncSetAttribute(ssd_intra_mma_kernel<XIn, BCIn>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes(kMaxNt));
  if (smem_err != cudaSuccess) return smem_err;
  const int nt = (Q + T - 1) / T;
  const long long blocks =
      (long long)BC * ((nt + 1) / 2) * ((H + hpb - 1) / hpb) * ((P + T - 1) / T);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap xmap;
  if (!x_map<XIn>(&xmap, x, BC, Q, H, P)) return cudaErrorInvalidValue;
  ssd_intra_mma_kernel<XIn, BCIn><<<(unsigned)blocks, kMmaThreads, L::bytes(nt), s>>>(
      xmap, dt, la, static_cast<const BCIn*>(bm),
      static_cast<const BCIn*>(cm), y, Q, H, P, N, hpb);
  return cudaSuccess;
}

// ------------------------------------------------------------ SIMT route
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int R = 4;              // outputs per thread along each edge
constexpr int GK = 32;            // Gram: N step
constexpr int GPAD = GK + 1;      // Gram: padded row of the staged B and C

__device__ __forceinline__ float4 load_vec4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_vec4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Elements [col, col + 4) of one row, 0 where out of range. With kVec the
// row length is a multiple of 4, so a quad is wholly in or out of range.
template <typename In, bool kVec>
__device__ __forceinline__ float4 load_quad(const In* row, int col, int ncols, bool row_ok) {
  if constexpr (kVec) {
    return (row_ok && col < ncols) ? load_vec4(row + col) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = (row_ok && col + k < ncols) ? to_f32(row[col + k]) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

// gram[bc][j][i] = sum_n B[bc][j][n] * C[bc][i][n] on the 64 x 64 tiles
// with j-tile <= i-tile. Grid: (BC * nt * nt); blocks above the diagonal
// return at once.
template <typename In>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const In* __restrict__ bm, const In* __restrict__ cm, float* __restrict__ gram,
            int Q, int N, int nt) {
  __shared__ float Bs[T][GPAD];   // Bs[j][n]
  __shared__ float Cs[T][GPAD];   // Cs[i][n]
  const long long tile = blockIdx.x;
  const int it = (int)(tile % nt);
  const int jt = (int)((tile / nt) % nt);
  const long long bc = tile / ((long long)nt * nt);
  if (jt > it) return;
  const int i0 = it * T, j0 = jt * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const In* bbase = bm + bc * Q * N;
  const In* cbase = cm + bc * Q * N;

  float acc[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < N; k0 += GK) {
#pragma unroll
    for (int e = tid; e < T * GK; e += kThreads) {
      const int row = e / GK, k = e % GK;
      const bool kin = k0 + k < N;
      Bs[row][k] = (kin && j0 + row < Q) ? to_f32(bbase[(long long)(j0 + row) * N + k0 + k]) : 0.f;
      Cs[row][k] = (kin && i0 + row < Q) ? to_f32(cbase[(long long)(i0 + row) * N + k0 + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < GK; ++k) {
      float b[R], c[R];
#pragma unroll
      for (int r = 0; r < R; ++r) b[r] = Bs[ty * R + r][k];
#pragma unroll
      for (int r = 0; r < R; ++r) c[r] = Cs[tx * R + r][k];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < R; ++q) acc[r][q] = fmaf(b[r], c[q], acc[r][q]);
    }
    __syncthreads();
  }

  float* out = gram + bc * Q * Q;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + ty * R + r;
    if (j >= Q) continue;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = i0 + tx * R + q;
      if (i < Q) out[(long long)j * Q + i] = acc[r][q];
    }
  }
}

// y[bc, i0:i0+64, h, p0:p0+64] of one (chunk, head, row tile, P tile).
// Grid: (BC * nti, H, ntp); the row tiles of a chunk are taken last first,
// so the blocks with the most column tiles start first.
template <typename In, bool kVec>
__global__ void __launch_bounds__(kThreads)
intra_kernel(const In* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ la, const float* __restrict__ gram,
             float* __restrict__ y, int Q, int H, int P, int nti) {
  __shared__ __align__(16) float Ws[T][T];   // Ws[j][i]: the weights, transposed
  __shared__ __align__(16) float Xs[T][T];   // Xs[j][p]
  __shared__ float la_j[T], dt_j[T];

  const int it = nti - 1 - (int)(blockIdx.x % nti);
  const long long bc = blockIdx.x / nti;
  const int h = blockIdx.y;
  const int i0 = it * T, p0 = blockIdx.z * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // the weight-building role of this thread: one row i, every 4th column j
  const int wi = tid % T, wj = tid / T;
  const int i = i0 + wi;
  const float la_i = i < Q ? la[(bc * Q + i) * H + h] : 0.f;
  const float* g_row = gram + bc * Q * Q + i;   // g_row[j * Q] = gram[bc][j][i]

  float acc[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.0f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * T;
    if (tid < T) {
      const int j = j0 + tid;
      la_j[tid] = j < Q ? la[(bc * Q + j) * H + h] : 0.f;
      dt_j[tid] = j < Q ? dt[(bc * Q + j) * H + h] : 0.f;
    }
#pragma unroll
    for (int e = tid; e < T * T / 4; e += kThreads) {
      const int row = e / (T / 4), col = (e % (T / 4)) * 4;
      const int j = j0 + row;
      const In* xrow = x + ((bc * Q + (j < Q ? j : 0)) * H + h) * P + p0;
      *reinterpret_cast<float4*>(&Xs[row][col]) = load_quad<In, kVec>(xrow, col, P - p0, j < Q);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < T / 4; ++k) {
      const int jl = wj + 4 * k, j = j0 + jl;
      float w = 0.f;
      if (i < Q && j <= i)
        w = g_row[(long long)j * Q] * expf(la_i - la_j[jl]) * dt_j[jl];
      Ws[jl][wi] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int jl = 0; jl < T; ++jl) {
      const float4 a4 = *reinterpret_cast<const float4*>(&Ws[jl][ty * R]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Xs[jl][tx * R]);
      const float a[R] = {a4.x, a4.y, a4.z, a4.w};
      const float b[R] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = i0 + ty * R + r;
    if (row >= Q) continue;
    float* yrow = y + ((bc * Q + row) * H + h) * P;
    const int p = p0 + tx * R;
    if (kVec) {
      if (p < P) *reinterpret_cast<float4*>(yrow + p) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < R; ++c)
        if (p + c < P) yrow[p + c] = acc[r][c];
    }
  }
}


template <typename XIn, typename BCIn>
cudaError_t launch_simt(const void* x, const float* dt, const float* la, const void* bm,
                        const void* cm, float* gram, float* y, int BC, int Q, int H, int P,
                        int N, cudaStream_t s) {
  const int nt = (Q + T - 1) / T;
  const int ntp = (P + T - 1) / T;
  gram_kernel<BCIn><<<(unsigned)((long long)BC * nt * nt), kThreads, 0, s>>>(
      static_cast<const BCIn*>(bm), static_cast<const BCIn*>(cm), gram, Q, N, nt);
  const dim3 grid((unsigned)((long long)BC * nt), H, ntp);
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(XIn)) == 0;
  const XIn* xp = static_cast<const XIn*>(x);
  if (vec)
    intra_kernel<XIn, true><<<grid, kThreads, 0, s>>>(xp, dt, la, gram, y, Q, H, P, nt);
  else
    intra_kernel<XIn, false><<<grid, kThreads, 0, s>>>(xp, dt, la, gram, y, Q, H, P, nt);
  return cudaSuccess;
}

template <typename XIn, typename BCIn>
cudaError_t launch(int route, const void* x, const float* dt, const float* la, const void* bm,
                   const void* cm, float* gram, float* y, int BC, int Q, int H, int P, int N,
                   int hpb, cudaStream_t s) {
  return route == 1 ? launch_mma<XIn, BCIn>(x, dt, la, bm, cm, y, BC, Q, H, P, N, hpb, s)
                    : launch_simt<XIn, BCIn>(x, dt, la, bm, cm, gram, y, BC, Q, H, P, N, s);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x: (BC, Q, H, P) of x_dtype; dt, la: (BC, Q, H) f32; bm, cm: (BC, Q, N) of
// bc_dtype (0 = float32, 1 = bfloat16), all contiguous; y: (BC, Q, H, P) f32.
// route 1: the tensor-core kernel, ``heads_per_block`` heads a block (the
// planner's choice); it takes Q <= 256, P and N multiples of 4 and x, bm, cm
// aligned to four elements, and refuses anything else; gram is unused.
// route 0: the SIMT pair, which takes any shape, with gram a (BC, Q, Q) f32
// scratch.
extern "C" int repro_ssd_intra(const void* x, const void* dt, const void* la, const void* bm,
                               const void* cm, void* gram, void* y, int BC, int Q, int H,
                               int P, int N, int x_dtype, int bc_dtype, int route,
                               int heads_per_block, void* stream) {
  const long long nt = (Q + T - 1) / T;
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0 || x_dtype < 0 || x_dtype > 1 ||
      bc_dtype < 0 || bc_dtype > 1 || route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    const uintptr_t bc_chunk = 4 * (bc_dtype == 0 ? 4 : 2);
    if (nt > kMaxNt || P * (x_dtype == 0 ? 4 : 2) % 16 != 0 || N % 4 != 0 || !aligned(x, 16) ||
        !aligned(bm, bc_chunk) || !aligned(cm, bc_chunk) || heads_per_block < 1 ||
        heads_per_block > H)
      return (int)cudaErrorInvalidValue;
  } else if (gram == nullptr || H > 65535 || (P + T - 1) / T > 65535 ||
             BC * nt * nt > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* lap = static_cast<const float*>(la);
  float* g = static_cast<float*>(gram);
  float* yp = static_cast<float*>(y);
  const int hpb = heads_per_block;
  cudaError_t err;
  if (x_dtype == 0)
    err = bc_dtype == 0
              ? launch<float, float>(route, x, dtp, lap, bm, cm, g, yp, BC, Q, H, P, N, hpb, s)
              : launch<float, __nv_bfloat16>(route, x, dtp, lap, bm, cm, g, yp, BC, Q, H, P, N,
                                             hpb, s);
  else
    err = bc_dtype == 0
              ? launch<__nv_bfloat16, float>(route, x, dtp, lap, bm, cm, g, yp, BC, Q, H, P, N,
                                             hpb, s)
              : launch<__nv_bfloat16, __nv_bfloat16>(route, x, dtp, lap, bm, cm, g, yp, BC, Q,
                                                     H, P, N, hpb, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
