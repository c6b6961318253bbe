// Fused compressor encode for Hopper (sm_90a): codes = quantize(x @ W_enc).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bottleneck.py::
// bottleneck_encode (_kernel): the UE side of the paper's compressor, a
// (T, d) x (d, d') matmul with f32 accumulation and the Eq. 1 quantize as
// its epilogue, so the f32 bottleneck activation z never reaches memory.
//
// Bound on the H100: operations. At the serving shape (T = 1024, d = 2048,
// d' = 512, f32) the product is 2.1 GFLOP against 13.1 MB of traffic. Plain
// TF32 is not enough: its 10-bit mantissa moves codes by many steps at 16
// bits and d = 2048, against the one code the reference allows. So the
// tensor cores run 3xTF32: each f32 operand is split into a TF32 high part
// hi = rna(a) and a TF32 low part lo = rna(a - hi) (Hopper's TF32 path
// ignores an operand's low 13 bits, so both roundings are explicit: round
// to nearest, ties away from zero, on the bit pattern, which gives
// cvt.rna.tf32.f32's bits for every finite a in two integer operations and
// measured faster than the cvt), and z accumulates lo.hi + hi.lo + hi.hi in
// f32; the
// dropped lo.lo term and lo's rounding are near 2^-21 of a product, close to
// f32's own rounding. Three products at the card's 495 TF32 TFLOP/s put the
// floor at 0.013 ms (f32 FMA: 0.032 ms). bf16 inputs are exact in TF32, so
// their instantiation takes one product.
//
// Route: mma.sync.m16n8k8 (TF32), fragments loaded from shared memory and
// split in registers. It reads W's (d, d') row-major layout as it is; wgmma
// reads TF32 operands only K-major from shared memory, which would need W's
// tiles transposed and split into hi / lo buffers there first.
//
// bottleneck_mma_kernel, the kernel of every shape it takes:
//   * a block owns a 128 x 64 output tile; its 8 warps are 2 (rows) x 2
//     (columns) x 2 (halves of each 64-deep K stage), each warp a 64 x 32
//     tile of 4 x 4 m16n8 accumulators, so every fragment feeds 4 products;
//     A fragments come in by ldmatrix, and the products go term by term
//     over the 16 accumulators;
//   * x and W stages come in by 16-byte cp.async (8-byte for bf16) into a
//     ring of 3 stages in dynamic shared memory, so the loads of the next
//     two K tiles are in flight while one is multiplied; rows are padded
//     so the fragment loads hit 32 distinct banks; out-of-range chunks are
//     zero-filled (ragged M, N and K);
//   * the grid fills the card in one wave: the wrapper's planner splits K
//     over a thread block cluster of S <= 4 blocks (cluster (1, 1, S))
//     while twice the tiles still fit in the SM count, so T = 1024 runs 64
//     tiles x 2 and T = 2048 runs 128 tiles x 1, 128 blocks each;
//   * epilogue: the two K-half warps of a block write their f32 partials to
//     shared memory (the drained ring); after cluster.sync() block r of the
//     cluster sums rows [r 128/S, (r + 1) 128/S) over every block's two
//     partials through distributed shared memory, in a fixed order, applies
//     Eq. 1 with the same explicitly rounded steps as kernels/quant.py and
//     writes four codes with one store; a last cluster.sync() keeps every
//     partial alive until read.
// It takes d and d' multiples of 4 and x, W aligned to four elements (one
// cp.async chunk).
//
// bottleneck_simt_kernel, the shape-chosen fallback for what the tensor-core
// kernel cannot take (d or d' not a multiple of 4, or x or W not aligned to
// four elements): a SIMT 64 x 64 tile with f32 FMA, element-wise loads and
// register double buffering. The wrapper chooses by shape and address before
// the launch, never because a launch failed.
//
// C interface for ctypes: pointers and the CUDA stream as void*, and the
// return value is the launch's cudaError_t. Nothing is allocated.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Eq. 1 for one value, as a float holding the code
__device__ __forceinline__ float quant_code(float z, float mn, float scale, float levels) {
  const float q = rintf(__fmul_rn(__fsub_rn(z, mn), scale));
  return fminf(fmaxf(q, 0.0f), levels);
}

__device__ __forceinline__ float eq1_scale(float mn, float mx, float levels) {
  return __fdiv_rn(levels, fmaxf(__fsub_rn(mx, mn), 1e-12f));
}

// ------------------------------------------------------------ tensor cores
constexpr int kBM = 128;           // output rows a block
constexpr int kBN = 64;            // output columns a block
constexpr int kBK = 64;            // K a stage: 4 k8 steps for each K-half warp
constexpr int kStages = 3;
constexpr int kMmaThreads = 256;   // 8 warps: 2 (M) x 2 (N) x 2 (K halves)
constexpr int kMT = 4;             // m16 tiles a warp (64 rows)
constexpr int kNT = 4;             // n8 tiles a warp (32 columns)
constexpr int kMaxSplit = 4;       // blocks of a cluster along K
constexpr int kChunk = 4;          // elements a cp.async moves

// Shared-memory layout of one input type. Row strides are padded so the
// fragment loads (8 rows x 4 columns of A, 4 rows x 8 columns of B) fall on
// 32 distinct banks, and rows stay aligned to a cp.async chunk.
template <typename In>
struct Layout {
  static constexpr bool kF32 = std::is_same<In, float>::value;
  static constexpr int kALd = kBK + (kF32 ? 4 : 8);     // x tile row stride (elements)
  static constexpr int kBLd = kBN + (kF32 ? 8 : 16);    // W tile row stride (elements)
  static constexpr int kAElems = kBM * kALd;
  static constexpr int kStageElems = kAElems + kBK * kBLd;
  static constexpr int kRingBytes = kStages * kStageElems * (int)sizeof(In);
  static constexpr int kPLd = kBN + 8;                  // partial row stride (floats)
  static constexpr int kPartFloats = kBM * kPLd;        // one K half's partial
  static constexpr int kPartBytes = 2 * kPartFloats * 4;
  static constexpr int kBytes = kRingBytes > kPartBytes ? kRingBytes : kPartBytes;
};

// One k8 step of a warp's 64 x 32 tile. Fragments (PTX m16n8k8 .tf32), with
// g = lane / 4 and t = lane % 4: A element r of m-tile mt is row
// mt 16 + g + 8 (r & 1), column t + 4 (r >> 1); B element r of n-tile nt is
// row t + 4 r, column nt 8 + g. The products go term by term over all 16
// accumulators, so 15 independent products separate two on one accumulator.
template <typename In>
__device__ __forceinline__ void mma_step(float (&acc)[kMT][kNT][4], const In* As, const In* Bs,
                                         int lane) {
  using L = Layout<In>;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (L::kF32) {
    uint32_t ahi[kMT][4], alo[kMT][4], bhi[kNT][2], blo[kNT][2];
    const int j = lane >> 3;   // the ldmatrix block whose row this lane addresses
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      uint32_t raw[4];
      ldmatrix_x4(raw, As + (mt * 16 + (lane & 7) + 8 * (j & 1)) * L::kALd + 4 * (j >> 1));
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(__uint_as_float(raw[r]), ahi[mt][r], alo[mt][r]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        split_tf32(Bs[(t + 4 * r) * L::kBLd + nt * 8 + g], bhi[nt][r], blo[nt][r]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)   // the small terms first
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], alo[mt], bhi[nt]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ahi[mt], blo[nt]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ahi[mt], bhi[nt]);
  } else {   // bf16 widened to f32 is exact in TF32: one product
    uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[mt][r] = __float_as_uint(
            to_f32(As[(mt * 16 + g + 8 * (r & 1)) * L::kALd + t + 4 * (r >> 1)]));
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        b[nt][r] = __float_as_uint(to_f32(Bs[(t + 4 * r) * L::kBLd + nt * 8 + g]));
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], a[mt], b[nt]);
  }
}

// Grid (ceil(N / 64), ceil(M / 128), S), cluster (1, 1, S): block z of a
// cluster takes the K tiles [z per, min((z + 1) per, ceil(K / 64))).
template <typename In, typename Code>
__global__ void __launch_bounds__(kMmaThreads, 1)
bottleneck_mma_kernel(const In* __restrict__ x, const In* __restrict__ w,
                      Code* __restrict__ out, int M, int K, int N, int per,
                      float mn, float mx, float levels) {
  using L = Layout<In>;
  extern __shared__ __align__(16) unsigned char smem[];
  In* ring = reinterpret_cast<In*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // the C fragment's row and column pair
  const int wm = warp & 1, wn = (warp >> 1) & 1, wk = warp >> 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kt0 = blockIdx.z * per;
  const int kt_end = min((K + kBK - 1) / kBK, kt0 + per);
  const int ntiles = max(kt_end - kt0, 0);

  // stage kt of x (128 rows x 64, 16 chunks a row) and W (64 rows x 64, 16
  // chunks a row) into ring slot ``slot``
  auto load_stage = [&](int slot, int kt) {
    In* As = ring + slot * L::kStageElems;
    In* Bs = As + L::kAElems;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kBM * kBK / kChunk / kMmaThreads; ++i) {
      const int q = tid + i * kMmaThreads;
      const int row = q / (kBK / kChunk), col = (q % (kBK / kChunk)) * kChunk;
      const int gm = m0 + row, gk = k0 + col;
      const bool ok = gm < M && gk < K;
      cp_async_chunk(As + row * L::kALd + col, ok ? x + (long long)gm * K + gk : x, ok);
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / kChunk / kMmaThreads; ++i) {
      const int q = tid + i * kMmaThreads;
      const int row = q / (kBN / kChunk), col = (q % (kBN / kChunk)) * kChunk;
      const int gk = k0 + row, gn = n0 + col;
      const bool ok = gk < K && gn < N;
      cp_async_chunk(Bs + row * L::kBLd + col, ok ? w + (long long)gk * N + gn : w, ok);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_stage(s, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();   // tile i has landed
    __syncthreads();                 // and every warp is done with tile i - 1's slot
    if (i + kStages - 1 < ntiles) load_stage((i + kStages - 1) % kStages, kt0 + i + kStages - 1);
    cp_async_commit();
    const In* As = ring + (i % kStages) * L::kStageElems + wm * 64 * L::kALd;
    const In* Bs = ring + (i % kStages) * L::kStageElems + L::kAElems + wn * 32;
#pragma unroll
    for (int h = 0; h < kBK / 16; ++h) {
      const int kk = (wk * (kBK / 16) + h) * 8;
      mma_step<In>(acc, As + kk, Bs + kk * L::kBLd, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is drained: it now holds the partials

  float* part = reinterpret_cast<float*>(smem);
  float* mine = part + wk * L::kPartFloats;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int row = wm * 64 + mt * 16 + g, col = wn * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(mine + row * L::kPLd + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(mine + (row + 8) * L::kPLd + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int rows = kBM / split;
  const float scale = eq1_scale(mn, mx, levels);
  for (int c = tid; c < rows * (kBN / 4); c += kMmaThreads) {
    const int row = rank * rows + c / (kBN / 4), col = (c % (kBN / 4)) * 4;
    float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < split; ++r) {
      const float* pr = cluster.map_shared_rank(part, r) + row * L::kPLd + col;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 p = *reinterpret_cast<const float4*>(pr + h * L::kPartFloats);
        z[0] += p.x;
        z[1] += p.y;
        z[2] += p.z;
        z[3] += p.w;
      }
    }
    const int gm = m0 + row, gn = n0 + col;
    if (gm < M && gn < N) {   // N % 4 == 0: the four columns are in or out together
      unsigned int q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = (unsigned int)quant_code(z[i], mn, scale, levels);
      Code* dst = out + (long long)gm * N + gn;
      if constexpr (sizeof(Code) == 1)
        *reinterpret_cast<unsigned int*>(dst) = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(q[0] | (q[1] << 16), q[2] | (q[3] << 16));
    }
  }
  cluster.sync();   // no block leaves while its partials are read
}

template <typename In, typename Code>
cudaError_t launch_mma(const void* x, const void* w, void* out, int M, int K, int N, int split,
                       float mn, float mx, float levels, cudaStream_t s) {
  static const cudaError_t smem_err = cudaFuncSetAttribute(
      bottleneck_mma_kernel<In, Code>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<In>::kBytes);
  if (smem_err != cudaSuccess) return smem_err;
  const int nkt = (K + kBK - 1) / kBK;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, split);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = Layout<In>::kBytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, bottleneck_mma_kernel<In, Code>, static_cast<const In*>(x),
                            static_cast<const In*>(w), static_cast<Code*>(out), M, K, N,
                            (nkt + split - 1) / split, mn, mx, levels);
}

// ------------------------------------------------------------ SIMT fallback
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TX = 16;            // threads along N
constexpr int TY = 16;            // threads along M
constexpr int RM = BM / TY;       // rows per thread (4, consecutive)
constexpr int RN = BN / TX;       // columns per thread (4, consecutive)
constexpr int kThreads = TX * TY;
constexpr int APAD = 4;           // keeps float4 alignment of the x rows
constexpr int XQ = BM * BK / 4 / kThreads;   // x quads loaded per thread (2)
constexpr int WQ = BK * BN / 4 / kThreads;   // W quads loaded per thread (2)

// Elements [col, col + 4) of one row, 0 where out of range.
template <typename In>
__device__ __forceinline__ float4 load_quad(const In* row, int col, int ncols, bool row_ok) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = (row_ok && col + i < ncols) ? to_f32(row[col + i]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <typename In, typename Code>
__global__ void __launch_bounds__(kThreads)
bottleneck_simt_kernel(const In* __restrict__ x, const In* __restrict__ w,
                       Code* __restrict__ out, int M, int K, int N,
                       float mn, float mx, float levels) {
  __shared__ __align__(16) float As[BK][BM + APAD];   // x tile, transposed: As[k][m]
  __shared__ __align__(16) float Bs[BK][BN];          // W tile: Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float4 xr[XQ], wr[WQ];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int r = 0; r < XQ; ++r) {
      const int q = tid + r * kThreads;
      const int row = q / (BK / 4), col = (q % (BK / 4)) * 4;
      const int gm = m0 + row;
      xr[r] = load_quad<In>(x + (long long)(gm < M ? gm : 0) * K, k0 + col, K, gm < M);
    }
#pragma unroll
    for (int r = 0; r < WQ; ++r) {
      const int q = tid + r * kThreads;
      const int row = q / (BN / 4), col = (q % (BN / 4)) * 4;
      const int gk = k0 + row;
      wr[r] = load_quad<In>(w + (long long)(gk < K ? gk : 0) * N, n0 + col, N, gk < K);
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int r = 0; r < XQ; ++r) {
      const int q = tid + r * kThreads;
      const int row = q / (BK / 4), col = (q % (BK / 4)) * 4;
      As[col + 0][row] = xr[r].x;
      As[col + 1][row] = xr[r].y;
      As[col + 2][row] = xr[r].z;
      As[col + 3][row] = xr[r].w;
    }
#pragma unroll
    for (int r = 0; r < WQ; ++r) {
      const int q = tid + r * kThreads;
      const int row = q / (BN / 4), col = (q % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(&Bs[row][col]) = wr[r];
    }
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

  load_tiles(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tiles();
    __syncthreads();
    if (k0 + BK < K) load_tiles(k0 + BK);   // in flight while this tile is used
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * RM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * RN]);
      const float a[RM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[RN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float scale = eq1_scale(mn, mx, levels);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = m0 + ty * RM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gn = n0 + tx * RN + j;
      if (gn >= N) continue;
      out[(long long)gm * N + gn] = (Code)quant_code(acc[i][j], mn, scale, levels);
    }
  }
}

template <typename In, typename Code>
cudaError_t launch_simt(const void* x, const void* w, void* out, int M, int K, int N,
                        float mn, float mx, float levels, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bottleneck_simt_kernel<In, Code><<<grid, kThreads, 0, s>>>(
      static_cast<const In*>(x), static_cast<const In*>(w), static_cast<Code*>(out), M, K, N,
      mn, mx, levels);
  return cudaSuccess;
}

template <typename In, typename Code>
cudaError_t launch(int route, const void* x, const void* w, void* out, int M, int K, int N,
                   int split, float mn, float mx, float levels, cudaStream_t s) {
  return route == 1 ? launch_mma<In, Code>(x, w, out, M, K, N, split, mn, mx, levels, s)
                    : launch_simt<In, Code>(x, w, out, M, K, N, mn, mx, levels, s);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x: (M, K) and w: (K, N), row-major, both of in_dtype (0 = float32,
// 1 = bfloat16). out: (M, N) codes, uint8 for bits <= 8, else uint16.
// route 1: the tensor-core kernel with K split over a cluster of ``split``
// blocks (1, 2 or 4); it takes K and N multiples of 4 and x, w and out
// aligned to four elements, and refuses anything else. route 0: the SIMT
// kernel, which takes any shape (split unused).
extern "C" int repro_bottleneck_encode(const void* x, const void* w, void* out,
                                       int M, int K, int N, int in_dtype, int bits,
                                       float mn, float mx, int route, int split,
                                       void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || bits < 1 || bits > 16 || in_dtype < 0 || in_dtype > 1 ||
      route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  const uintptr_t in_chunk = kChunk * (in_dtype == 0 ? 4 : 2);
  const uintptr_t out_chunk = kChunk * (bits > 8 ? 2 : 1);
  if (route == 1 &&
      (K % kChunk != 0 || N % kChunk != 0 || !aligned(x, in_chunk) || !aligned(w, in_chunk) ||
       !aligned(out, out_chunk) || (M + kBM - 1) / kBM > 65535 ||
       (split != 1 && split != 2 && split != kMaxSplit)))
    return (int)cudaErrorInvalidValue;
  if (route == 0 && (M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float levels = (float)((1 << bits) - 1);
  const bool wide = bits > 8;
  cudaError_t err;
  if (in_dtype == 0)
    err = wide ? launch<float, uint16_t>(route, x, w, out, M, K, N, split, mn, mx, levels, s)
               : launch<float, uint8_t>(route, x, w, out, M, K, N, split, mn, mx, levels, s);
  else
    err = wide ? launch<__nv_bfloat16, uint16_t>(route, x, w, out, M, K, N, split, mn, mx,
                                                 levels, s)
               : launch<__nv_bfloat16, uint8_t>(route, x, w, out, M, K, N, split, mn, mx,
                                                levels, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
