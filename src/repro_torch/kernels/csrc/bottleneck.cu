// Fused compressor encode for Hopper (sm_90a): codes = quantize(x @ W_enc).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bottleneck.py::
// bottleneck_encode (_kernel): the UE side of the paper's compressor, a
// (T, d) x (d, d') matmul with f32 accumulation and the Eq. 1 quantize as
// its epilogue, so the f32 bottleneck activation z never reaches memory.
//
// Bound on the H100: operations. At the serving shape (T = 1024, d = 2048,
// d' = 512, f32) the product is 2.1 GFLOP against 12.6 MB of traffic, and
// without tensor cores the floor is 2*T*d*d' over the 67 TFLOP/s of f32 FMA.
// Tensor cores are deliberately not used: TF32 keeps a 10-bit mantissa,
// which at d = 2048 moves codes by more than the one code the reference
// allows. The design is a SIMT tiled matmul that keeps the FMA pipes busy:
//   * each block owns a 64 x 64 output tile and walks K in steps of 32
//     inside the block, which replaces the TPU kernel's sequential
//     "arbitrary" K grid axis and its VMEM accumulator; at the serving
//     shape that is 128 blocks, one per SM;
//   * x and W tiles are staged in shared memory as f32 (bf16 inputs are
//     widened on the way in); x is stored transposed, so that both operands
//     of the inner loop are read as float4;
//   * each of the 256 threads keeps a 4 x 4 block of accumulators in
//     registers and, per K step, reads one float4 of x (a broadcast within
//     the warp) and one of W for 16 FMAs, so shared-memory traffic stays
//     well under the FMA rate;
//   * the next K tile is loaded from global memory into registers while
//     the current one is multiplied (register double buffering);
//   * global loads are 16-byte vectors when d and d' are multiples of 4 and
//     the pointers are aligned, and element-wise otherwise; ragged M, N and
//     K are masked: out-of-range loads read 0 and out-of-range outputs are
//     not written.
// Every output is summed with fmaf in K order, so any tiling gives the same
// codes. Faster forms (wgmma, TMA, bf16 or fp8 operands) are later work.
//
// C interface for ctypes: pointers and the CUDA stream as void*, and the
// return value is cudaGetLastError() after the launch. Nothing is allocated.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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
    for (int i = 0; i < 4; ++i) v[i] = (row_ok && col + i < ncols) ? to_f32(row[col + i]) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <typename In, typename Code, bool kVec>
__global__ void __launch_bounds__(kThreads)
bottleneck_encode_kernel(const In* __restrict__ x, const In* __restrict__ w,
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
      xr[r] = load_quad<In, kVec>(x + (long long)(gm < M ? gm : 0) * K, k0 + col, K, gm < M);
    }
#pragma unroll
    for (int r = 0; r < WQ; ++r) {
      const int q = tid + r * kThreads;
      const int row = q / (BN / 4), col = (q % (BN / 4)) * 4;
      const int gk = k0 + row;
      wr[r] = load_quad<In, kVec>(w + (long long)(gk < K ? gk : 0) * N, n0 + col, N, gk < K);
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

  // Eq. 1 epilogue, with the same rounded steps as kernels/quant.py.
  const float scale = __fdiv_rn(levels, fmaxf(__fsub_rn(mx, mn), 1e-12f));
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = m0 + ty * RM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gn = n0 + tx * RN + j;
      if (gn >= N) continue;
      float q = rintf(__fmul_rn(__fsub_rn(acc[i][j], mn), scale));
      q = fminf(fmaxf(q, 0.0f), levels);
      out[(long long)gm * N + gn] = (Code)q;
    }
  }
}

template <typename In, typename Code>
void launch(const void* x, const void* w, void* out, int M, int K, int N,
            float mn, float mx, float levels, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const uintptr_t align = 4 * sizeof(In);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % align == 0 &&
                   reinterpret_cast<uintptr_t>(w) % align == 0;
  const In* xp = static_cast<const In*>(x);
  const In* wp = static_cast<const In*>(w);
  Code* op = static_cast<Code*>(out);
  if (vec)
    bottleneck_encode_kernel<In, Code, true><<<grid, kThreads, 0, s>>>(
        xp, wp, op, M, K, N, mn, mx, levels);
  else
    bottleneck_encode_kernel<In, Code, false><<<grid, kThreads, 0, s>>>(
        xp, wp, op, M, K, N, mn, mx, levels);
}

}  // namespace

// x: (M, K) and w: (K, N), row-major, both of in_dtype (0 = float32,
// 1 = bfloat16). out: (M, N) codes, uint8 for bits <= 8, else uint16.
extern "C" int repro_bottleneck_encode(const void* x, const void* w, void* out,
                                       int M, int K, int N, int in_dtype, int bits,
                                       float mn, float mx, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + BM - 1) / BM > 65535 || bits < 1 ||
      bits > 16 || in_dtype < 0 || in_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float levels = (float)((1 << bits) - 1);
  const bool wide = bits > 8;
  if (in_dtype == 0) {
    if (wide) launch<float, uint16_t>(x, w, out, M, K, N, mn, mx, levels, s);
    else launch<float, uint8_t>(x, w, out, M, K, N, mn, mx, levels, s);
  } else {
    if (wide) launch<__nv_bfloat16, uint16_t>(x, w, out, M, K, N, mn, mx, levels, s);
    else launch<__nv_bfloat16, uint8_t>(x, w, out, M, K, N, mn, mx, levels, s);
  }
  return (int)cudaGetLastError();
}
