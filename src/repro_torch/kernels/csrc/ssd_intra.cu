// Mamba-2 SSD intra-chunk term for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_intra.py::ssd_intra
// (_kernel): for every (batch, chunk, head),
//   y[i, :] = sum_{j <= i} (C_i . B_j) * exp(la_i - la_j) * dt_j * x[j, :]
// with x (B, NC, Q, H, P), dt and la (B, NC, Q, H) f32, B and C (B, NC, Q, N)
// and y (B, NC, Q, H, P) f32.
//
// Bound on the H100: operations. At the serving shape (B = 2, NC = 4,
// Q = 256, H = 64, P = 64, N = 128) the causal half is 2.3 GFLOP, mostly the
// (Q x Q lower triangle) x (Q x P) product of every head, against about
// 70 MB of traffic; without tensor cores the floor is that count over the
// published 67 TFLOP/s of f32 FMA of an H100 SXM at its 700 W limit.
// Tensor cores are not used: TF32's 10-bit mantissa misses the reference's
// 1e-5 tolerance by orders of magnitude.
//
// The TPU kernel keeps the (Q, Q) Gram matrix C B^T of a chunk in VMEM and
// reuses it across the heads, which run in order on one core. On the GPU a
// 256 x 256 f32 Gram matrix (256 KB) exceeds one SM's shared memory and the
// heads run in parallel blocks, so the work is split in two launches:
//   1. gram_kernel writes the lower triangle of the Gram matrix, transposed
//      (gram[bc][j][i] = B_j . C_i for j <= i), to a (B*NC, Q, Q) f32
//      scratch that the wrapper allocates; at the serving shape it is 2 MB,
//      small beside the H100's 50 MB L2, so the second launch reads it
//      from there;
//   2. intra_kernel gives each block 64 output rows of one head (and 64
//      columns of P) and walks the 64-wide column tiles j0 <= i0 only: the
//      tiles above the diagonal are skipped, not masked, which halves the
//      work of the TPU kernel's full Q x Q product and is exact (the
//      reference's exp(-1e30) is 0). Per tile it builds the weights
//      W[j][i] = gram * exp(la_i - la_j) * dt_j in shared memory (expf, no
//      fast math) and stages the x tile, then each of 256 threads adds a
//      4 x 4 block of W^T x with fmaf, reading both operands as float4.
// Ragged Q and P are masked: out-of-range loads read 0 and out-of-range
// outputs are not written. Every output is summed over j in order, so any
// tiling gives the same result. Faster forms (wgmma with a 3xTF32 split,
// register prefetch) are later work.
//
// C interface for ctypes: pointers and the CUDA stream as void*, and the
// return value is cudaGetLastError() after the launches. Nothing is
// allocated.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int T = 64;             // tile edge: rows i, columns j, columns p
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int R = 4;              // outputs per thread along each edge
constexpr int GK = 32;            // Gram: N step
constexpr int GPAD = GK + 1;      // Gram: padded row of the staged B and C

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
void launch(const void* x, const float* dt, const float* la, const void* bm, const void* cm,
            float* gram, float* y, int BC, int Q, int H, int P, int N, cudaStream_t s) {
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
}

}  // namespace

// x: (BC, Q, H, P) of x_dtype; dt, la: (BC, Q, H) f32; bm, cm: (BC, Q, N) of
// bc_dtype (0 = float32, 1 = bfloat16), all contiguous. gram: (BC, Q, Q) f32
// scratch; y: (BC, Q, H, P) f32.
extern "C" int repro_ssd_intra(const void* x, const void* dt, const void* la, const void* bm,
                               const void* cm, void* gram, void* y, int BC, int Q, int H,
                               int P, int N, int x_dtype, int bc_dtype, void* stream) {
  const long long nt = (Q + T - 1) / T;
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0 || H > 65535 ||
      (P + T - 1) / T > 65535 || BC * nt * nt > 0x7fffffffLL || x_dtype < 0 ||
      x_dtype > 1 || bc_dtype < 0 || bc_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* lap = static_cast<const float*>(la);
  float* g = static_cast<float*>(gram);
  float* yp = static_cast<float*>(y);
  if (x_dtype == 0) {
    if (bc_dtype == 0) launch<float, float>(x, dtp, lap, bm, cm, g, yp, BC, Q, H, P, N, s);
    else launch<float, __nv_bfloat16>(x, dtp, lap, bm, cm, g, yp, BC, Q, H, P, N, s);
  } else {
    if (bc_dtype == 0) launch<__nv_bfloat16, float>(x, dtp, lap, bm, cm, g, yp, BC, Q, H, P, N, s);
    else launch<__nv_bfloat16, __nv_bfloat16>(x, dtp, lap, bm, cm, g, yp, BC, Q, H, P, N, s);
  }
  return (int)cudaGetLastError();
}
