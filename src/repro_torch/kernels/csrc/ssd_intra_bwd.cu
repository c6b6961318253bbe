// Backward of the Mamba-2 SSD intra-chunk term (ssd_intra.cu), for Hopper
// (sm_90a).
//
// The reference has no backward kernel: its train-mode forward runs the
// einsum form of src/repro/models/ssm.py::ssd_chunked and jax.grad
// differentiates it. For every (batch, chunk, head), with
//   M_ij = G_ij W_ij dt_j,  G = C B^T (shared by the heads),
//   W_ij = exp(la_i - la_j) on j <= i,  dM_ij = dy_i . x_j,
// this computes
//   dx_j   = sum_{i >= j} M_ij dy_i,
//   d dt_j = sum_{i >= j} dM_ij G_ij W_ij,
//   d la_i = sum_{j < i} S_ij - sum_{k > i} S_ki,  S = dM o M (the diagonal
//            enters both sums and cancels, so it is left out),
//   dG_ij  = sum_h dM_ij W_ij dt_j,  dC = dG B,  dB = dG^T C,
// with x (B NC, Q, H, P) f32 or bf16, dt and la (B NC, Q, H) f32, B and C
// (B NC, Q, N) f32 or bf16, dy (B NC, Q, H, P) f32 and every gradient f32.
//
// Bound on the H100: at the serving shape (B NC = 8, Q = 256, H = 64, P =
// 64, N = 128) the causal half of the (i, j) pairs takes 4.7 GFLOP, 91 %
// of it the two per-head products dM = dy x^T and dx = M^T dy, against
// 107 MB of traffic (x and dy read, dx written): 0.070 ms in f32 FMA
// (67 TFLOP/s), 0.032 ms over 3.35 TB/s. With the products on the tensor
// cores in 3xTF32 it is bound by bytes.
//
// Two routes, chosen by the wrapper from shape and address before the
// launch (ssd_intra.backward_route), never after a failure:
//
// "mma" (Q <= 256, P = 64, N a multiple of 32 up to 256, x, B, C 16-byte
// aligned): ssd_bwd_mma_kernel, then ssd_bwd_finish_kernel. A block owns
// one chunk, one 64-column tile j and a group of heads (the planner
// ssd_intra.mma_backward_plan sizes it), with two warpgroups:
//   * first the Gram tiles G_ij = C_i B_j^T of its row tiles i >= j, on
//     wgmma (3xTF32; one product where B and C are bf16, exact in TF32):
//     B_j split into TF32 hi / lo in shared memory, C_i's A fragments
//     straight from device memory into registers. Each G tile stays in
//     shared memory in its accumulator layout (a thread reads back only its
//     own values) for every head of the group;
//   * then head by head: x_j is split into hi / lo in shared memory (the
//     K-major B operand of dM); the row tiles i are dealt out to the two
//     warpgroups in turn (warpgroup w takes i = j + w, j + w + 2), so each
//     owns its tiles' dG, summed over the group's heads in head order in
//     the group's dG slot in device memory (each thread reads and writes
//     only its own elements; kept in registers it spilled). Per tile a
//     warpgroup writes dy_i^T hi / lo (the B operand of dx) from the
//     registers it loaded dy_i into a tile ahead, takes dM = dy_i x_j^T on
//     wgmma with dy's A fragments read back from dy^T, builds W, M, S, the
//     dG terms and the sums in the accumulator layout, writes M to shared
//     memory, and issues dx_j += M^T dy_i on wgmma with M^T's A fragments
//     read back from it (two k8 steps' fragments in flight). dx_j's sum
//     over i stays in the accumulators; at the head's end warpgroup 1 hands
//     its sum to warpgroup 0 through shared memory, which adds the two in
//     that order and writes dx once. dM never leaves the chip, and there is
//     no Gram scratch and no dx launch;
//   * the K order of a product is free, so the products that run over a
//     row's elements (dM over p, G over n) take the order in which a
//     thread's A fragments over 32 k are its own 8 contiguous elements
//     (k_of), and dx's N order is the one in which the dy^T stores spread
//     over 16 banks and a thread's dx row is two runs of 8 (16-byte
//     stores);
//   * the row sums of S are taken in the fragment (two shuffles), the
//     column sums of S and of dM G W by halving the columns across the 8
//     rows of lanes (reduce-scatter, three shuffles) and then over the
//     four warps in shared memory.
//
// "simt", any other shape: three SIMT f32 FMA launches, all 64 x 64
// tiles, 256 threads each with a 4 x 4 register tile (threads (ty, tx):
// rows 4 ty .. 4 ty + 3, columns 4 tx .. 4 tx + 3):
//   * ssd_bwd_pair_kernel, one block a (chunk, row tile it, column tile jt
//     <= it, group of heads): the Gram tile C_i B_j^T (kept in shared
//     memory, written once to a (B NC, Q, Q) scratch for the dx launch), then for
//     each head of the group in order dM = dy x^T over P, the weights, and
//     from them the tile's row and column sums of S and its column sums of
//     dM G W (written to (B NC, tiles, H, Q) scratch, one slot a tile
//     pair, summed by fixed-order warp butterflies and a shared-memory
//     column pass), while dG accumulates over the group's heads in
//     registers; the group's dG tile goes to a (B NC, groups, Q, Q)
//     scratch;
//   * ssd_bwd_dx_kernel, one block a (chunk, column tile jt, head, 64
//     columns of P): M^T dy over the row tiles it >= jt, the weights
//     rebuilt from the Gram scratch as the forward's SIMT route builds them.
//
// Both routes end with ssd_bwd_finish_kernel, one block a (chunk, row tile,
// 64 columns of N, dB or dC): dC = dG B and dB = dG^T C over the tiles, dG
// summed over the head groups in group order as it is loaded; the blocks
// also sum d dt and d la over the tile slots, a slice each.
// Every sum runs in a fixed order and no float is added atomically, so the
// same call gives the same bits.
//
// C interface for ctypes: pointers and the CUDA stream as void*, and the
// return value is the launches' cudaError_t. The scratch is the caller's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int T = 64;          // tile edge
constexpr int R = 4;           // a thread's register tile edge
constexpr int KC = 32;         // depth of a staged slice (P or N)
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// (row tile, column tile <= row tile) of tile pair p, in the order
// (0, 0), (1, 0), (1, 1), (2, 0), ...
__device__ __forceinline__ void pair_tiles(int p, int& it, int& jt) {
  it = 0;
  while ((it + 1) * (it + 2) / 2 <= p) ++it;
  jt = p - it * (it + 1) / 2;
}

// rows0 .. rows0 + 63 of a (rows, ld) matrix, columns k0 .. k0 + KC - 1,
// into dst[k][row] (transposed), zero past `rows` and `cols`
template <typename In>
__device__ __forceinline__ void stage_t(float (*dst)[T + 4], const In* src, long long ld,
                                        int rows0, int rows, int k0, int cols) {
  for (int e = threadIdx.x; e < T * KC; e += kThreads) {
    const int row = e / KC, k = e % KC;
    const bool ok = rows0 + row < rows && k0 + k < cols;
    dst[k][row] = ok ? to_f32(src[(long long)(rows0 + row) * ld + k0 + k]) : 0.0f;
  }
}

template <typename XIn, typename BCIn>
__global__ void __launch_bounds__(kThreads, 2)   // two blocks an SM: at most 128 registers
ssd_bwd_pair_kernel(const XIn* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ la, const BCIn* __restrict__ bm,
                    const BCIn* __restrict__ cm, const float* __restrict__ dy,
                    float* __restrict__ gram, float* __restrict__ dgp, float* __restrict__ rs,
                    float* __restrict__ cs, float* __restrict__ tp, int Q, int H, int P, int N,
                    int nt, int hpb) {
  __shared__ __align__(16) float As[KC][T + 4];   // dy^T (or C^T) slice: [k][i]
  __shared__ __align__(16) float Bs[KC][T + 4];   // x^T (or B^T) slice: [k][j]
  __shared__ __align__(16) float Gs[T][T + 4];    // the Gram tile: [i][j]
  __shared__ float la_i[T], la_j[T], dt_j[T];
  __shared__ float red_s[T / R][T], red_t[T / R][T];   // column sums: [ty][j]

  const int n_pairs = nt * (nt + 1) / 2;
  const long long bc = blockIdx.x / n_pairs;
  int it, jt;
  pair_tiles(blockIdx.x % n_pairs, it, jt);
  const int grp = blockIdx.y, n_groups = gridDim.y;
  const int h0 = grp * hpb, h1 = min(H, h0 + hpb);
  const int i0 = it * T, j0 = jt * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // the Gram tile G[i][j] = C_i . B_j
  float gv[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) gv[r][c] = 0.0f;
  for (int n0 = 0; n0 < N; n0 += KC) {
    stage_t(As, cm + bc * Q * N, N, i0, Q, n0, N);
    stage_t(Bs, bm + bc * Q * N, N, j0, Q, n0, N);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * R]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * R]);
      const float a[R] = {a4.x, a4.y, a4.z, a4.w}, b[R] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) gv[r][c] = fmaf(a[r], b[c], gv[r][c]);
    }
    __syncthreads();
  }
  // kept in shared memory for every head (registers go to dM and dG)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    *reinterpret_cast<float4*>(&Gs[ty * R + r][tx * R]) =
        make_float4(gv[r][0], gv[r][1], gv[r][2], gv[r][3]);
    const int i = i0 + ty * R + r;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int j = j0 + tx * R + c;
      if (grp == 0 && i < Q && j < Q) gram[(bc * Q + i) * Q + j] = gv[r][c];
    }
  }

  float dg[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) dg[r][c] = 0.0f;
  const long long hp = (long long)H * P;
  for (int h = h0; h < h1; ++h) {
    if (tid < T) {
      const int i = i0 + tid, j = j0 + tid;
      la_i[tid] = i < Q ? la[(bc * Q + i) * H + h] : 0.0f;
      la_j[tid] = j < Q ? la[(bc * Q + j) * H + h] : 0.0f;
      dt_j[tid] = j < Q ? dt[(bc * Q + j) * H + h] : 0.0f;
    }
    // dM = dy x^T over P
    float dm[R][R];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) dm[r][c] = 0.0f;
    for (int p0 = 0; p0 < P; p0 += KC) {
      stage_t(As, dy + bc * Q * hp + (long long)h * P, hp, i0, Q, p0, P);
      stage_t(Bs, x + bc * Q * hp + (long long)h * P, hp, j0, Q, p0, P);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * R]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * R]);
        const float a[R] = {a4.x, a4.y, a4.z, a4.w}, b[R] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < R; ++c) dm[r][c] = fmaf(a[r], b[c], dm[r][c]);
      }
      __syncthreads();
    }
    // the weights, dG, and this head's sums of the tile
    float row_s[R] = {0.0f, 0.0f, 0.0f, 0.0f};
    float col_s[R] = {0.0f, 0.0f, 0.0f, 0.0f}, col_t[R] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int il = ty * R + r, i = i0 + il;
      const float4 g4 = *reinterpret_cast<const float4*>(&Gs[il][tx * R]);
      const float gr[R] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int jl = tx * R + c, j = j0 + jl;
        if (i < Q && j <= i) {
          const float w = expf(la_i[il] - la_j[jl]);
          const float wd = w * dt_j[jl];
          dg[r][c] = fmaf(dm[r][c], wd, dg[r][c]);
          col_t[c] = fmaf(dm[r][c], gr[c] * w, col_t[c]);
          if (j < i) {
            const float s = dm[r][c] * (gr[c] * wd);
            row_s[r] += s;
            col_s[c] += s;
          }
        }
      }
    }
    // row sums over the 16 threads of a row group (one half-warp)
    const long long base = ((bc * nt + jt) * H + h) * Q;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = row_s[r];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int i = i0 + ty * R + r;
      if (tx == 0 && i < Q) rs[base + i] = v;
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      red_s[ty][tx * R + c] = col_s[c];
      red_t[ty][tx * R + c] = col_t[c];
    }
    __syncthreads();
    if (tid < 2 * T) {
      const int jl = tid % T, j = j0 + jl;
      float (*red)[T] = tid < T ? red_s : red_t;
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < T / R; ++k) v += red[k][jl];
      const long long at = ((bc * nt + it) * H + h) * Q + j;
      if (j < Q) (tid < T ? cs : tp)[at] = v;
    }
    // the next head's first barrier orders these reads before red is
    // written again
  }
  float* out = dgp + (bc * n_groups + grp) * Q * Q;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + ty * R + r;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int j = j0 + tx * R + c;
      if (i < Q && j < Q) out[(long long)i * Q + j] = dg[r][c];
    }
  }
}

// dx[bc, j0:j0+64, h, p0:p0+64] = sum over row tiles it >= jt of M^T dy.
// Grid: (B NC * nt, H, P tiles).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dx_kernel(const float* __restrict__ dt, const float* __restrict__ la,
                  const float* __restrict__ gram, const float* __restrict__ dy,
                  float* __restrict__ dx, int Q, int H, int P, int nt) {
  __shared__ __align__(16) float Ms[T][T];   // Ms[i][j]: the weights
  __shared__ __align__(16) float Ys[T][T];   // Ys[i][p]
  __shared__ float la_i[T];

  const int jt = (int)(blockIdx.x % nt);
  const long long bc = blockIdx.x / nt;
  const int h = blockIdx.y;
  const int j0 = jt * T, p0 = blockIdx.z * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // the weight-building role of this thread: one column j, every 4th row i
  const int wj = tid % T, wi = tid / T;
  const int j = j0 + wj;
  const float la_jv = j < Q ? la[(bc * Q + j) * H + h] : 0.0f;
  const float dt_jv = j < Q ? dt[(bc * Q + j) * H + h] : 0.0f;
  const long long hp = (long long)H * P;

  float acc[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.0f;

  for (int it = jt; it < nt; ++it) {
    const int i0 = it * T;
    if (tid < T) la_i[tid] = i0 + tid < Q ? la[(bc * Q + i0 + tid) * H + h] : 0.0f;
    for (int e = tid; e < T * T / 4; e += kThreads) {
      const int row = e / (T / 4), col = (e % (T / 4)) * 4;
      const int i = i0 + row;
      const float* src = dy + (bc * Q + (i < Q ? i : 0)) * hp + (long long)h * P + p0;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < Q) {
        if (kVec) {
          if (p0 + col < P) v = *reinterpret_cast<const float4*>(src + col);
        } else {
          float t[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) t[k] = p0 + col + k < P ? src[col + k] : 0.0f;
          v = make_float4(t[0], t[1], t[2], t[3]);
        }
      }
      *reinterpret_cast<float4*>(&Ys[row][col]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < T / 4; ++k) {
      const int il = wi + 4 * k, i = i0 + il;
      float w = 0.0f;
      if (i < Q && j <= i)
        w = gram[(bc * Q + i) * Q + j] * expf(la_i[il] - la_jv) * dt_jv;
      Ms[il][wj] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int il = 0; il < T; ++il) {
      const float4 a4 = *reinterpret_cast<const float4*>(&Ms[il][ty * R]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Ys[il][tx * R]);
      const float a[R] = {a4.x, a4.y, a4.z, a4.w}, b[R] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int jj = j0 + ty * R + r;
    if (jj >= Q) continue;
    float* row = dx + (bc * Q + jj) * hp + (long long)h * P;
    const int p = p0 + tx * R;
    if (kVec) {
      if (p < P) *reinterpret_cast<float4*>(row + p) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < R; ++c)
        if (p + c < P) row[p + c] = acc[r][c];
    }
  }
}

// z = 0: dC[bc, t rows, n0:n0+64] = sum_{jt <= t} dG B; z = 1: dB[bc, t
// rows, n0:n0+64] = sum_{it >= t} dG^T C; dG summed over the head groups
// in group order. Every block also finishes a slice of d dt and d la.
// Grid: (B NC * nt, N tiles, 2).
template <typename BCIn>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish_kernel(const BCIn* __restrict__ bm, const BCIn* __restrict__ cm,
                      const float* __restrict__ dgp, const float* __restrict__ rs,
                      const float* __restrict__ cs, const float* __restrict__ tp,
                      float* __restrict__ ddt, float* __restrict__ dla, float* __restrict__ db,
                      float* __restrict__ dc, int Q, int H, int N, int nt, int n_groups) {
  __shared__ __align__(16) float Ds[T][T + 4];   // z = 0: dG^T [j][i]; z = 1: dG [i][j]
  __shared__ __align__(16) float Vs[T][T + 4];   // z = 0: B [j][n]; z = 1: C [i][n]

  const int t = (int)(blockIdx.x % nt);
  const long long bc = blockIdx.x / nt;
  const int n0 = blockIdx.y * T, z = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  {
    // d dt and d la: every block takes a slice of the (chunk, head, row)
    // items, each summed over the tile pairs in tile order
    const long long items = (long long)(gridDim.x / nt) * H * Q;
    const long long nblk = (long long)gridDim.x * gridDim.y * gridDim.z;
    const long long blk = blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y * z);
    for (long long e = blk * kThreads + tid; e < items; e += nblk * kThreads) {
      const long long c = e / ((long long)H * Q);
      const int h = (int)(e / Q % H), q = (int)(e % Q), tq = q / T;
      float vt = 0.0f, vr = 0.0f, vc = 0.0f;
#pragma unroll 4
      for (int k = 0; k < nt; ++k) {
        const long long at = ((c * nt + k) * H + h) * Q + q;
        if (k >= tq) {
          vt += tp[at];
          vc += cs[at];
        }
        if (k <= tq) vr += rs[at];
      }
      ddt[(c * Q + q) * H + h] = vt;
      dla[(c * Q + q) * H + h] = vr - vc;
    }
  }

  float acc[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.0f;
  const BCIn* other = z == 0 ? bm : cm;
  const int k_lo = z == 0 ? 0 : t, k_hi = z == 0 ? t : nt - 1;
  for (int k = k_lo; k <= k_hi; ++k) {
    // the dG tile (rows i, columns j): (t, k) for dC, (k, t) for dB
    const int it = z == 0 ? t : k, jt = z == 0 ? k : t;
    // a thread's 16 elements, group by group, every load of a group in
    // flight together
    constexpr int kPer = T * T / kThreads;
    float v[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) v[m] = 0.0f;
    for (int g = 0; g < n_groups; ++g) {
      const float* src = dgp + (bc * n_groups + g) * Q * Q;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int e = tid + m * kThreads, i = it * T + e / T, j = jt * T + e % T;
        if (i < Q && j < Q) v[m] += src[(long long)i * Q + j];
      }
    }
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = tid + m * kThreads, il = e / T, jl = e % T;
      if (z == 0) Ds[jl][il] = v[m];
      else Ds[il][jl] = v[m];
    }
    // the rows of B (dC) or C (dB) the tile multiplies: k's tile
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = tid + m * kThreads, row = e / T, col = e % T, q = k * T + row;
      Vs[row][col] = q < Q && n0 + col < N ? to_f32(other[(bc * Q + q) * N + n0 + col]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int l = 0; l < T; ++l) {
      const float4 a4 = *reinterpret_cast<const float4*>(&Ds[l][ty * R]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Vs[l][tx * R]);
      const float a[R] = {a4.x, a4.y, a4.z, a4.w}, b[R] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* out = z == 0 ? dc : db;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = t * T + ty * R + r;
    if (q >= Q) continue;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int n = n0 + tx * R + c;
      if (n < N) out[(bc * Q + q) * N + n] = acc[r][c];
    }
  }
}

// ------------------------------------------------------------ tensor cores
constexpr int kMmaThreads = 256;   // two warpgroups
constexpr int kMaxNt = 4;          // row tiles of a chunk the route takes: Q <= 256
constexpr int kP = 64;             // the route's P: one 64-column tile
constexpr int kMaxN = 256;         // the route's largest N
constexpr int kSlice = 8 * T * 4;  // bytes of one k8 slice of a 64-row K-major operand
constexpr int kOp = 8 * kSlice;    // bytes of a 64 x 64 operand (K = 64)
constexpr int kMLd = 72;           // a row of the M tile: 8 i + j spreads a fragment over 32 banks
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of ssd_bwd_mma_kernel, in bytes: the G tiles, each in the
// accumulator layout, four registers together: [register / 4][thread of
// the warpgroup][4], so a thread reads back its own values; x_j hi
// and lo; per warpgroup dy_i^T hi and lo, the M tile and the column sums;
// la of the chunk's rows and (la_j, dt_j) of the column tile. The Gram's
// B_j hi and lo (N / 8 slices each) lie over x_j and the warpgroups' parts
// before the heads start.
struct MmaLayout {
  static constexpr int kG = 0;
  static constexpr int kX = kMaxNt * 32 * 128 * 4;
  static constexpr int kWg = kX + 2 * kOp;
  static constexpr int kDyt = 0;
  static constexpr int kM = 2 * kOp;
  static constexpr int kRed = kM + T * kMLd * 4;
  static constexpr int kWgBytes = kRed + 4 * 2 * T * 4;
  static constexpr int kLa = kWg + 2 * kWgBytes;
  static constexpr int kLt = kLa + kMaxNt * T * 4;
  static constexpr int kBytes = kLt + T * 8;
};
static_assert(2 * (kMaxN / 8) * kSlice <= MmaLayout::kLa - MmaLayout::kX,
              "the Gram's B_j fits over x_j and the warpgroups' parts");
static_assert(MmaLayout::kBytes <= 227 * 1024, "one block an SM");

// The K order of the products that run over a row's elements (dM over p,
// the Gram over n): logical k = 32 c + 8 kk + t + 4 h holds element e = 32 c
// + 8 t + 2 kk + h, so the A fragments of lane t over a 32-deep stretch are
// its 8 contiguous elements 32 c + 8 t .. + 7. This maps e to its k.
__device__ __forceinline__ int k_of(int e) {
  const int u = e & 31;
  return (e & ~31) + (((u >> 1) & 3) << 3) + (u >> 3) + ((u & 1) << 2);
}

// four consecutive elements as f32, zeros where !ok (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void load4(const float* p, bool ok, float* v) {
  const float4 a = ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool ok, float* v) {
  const uint2 raw = ok ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// Rows r0 .. r0 + 63 of a (rows, ld) matrix, elements 0 .. width - 1, into
// the K-major slices of a 64-row B operand (rows along N, elements along K
// in k_of order), hi at dst and lo at dst + lo_at when kSplit; zeros past
// `rows`. All threads of the block take part.
template <bool kSplit, typename In>
__device__ __forceinline__ void stage_kmajor(unsigned char* dst, int lo_at, const In* src,
                                             long long ld, int r0, int rows, int width) {
  const int quads = width / 4;
  for (int e = threadIdx.x; e < T * quads; e += kMmaThreads) {
    const int r = e / quads, c = (e % quads) * 4;
    float v[4];
    load4(src + (long long)(r0 + r) * ld + c, r0 + r < rows, v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k_of(c + q);
      const int off = (k >> 3) * kSlice + kmajor_offset(k & 7, r);
      uint32_t hi, lo;
      to_tf32<kSplit>(v[q], hi, lo);
      *reinterpret_cast<uint32_t*>(dst + off) = hi;
      if constexpr (kSplit) *reinterpret_cast<uint32_t*>(dst + lo_at + off) = lo;
    }
  }
}

// d (64 x 64) = a b over one k8 step: three TF32 products (a_lo b_hi, a_hi
// b_lo, a_hi b_hi) where b was split, two where it was exact (bf16); the
// first starts the sum when accumulate is 0
template <bool kSplitB>
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[32], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], uint64_t b_hi,
                                             uint64_t b_lo, int accumulate) {
  wgmma_tf32<64>(d, al, b_hi, accumulate);
  if constexpr (kSplitB) wgmma_tf32<64>(d, ah, b_lo);
  wgmma_tf32<64>(d, ah, b_hi);
}

// Grid: BC * ceil(Q / 64) * ceil(H / hpb) blocks, ordered (column tile,
// chunk, head group) with the head group fastest, so the blocks with the
// most row tiles (column tile 0) start first.
template <typename XIn, typename BCIn>
__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_bwd_mma_kernel(const XIn* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ la, const BCIn* __restrict__ bm,
                   const BCIn* __restrict__ cm, const float* __restrict__ dy,
                   float* __restrict__ dgp, float* __restrict__ rs, float* __restrict__ cs,
                   float* __restrict__ tp, float* __restrict__ dx, int BC, int Q, int H, int N,
                   int hpb) {
  using L = MmaLayout;
  constexpr bool kXF32 = sizeof(XIn) == 4, kBCF32 = sizeof(BCIn) == 4;
  extern __shared__ __align__(128) unsigned char smem[];

  const int nt = (Q + T - 1) / T, n_groups = (H + hpb - 1) / hpb;
  const int grp = (int)(blockIdx.x % n_groups);
  const long long bc = blockIdx.x / n_groups % BC;
  const int jt = (int)(blockIdx.x / n_groups / BC);
  const int h0 = grp * hpb, nh = min(H, h0 + hpb) - h0;
  const int n_i = nt - jt, j0 = jt * T;   // row tiles jt .. nt - 1: slots 0 .. n_i - 1
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, w = wt >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;

  float* gs = reinterpret_cast<float*>(smem + L::kG);   // [slot][register / 4][thread][4]
  unsigned char* xs = smem + L::kX;
  unsigned char* part = smem + L::kWg + wg * L::kWgBytes;
  unsigned char* dyt = part + L::kDyt;
  float* ms = reinterpret_cast<float*>(part + L::kM);    // [i][j], row kMLd
  float* red = reinterpret_cast<float*>(part + L::kRed); // [warp][S, T][j]
  float* la_s = reinterpret_cast<float*>(smem + L::kLa);
  float2* lt_s = reinterpret_cast<float2*>(smem + L::kLt);
  const uint64_t x_desc = kmajor_desc(xs), dyt_desc = kmajor_desc(dyt);

  // 1. The Gram tiles of this warpgroup's row tiles, G_ij = C_i B_j^T
  {
    const int nk = N / 8;
    stage_kmajor<kBCF32>(xs, nk * kSlice, bm + bc * Q * N, N, j0, Q, N);
    fence_proxy_async();
    __syncthreads();
    const uint64_t b_desc = kmajor_desc(xs);
#pragma unroll
    for (int sp = 0; sp < 2; ++sp) {
      const int s = wg + 2 * sp;
      if (s >= n_i) break;
      const int i0 = (jt + s) * T;
      float acc[32];
      for (int c = 0; c < N / 32; ++c) {
        float cv[2][8];
#pragma unroll
        for (int r1 = 0; r1 < 2; ++r1) {
          const int i = i0 + 16 * w + g + 8 * r1;
          const BCIn* row = cm + (bc * Q + (i < Q ? i : 0)) * N + 32 * c + 8 * t;
          load4(row, i < Q, cv[r1]);
          load4(row + 4, i < Q, cv[r1] + 4);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) to_tf32<kBCF32>(cv[r & 1][2 * kk + (r >> 1)], ah[r], al[r]);
          const int sl = 4 * c + kk;
          wgmma_fence();
          if constexpr (kBCF32)
            wgmma_3xtf32<true>(acc, ah, al, b_desc + ((sl * kSlice) >> 4),
                               b_desc + (((nk + sl) * kSlice) >> 4), c != 0 || kk != 0);
          else
            wgmma_tf32<64>(acc, ah, b_desc + ((sl * kSlice) >> 4), c != 0 || kk != 0);
          wgmma_commit();
        }
        wgmma_wait<0>();
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        reinterpret_cast<float4*>(gs)[(s * 8 + q) * 128 + wt] =
            make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  }

  // 2. Head by head. dG of a tile, summed over the group's heads in head
  // order, builds up in the group's own dG slot in device memory: the tile
  // belongs to one warpgroup, each thread reads and writes only its own
  // accumulator elements, and the first head writes without reading.
  float* dgo = dgp + (bc * n_groups + grp) * (long long)Q * Q;
  const long long hq = (long long)H * kP;   // a row of x, dy and dx
  // this thread's dy of head h, row tile slot s: rows 16 w + g + 8 r1 of
  // the tile, elements 32 c + 8 t .. + 7 of each; loaded a tile ahead
  float dyv[2][16];
  auto load_dy = [&](int h, int s) {
    const int i0 = (jt + s) * T;
#pragma unroll
    for (int r1 = 0; r1 < 2; ++r1) {
      const int i = i0 + 16 * w + g + 8 * r1;
      const float* row = dy + (bc * Q + (i < Q ? i : 0)) * hq + (long long)h * kP + 8 * t;
#pragma unroll
      for (int q = 0; q < 4; ++q) load4(row + 32 * (q >> 1) + 4 * (q & 1), i < Q, dyv[r1] + 4 * q);
    }
  };
  if (wg < n_i) load_dy(h0, wg);
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    __syncthreads();   // the last head's products, x_j reads and dx hand-over are done
    stage_kmajor<kXF32>(xs, kOp, x + (long long)h * kP + bc * Q * hq, hq, j0, Q, kP);
    for (int e = tid; e < nt * T; e += kMmaThreads)
      la_s[e] = e < Q ? la[(bc * Q + e) * H + h] : 0.0f;
    if (tid < T) {
      const int j = j0 + tid;
      lt_s[tid] = j < Q ? make_float2(la[(bc * Q + j) * H + h], dt[(bc * Q + j) * H + h])
                        : make_float2(0.0f, 0.0f);
    }
    fence_proxy_async();
    __syncthreads();

    float dxa[32];
#pragma unroll
    for (int sp = 0; sp < 2; ++sp) {
      const int s = wg + 2 * sp;
      if (s >= n_i) break;
      const int it = jt + s, i0 = it * T;
      wgmma_wait<0>();   // the last tile's dx products have read dy^T
      // dy^T hi and lo, element (k = i, n), n = 32 c + 8 (v >> 1) + 2 t + (v & 1)
#pragma unroll
      for (int r1 = 0; r1 < 2; ++r1)
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int k = 16 * w + g + 8 * r1, v = e & 7;
          const int n = 32 * (e >> 3) + 8 * (v >> 1) + 2 * t + (v & 1);
          const int off = (k >> 3) * kSlice + kmajor_offset(k & 7, n);
          uint32_t hi, lo;
          split_tf32(dyv[r1][e], hi, lo);
          *reinterpret_cast<uint32_t*>(dyt + off) = hi;
          *reinterpret_cast<uint32_t*>(dyt + kOp + off) = lo;
        }
      fence_proxy_async();
      warpgroup_sync(wg);
      // the next tile's dy, in flight through this tile's products
      if (s + 2 < n_i)
        load_dy(h, s + 2);
      else if (hh + 1 < nh)
        load_dy(h + 1, wg);

      // dM = dy_i x_j^T; A (row i, logical k = 8 kk + t + 4 h, element 32
      // (kk >> 2) + 8 t + 2 (kk & 3) + h) read back from dy^T, where that
      // element sits at n = 32 (kk >> 2) + 8 (kk & 3) + 2 t + h; two k8
      // steps' fragments in flight (the one a step reuses was read by the
      // step two before, which wgmma_wait<1> has seen done)
      float dm[32];
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= 2) wgmma_wait<1>();
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = 16 * w + g + 8 * (r & 1);
          const int n = 32 * (kk >> 2) + 8 * (kk & 3) + 2 * t + (r >> 1);
          const int off = (k >> 3) * kSlice + kmajor_offset(k & 7, n);
          ah[kk & 1][r] = *reinterpret_cast<const uint32_t*>(dyt + off);
          al[kk & 1][r] = *reinterpret_cast<const uint32_t*>(dyt + kOp + off);
        }
        wgmma_fence();
        wgmma_3xtf32<kXF32>(dm, ah[kk & 1], al[kk & 1], x_desc + ((kk * kSlice) >> 4),
                            x_desc + (((8 + kk) * kSlice) >> 4), kk != 0);
        wgmma_commit();
      }
      // this tile's dG so far, read while the products run
      float dgv[32];
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int i = i0 + 16 * w + g + 8 * r2, j = j0 + 8 * n8 + 2 * t;
          float2 v = make_float2(0.0f, 0.0f);
          if (hh > 0 && i < Q && j < Q) {
            if (j + 1 < Q)
              v = *reinterpret_cast<const float2*>(dgo + (long long)i * Q + j);
            else
              v.x = dgo[(long long)i * Q + j];
          }
          dgv[4 * n8 + 2 * r2] = v.x;
          dgv[4 * n8 + 2 * r2 + 1] = v.y;
        }
      wgmma_wait<0>();

      // W, M, S and the dG terms in the accumulator layout: element r of n8
      // tile n8 is row 16 w + g + 8 (r >> 1), column 8 n8 + 2 t + (r & 1)
      float la_i[2], row_s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r1 = 0; r1 < 2; ++r1) la_i[r1] = la_s[i0 + 16 * w + g + 8 * r1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {   // columns 32 half .. + 31
        float col_s[8], col_t[8];
#pragma unroll
        for (int n8 = 4 * half; n8 < 4 * half + 4; ++n8) {
          // G of the four elements, (la_j, dt_j) of both columns
          const float4 g4 = reinterpret_cast<const float4*>(gs)[(s * 8 + n8) * 128 + wt];
          const float4 lt4 = *reinterpret_cast<const float4*>(lt_s + 8 * n8 + 2 * t);
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const int il = 16 * w + g + 8 * r2, i = i0 + il;
            float mv[2];
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const int r = 2 * r2 + b, idx = 4 * n8 + r;
              const int j = j0 + 8 * n8 + 2 * t + b;
              const float la_j = b ? lt4.z : lt4.x, dt_j = b ? lt4.w : lt4.y;
              const float wv = j <= i && i < Q ? exp2_ftz((la_i[r2] - la_j) * kLog2e) : 0.0f;
              const float gw = gv[r] * wv, m = gw * dt_j, d = dm[idx];
              dgv[idx] = fmaf(d, wv * dt_j, dgv[idx]);
              const float tv = d * gw, sv = j < i ? d * m : 0.0f;
              row_s[r2] += sv;
              const int c = 2 * (n8 - 4 * half) + b;
              if (r2 == 0) {
                col_s[c] = sv;
                col_t[c] = tv;
              } else {
                col_s[c] += sv;
                col_t[c] += tv;
              }
              mv[b] = m;
            }
            *reinterpret_cast<float2*>(ms + il * kMLd + 8 * n8 + 2 * t) = make_float2(mv[0], mv[1]);
          }
        }
        // the column sums over the warp's 16 rows: halve the 8 columns of a
        // lane three times across the 8 rows of lanes (g bits 2, 1, 0),
        // which leaves lane g with column g of the 8 (j = 8 (4 half + (g >>
        // 1)) + 2 t + (g & 1))
#pragma unroll
        for (int step = 0; step < 3; ++step) {
          const int keep = 4 >> step;              // 4, 2, 1 columns kept
          const bool up = (g >> (2 - step)) & 1;   // this lane keeps the upper part
#pragma unroll
          for (int m2 = 0; m2 < keep; ++m2) {
            const float send_s = up ? col_s[m2] : col_s[m2 + keep];
            const float send_t = up ? col_t[m2] : col_t[m2 + keep];
            const float own_s = up ? col_s[m2 + keep] : col_s[m2];
            const float own_t = up ? col_t[m2 + keep] : col_t[m2];
            col_s[m2] = own_s + __shfl_xor_sync(0xffffffffu, send_s, 16 >> step);
            col_t[m2] = own_t + __shfl_xor_sync(0xffffffffu, send_t, 16 >> step);
          }
        }
        const int jl = 8 * (4 * half + (g >> 1)) + 2 * t + (g & 1);
        red[(w * 2 + 0) * T + jl] = col_s[0];
        red[(w * 2 + 1) * T + jl] = col_t[0];
      }
      // the row sums of S over this column tile: the lanes of a row, in order
#pragma unroll
      for (int r1 = 0; r1 < 2; ++r1) {
        float v = row_s[r1];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int i = i0 + 16 * w + g + 8 * r1;
        if (t == 0 && i < Q) rs[((bc * nt + jt) * H + h) * Q + i] = v;
      }
      warpgroup_sync(wg);   // M and the warps' column sums are whole
      {
        const int jl = wt & (T - 1), kind = wt >> 6, j = j0 + jl;
        float v = red[kind * T + jl];
#pragma unroll
        for (int ww = 1; ww < 4; ++ww) v += red[(ww * 2 + kind) * T + jl];
        if (j < Q) (kind ? tp : cs)[((bc * nt + it) * H + h) * Q + j] = v;
      }

      // this tile's dG back to its slot
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int i = i0 + 16 * w + g + 8 * r2, j = j0 + 8 * n8 + 2 * t;
          if (i < Q && j < Q) {
            if (j + 1 < Q)
              *reinterpret_cast<float2*>(dgo + (long long)i * Q + j) =
                  make_float2(dgv[4 * n8 + 2 * r2], dgv[4 * n8 + 2 * r2 + 1]);
            else
              dgo[(long long)i * Q + j] = dgv[4 * n8 + 2 * r2];
          }
        }

      // dx_j += M^T dy_i, left running into the next tile
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= 2) wgmma_wait<1>();
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_tf32(ms[(8 * kk + t + 4 * (r >> 1)) * kMLd + 16 * w + g + 8 * (r & 1)],
                     ah[kk & 1][r], al[kk & 1][r]);
        wgmma_fence();
        wgmma_3xtf32<true>(dxa, ah[kk & 1], al[kk & 1], dyt_desc + ((kk * kSlice) >> 4),
                           dyt_desc + (((8 + kk) * kSlice) >> 4), sp != 0 || kk != 0);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();

    // dx_j of head h: warpgroup 1's sum handed to warpgroup 0 (over its own
    // M tile), added after warpgroup 0's own, written once
    float* hand = reinterpret_cast<float*>(smem + L::kWg + L::kWgBytes + L::kM);
    if (wg == 1 && n_i > 1) {
#pragma unroll
      for (int r = 0; r < 32; ++r) hand[r * 128 + wt] = dxa[r];
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int r1 = 0; r1 < 2; ++r1) {
        const int j = j0 + 16 * w + g + 8 * r1;
        if (j >= Q) continue;
        float* row = dx + (bc * Q + j) * hq + (long long)h * kP + 8 * t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {   // elements 32 (q >> 1) + 8 t + 4 (q & 1) .. + 3
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int v = 4 * (q & 1) + e, n8 = 4 * (q >> 1) + (v >> 1);
            const int idx = 4 * n8 + 2 * r1 + (v & 1);
            o[e] = n_i > 1 ? dxa[idx] + hand[idx * 128 + wt] : dxa[idx];
          }
          *reinterpret_cast<float4*>(row + 32 * (q >> 1) + 4 * (q & 1)) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      }
    }
  }
}

// route 1: ssd_bwd_mma_kernel; route 0: the SIMT pair and dx kernels (gram
// their scratch). Then the finish kernel.
template <typename XIn, typename BCIn>
cudaError_t launch(int route, const void* x, const float* dt, const float* la, const void* bm,
                   const void* cm, const float* dy, float* gram, float* dgp, float* sums,
                   float* dx, float* ddt, float* dla, float* db, float* dc, int BC, int Q, int H,
                   int P, int N, int hpb, cudaStream_t s) {
  const int nt = (Q + T - 1) / T, n_groups = (H + hpb - 1) / hpb;
  const long long slots = (long long)BC * nt * H * Q;
  float *rs = sums, *cs = sums + slots, *tp = sums + 2 * slots;
  const XIn* xp = static_cast<const XIn*>(x);
  const BCIn* bmp = static_cast<const BCIn*>(bm);
  const BCIn* cmp = static_cast<const BCIn*>(cm);
  cudaError_t err;
  if (route == 1) {
    static const cudaError_t smem_err =
        cudaFuncSetAttribute(ssd_bwd_mma_kernel<XIn, BCIn>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MmaLayout::kBytes);
    if (smem_err != cudaSuccess) return smem_err;
    ssd_bwd_mma_kernel<XIn, BCIn><<<(unsigned)((long long)BC * nt * n_groups), kMmaThreads,
                                    MmaLayout::kBytes, s>>>(xp, dt, la, bmp, cmp, dy, dgp, rs,
                                                            cs, tp, dx, BC, Q, H, N, hpb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  } else {
    ssd_bwd_pair_kernel<XIn, BCIn><<<dim3((unsigned)(BC * nt * (nt + 1) / 2), n_groups),
                                     kThreads, 0, s>>>(xp, dt, la, bmp, cmp, dy, gram, dgp, rs,
                                                       cs, tp, Q, H, P, N, nt, hpb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)(BC * nt), H, (P + T - 1) / T);
    if (P % 4 == 0)
      ssd_bwd_dx_kernel<true><<<grid, kThreads, 0, s>>>(dt, la, gram, dy, dx, Q, H, P, nt);
    else
      ssd_bwd_dx_kernel<false><<<grid, kThreads, 0, s>>>(dt, la, gram, dy, dx, Q, H, P, nt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ssd_bwd_finish_kernel<BCIn><<<dim3((unsigned)(BC * nt), (N + T - 1) / T, 2), kThreads, 0, s>>>(
      bmp, cmp, dgp, rs, cs, tp, ddt, dla, db, dc, Q, H, N, nt, n_groups);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x: (BC, Q, H, P) of x_dtype; dt, la: (BC, Q, H) f32; bm, cm: (BC, Q, N) of
// bc_dtype (0 = float32, 1 = bfloat16); dy: (BC, Q, H, P) f32, all
// contiguous, dy 16-byte aligned. Scratch: dgp (BC, ceil(H /
// heads_per_block), Q, Q), sums (3, BC, ceil(Q / 64), H, Q), both f32, and
// for route 0 gram (BC, Q, Q) f32 (unused by route 1). Out (f32): dx (BC,
// Q, H, P), ddt and dla (BC, Q, H), db and dc (BC, Q, N). route 1 (the
// tensor cores) takes Q <= 256, P = 64, N a multiple of 32 up to 256 and
// x, bm, cm, dx 16-byte aligned, and refuses anything else.
extern "C" int repro_ssd_intra_backward(const void* x, const void* dt, const void* la,
                                        const void* bm, const void* cm, const void* dy,
                                        void* gram, void* dgp, void* sums, void* dx, void* ddt,
                                        void* dla, void* db, void* dc, int BC, int Q, int H,
                                        int P, int N, int x_dtype, int bc_dtype, int route,
                                        int heads_per_block, void* stream) {
  const long long nt = (Q + T - 1) / T;
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0 || x_dtype < 0 || x_dtype > 1 ||
      bc_dtype < 0 || bc_dtype > 1 || route < 0 || route > 1 || heads_per_block < 1 ||
      heads_per_block > H || (N + T - 1) / T > 65535 ||
      (H + heads_per_block - 1) / heads_per_block > 65535 || !aligned(dy, 16) ||
      !aligned(dx, 16))
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (nt > kMaxNt || P != kP || N % 32 != 0 || N > kMaxN || !aligned(x, 16) ||
        !aligned(bm, 16) || !aligned(cm, 16) ||
        (long long)BC * nt * ((H + heads_per_block - 1) / heads_per_block) > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
  } else if (gram == nullptr || H > 65535 || (P + T - 1) / T > 65535 ||
             (long long)BC * nt * (nt + 1) / 2 > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* lap = static_cast<const float*>(la);
  const float* dyp = static_cast<const float*>(dy);
  float* g = static_cast<float*>(gram);
  float* dg = static_cast<float*>(dgp);
  float* sm = static_cast<float*>(sums);
  float *dxp = static_cast<float*>(dx), *ddtp = static_cast<float*>(ddt);
  float *dlap = static_cast<float*>(dla), *dbp = static_cast<float*>(db);
  float* dcp = static_cast<float*>(dc);
  const int hpb = heads_per_block;
  if (x_dtype == 0)
    return (int)(bc_dtype == 0
                     ? launch<float, float>(route, x, dtp, lap, bm, cm, dyp, g, dg, sm, dxp,
                                            ddtp, dlap, dbp, dcp, BC, Q, H, P, N, hpb, s)
                     : launch<float, __nv_bfloat16>(route, x, dtp, lap, bm, cm, dyp, g, dg, sm,
                                                    dxp, ddtp, dlap, dbp, dcp, BC, Q, H, P, N,
                                                    hpb, s));
  return (int)(bc_dtype == 0
                   ? launch<__nv_bfloat16, float>(route, x, dtp, lap, bm, cm, dyp, g, dg, sm,
                                                  dxp, ddtp, dlap, dbp, dcp, BC, Q, H, P, N, hpb,
                                                  s)
                   : launch<__nv_bfloat16, __nv_bfloat16>(route, x, dtp, lap, bm, cm, dyp, g, dg,
                                                          sm, dxp, ddtp, dlap, dbp, dcp, BC, Q,
                                                          H, P, N, hpb, s));
}
