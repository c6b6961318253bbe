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
// (67 TFLOP/s), 0.032 ms over 3.35 TB/s. So in f32 FMA it is bound by
// operations; the products on the tensor cores (3xTF32, as the forward)
// would make it bound by bytes. This first kernel is SIMT f32 FMA.
//
// Three launches, all 64 x 64 tiles, 256 threads each with a 4 x 4
// register tile (threads (ty, tx): rows 4 ty .. 4 ty + 3, columns 4 tx ..
// 4 tx + 3):
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
//     rebuilt from the Gram scratch as the forward's SIMT route builds them;
//   * ssd_bwd_finish_kernel, one block a (chunk, row tile, 64 columns of N,
//     dB or dC): dC = dG B and dB = dG^T C over the tiles, dG summed over
//     the head groups in group order as it is loaded; the blocks also sum
//     d dt and d la over the tile pairs, a slice each.
// Every sum runs in a fixed order and no float is added atomically, so the
// same call gives the same bits. What holds it above its bound (PERF.md):
// the pair kernel walks its heads one after another, and each head's dy and
// x slices are staged with nothing else in flight; it is most of the time.
//
// C interface for ctypes: pointers and the CUDA stream as void*, and the
// return value is the launches' cudaError_t. The scratch is the caller's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename XIn, typename BCIn>
cudaError_t launch(const void* x, const float* dt, const float* la, const void* bm,
                   const void* cm, const float* dy, float* gram, float* dgp, float* sums,
                   float* dx, float* ddt, float* dla, float* db, float* dc, int BC, int Q, int H,
                   int P, int N, int hpb, cudaStream_t s) {
  const int nt = (Q + T - 1) / T, n_groups = (H + hpb - 1) / hpb;
  const long long slots = (long long)BC * nt * H * Q;
  float *rs = sums, *cs = sums + slots, *tp = sums + 2 * slots;
  const BCIn* bmp = static_cast<const BCIn*>(bm);
  const BCIn* cmp = static_cast<const BCIn*>(cm);
  ssd_bwd_pair_kernel<XIn, BCIn><<<dim3((unsigned)(BC * nt * (nt + 1) / 2), n_groups),
                                   kThreads, 0, s>>>(
      static_cast<const XIn*>(x), dt, la, bmp, cmp, dy, gram, dgp, rs, cs, tp, Q, H, P, N, nt,
      hpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(BC * nt), H, (P + T - 1) / T);
  if (P % 4 == 0)
    ssd_bwd_dx_kernel<true><<<grid, kThreads, 0, s>>>(dt, la, gram, dy, dx, Q, H, P, nt);
  else
    ssd_bwd_dx_kernel<false><<<grid, kThreads, 0, s>>>(dt, la, gram, dy, dx, Q, H, P, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_finish_kernel<BCIn><<<dim3((unsigned)(BC * nt), (N + T - 1) / T, 2), kThreads, 0, s>>>(
      bmp, cmp, dgp, rs, cs, tp, ddt, dla, db, dc, Q, H, N, nt, n_groups);
  return cudaGetLastError();
}

}  // namespace

// x: (BC, Q, H, P) of x_dtype; dt, la: (BC, Q, H) f32; bm, cm: (BC, Q, N) of
// bc_dtype (0 = float32, 1 = bfloat16); dy: (BC, Q, H, P) f32, all
// contiguous, dy 16-byte aligned. Scratch: gram (BC, Q, Q), dgp (BC,
// ceil(H / heads_per_block), Q, Q), sums (3, BC, ceil(Q / 64), H, Q), all
// f32. Out (f32): dx (BC, Q, H, P), ddt and dla (BC, Q, H), db and dc (BC,
// Q, N).
extern "C" int repro_ssd_intra_backward(const void* x, const void* dt, const void* la,
                                        const void* bm, const void* cm, const void* dy,
                                        void* gram, void* dgp, void* sums, void* dx, void* ddt,
                                        void* dla, void* db, void* dc, int BC, int Q, int H,
                                        int P, int N, int x_dtype, int bc_dtype,
                                        int heads_per_block, void* stream) {
  const long long nt = (Q + T - 1) / T;
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0 || x_dtype < 0 || x_dtype > 1 ||
      bc_dtype < 0 || bc_dtype > 1 || heads_per_block < 1 || heads_per_block > H ||
      H > 65535 || (P + T - 1) / T > 65535 || (N + T - 1) / T > 65535 ||
      (long long)BC * nt * (nt + 1) / 2 > 0x7fffffffLL ||
      (H + heads_per_block - 1) / heads_per_block > 65535 ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0 || reinterpret_cast<uintptr_t>(dx) % 16 != 0)
    return (int)cudaErrorInvalidValue;
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
                     ? launch<float, float>(x, dtp, lap, bm, cm, dyp, g, dg, sm, dxp, ddtp, dlap,
                                            dbp, dcp, BC, Q, H, P, N, hpb, s)
                     : launch<float, __nv_bfloat16>(x, dtp, lap, bm, cm, dyp, g, dg, sm, dxp,
                                                    ddtp, dlap, dbp, dcp, BC, Q, H, P, N, hpb,
                                                    s));
  return (int)(bc_dtype == 0
                   ? launch<__nv_bfloat16, float>(x, dtp, lap, bm, cm, dyp, g, dg, sm, dxp, ddtp,
                                                  dlap, dbp, dcp, BC, Q, H, P, N, hpb, s)
                   : launch<__nv_bfloat16, __nv_bfloat16>(x, dtp, lap, bm, cm, dyp, g, dg, sm,
                                                          dxp, ddtp, dlap, dbp, dcp, BC, Q, H, P,
                                                          N, hpb, s));
}
