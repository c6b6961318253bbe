// Fused dequantize-and-MLP forward of the distilled dispatch trunk, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flat_trunk.py::
// flat_trunk_pallas (_trunk_kernel). Per layer i: w = codes_i * ((mx_i -
// mn_i) / levels) + mn_i (paper Eq. 2), h = h @ w + b_i, tanh between
// layers, linear last; f32 out.
//
// Bound on the H100: at the serving size (M = 1024 rows, 19 -> 64 -> 64 ->
// 13, 6 144 weights) the least work is 2 M 6144 = 12.6 MFLOP, 0.19 us at
// 67 TFLOP/s, against some 0.1 MB of bytes (1.9 us of operations at
// M = 10 240). What bounds the kernel is the length of its critical path:
// the codes' copy, their dequantization, then each layer's products and a
// barrier. An 8-row tile's layer on the SIMT cores (register tiles, K
// split over lanes) spent most of its time loading operands from shared
// memory and ran slower on the card than the design below (PERF.md):
//   * one launch of a persistent grid (kernels/flat_trunk.py::plan):
//     min(row tiles, SMs x resident blocks) blocks, each walking 8-row tiles
//     with stride gridDim.x, so no grid needs a second wave and each block
//     dequantizes the weights once, however many tiles it takes;
//   * at entry the first lane of warp l starts a bulk copy of layer l's
//     codes into shared memory on an mbarrier, the warps in parallel (one
//     thread issuing every copy was slower); ordinary loads where a
//     layer's bytes or address is not a multiple of 16 (the "loads" route,
//     chosen before the launch); the threads start the first tile's rows
//     by cp.async and load the biases; the next tile's rows are in flight
//     while the current tile computes;
//   * the weights are dequantized once a block with quant.cuh's explicitly
//     rounded multiply and add (bit-equal to the plain twin's) and stored
//     as float64 in the FP64 tensor cores' fragment order;
//   * each layer runs on the FP64 tensor cores, mma.m8n8k4: an 8-row tile
//     is exactly one m8 fragment, a warp takes an 8-column tile (and a part
//     of K where the layer has fewer than 8 column tiles, the parts summed
//     in a fixed order). Each product of two f32 values is exact in f64 and
//     the sums run in f64, then round once to f32, so a row of the identity
//     returns the dequantized weights bit for bit, and the result is at
//     least as accurate as f32 FMA (TF32 would miss the reference's 1e-5).
// Measured on the H100 (PERF.md; clock64 stamps in a copy of this kernel,
// M = 1024): a block spends about 1.2 us before the codes have landed,
// 1.9 us dequantizing and 0.6-0.9 us a layer.
// The bias is added in f32 after the product, as in h @ w + b; tanh in f32.
// The layer count and widths come in a descriptor passed by value, so no
// width is compiled in.
//
// C interface for ctypes: device pointers as void*, the descriptor as host
// arrays, the CUDA stream as void*, and the return value is
// cudaGetLastError() after the launch. Nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "quant.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kRows = 8;          // rows a tile: one m8 fragment; 128 tiles at M = 1024
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;

__host__ __device__ constexpr int up8(int v) { return (v + 7) & ~7; }
__host__ __device__ constexpr int up16(int v) { return (v + 15) & ~15; }

// One layer as the kernel reads it. The kernel copies the descriptor's
// layers into shared memory at entry, so its loops over layers index shared
// memory rather than the parameter space.
struct Layer {
  int nin, nout, n_nt, n_ks;     // widths; 8-column tiles, 4-deep K steps
  int split, log_split, per;     // warps splitting K (a power of two), steps a part
  int w_off, b_off, c_off;       // f64 fragments, f32 biases, codes in the staging area (bytes)
  const void* codes;
  const float* bias;
  float mn, mx;
};

struct TrunkDesc {
  int n_layers, n_bias;                  // layers; the padded biases of all of them
  int info_off, part_off, act_off, lda;  // layers, K parts' sums, activation tiles (bytes)
  int x_off, stage_off, bar_off;         // row stages, codes' staging area, mbarrier (bytes)
  Layer layer[kMaxLayers];
};

// Shared memory, in bytes: every layer's weights as f64 fragments (K padded
// to 4, N to 8, pads zero), the K parts' sums, two f64 activation tiles of
// the widest hidden layer (rows padded by 4 against bank conflicts), the
// layers' table, the f32 biases (padded to 8), two f32 stages of row tiles,
// the codes' staging area (bulk route only) and the mbarrier.
// The planner takes the total from repro_flat_trunk_plan.
size_t layout(TrunkDesc& desc, int in_dim, int code_bytes, bool bulk) {
  const int n = desc.n_layers;
  int o = 0, hidden = 0, stage = 0;
  for (int l = 0; l < n; ++l) {
    desc.layer[l].w_off = o;
    o += 8 * 4 * desc.layer[l].n_ks * 8 * desc.layer[l].n_nt;
  }
  desc.part_off = o;
  o += 8 * kThreads * 2;
  for (int l = 0; l + 1 < n; ++l)
    hidden = 8 * desc.layer[l].n_nt > hidden ? 8 * desc.layer[l].n_nt : hidden;
  desc.lda = hidden > 0 ? hidden + 4 : 0;
  desc.act_off = o;
  o += 8 * 2 * kRows * desc.lda;
  desc.info_off = o;
  o += (int)sizeof(Layer) * n;
  desc.n_bias = 0;
  for (int l = 0; l < n; ++l) {
    desc.layer[l].b_off = o + 4 * desc.n_bias;
    desc.n_bias += 8 * desc.layer[l].n_nt;
  }
  o += 4 * desc.n_bias;
  desc.x_off = o;
  o += 4 * 2 * kRows * up4(in_dim);
  for (int l = 0; l < n; ++l) {
    desc.layer[l].c_off = stage;
    if (bulk) stage += desc.layer[l].nin * desc.layer[l].nout * code_bytes;
  }
  desc.stage_off = up16(o);
  desc.bar_off = up8(desc.stage_off + stage);
  return (size_t)desc.bar_off + sizeof(uint64_t);
}

// d += a b for one m8n8k4 f64 fragment: a is A[lane / 4][lane % 4], b is
// B[lane % 4][lane / 4], d holds D[lane / 4][2 (lane % 4) + 0, 1]
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// a code as float32, exactly (codes < 2^23: the integer in the mantissa
// of 2^23, minus 2^23), with full-rate ALU operations in place of a
// conversion
__device__ __forceinline__ float code_value(uint32_t code) {
  return __fsub_rn(__uint_as_float(0x4B000000u | code), 8388608.0f);
}

// a row tile (rows x f, row-major in x) into a stage of row stride f4 by
// 4-byte cp.async, then one commit
__device__ __forceinline__ void load_rows(float* stage, const float* __restrict__ x, int tile,
                                          int m, int f, int f4) {
  const int row0 = tile * kRows, rows = min(kRows, m - row0);
  for (int i = threadIdx.x; i < rows * f; i += kThreads) {
    const int r = i / f;
    cp_async_f32(stage + r * f4 + (i - r * f), x + (size_t)row0 * f + i, true);
  }
  cp_async_commit();
}

template <typename Code>
__global__ void __launch_bounds__(kThreads)
flat_trunk_persistent_kernel(const float* __restrict__ x, float* __restrict__ out, int m,
                             TrunkDesc desc, float levels, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + desc.bar_off);
  double* part = reinterpret_cast<double*>(smem + desc.part_off);
  float* stages = reinterpret_cast<float*>(smem + desc.x_off);
  Layer* info = reinterpret_cast<Layer*>(smem + desc.info_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // the fragments' row (or column) and K index
  const int n_layers = desc.n_layers, f = desc.layer[0].nin, f4 = up4(f);
  const int n_tiles = (m + kRows - 1) / kRows;

  // one arrival a layer: warp l's first lane copies layer l's entry of the
  // table, then starts its codes' copy (the warps issue in parallel)
  if (tid == 0) {
    mbar_init(bar, n_layers);
    mbar_fence_init();
  }
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l)
    if (tid == 32 * l && l < n_layers) info[l] = desc.layer[l];
  // the stages' pad columns stay zero (the copies write only the f columns)
  if (tid < 2 * kRows)
    for (int c = f; c < f4; ++c) stages[tid * f4 + c] = 0.0f;
  __syncthreads();
  if (bulk && lane == 0 && warp < n_layers) {
    const uint32_t bytes = info[warp].nin * info[warp].nout * sizeof(Code);
    mbar_arrive_expect_tx(bar, bytes);
    bulk_copy(smem + desc.stage_off + info[warp].c_off, info[warp].codes, bytes, bar);
  }
  load_rows(stages, x, blockIdx.x, m, f, f4);
  // the biases, padded to 8, one after another in shared memory: a strided
  // walk over all of them, each element's layer found by its offset
  {
    float* b_all = reinterpret_cast<float*>(smem + info[0].b_off);
    for (int i = tid; i < desc.n_bias; i += kThreads) {
      int l = 0, j = i;
      while (j >= 8 * info[l].n_nt) j -= 8 * info[l++].n_nt;
      b_all[i] = j < info[l].nout ? info[l].bias[j] : 0.0f;
    }
  }
  if (bulk) mbar_wait(bar, 0);
  // dequantize once a block into f64 fragments: fragment (ks, nt) holds
  // W[4 ks + lane % 4][8 nt + lane / 4] at lane
  for (int l = 0; l < n_layers; ++l) {
    const int nin = info[l].nin, nout = info[l].nout, n_nt = info[l].n_nt;
    const Code* codes = bulk ? reinterpret_cast<const Code*>(smem + desc.stage_off + info[l].c_off)
                             : static_cast<const Code*>(info[l].codes);
    const float mn = info[l].mn;
    const float step = dequant_step(mn, info[l].mx, levels);
    double* w = reinterpret_cast<double*>(smem + info[l].w_off);
    for (int ks = warp; ks < info[l].n_ks; ks += kWarps) {
      const int k = 4 * ks + t;
#pragma unroll 4
      for (int nt = 0; nt < n_nt; ++nt) {
        const int c = 8 * nt + g;
        w[(ks * n_nt + nt) * 32 + lane] =
            k < nin && c < nout ? (double)dequant_value(code_value(codes[k * nout + c]), step, mn)
                                : 0.0;
      }
    }
  }

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    cp_async_wait<0>();
    __syncthreads();   // this tile's rows landed; the last tile's readers are done
    if (tile + (int)gridDim.x < n_tiles)
      load_rows(stages + ((it + 1) & 1) * kRows * f4, x, tile + gridDim.x, m, f, f4);
    const int row0 = tile * kRows, rows = min(kRows, m - row0);
    const float* x_tile = stages + (it & 1) * kRows * f4;
    const double* src = nullptr;   // the previous layer's activations (layer 0: x_tile)
    for (int l = 0; l < n_layers; ++l) {
      const int nout = info[l].nout, n_nt = info[l].n_nt, n_ks = info[l].n_ks;
      const int split = info[l].split, log_split = info[l].log_split, per = info[l].per;
      const bool last = l == n_layers - 1;
      const double* w = reinterpret_cast<const double*>(smem + info[l].w_off);
      const float* b = reinterpret_cast<const float*>(smem + info[l].b_off);
      double* dst = reinterpret_cast<double*>(smem + desc.act_off) + (l & 1) * kRows * desc.lda;
      // the output fragment's epilogue: round the f64 sums once to f32,
      // add the bias, tanh between layers; pad columns written as zeros
      // (the next layer's K reads them)
      auto finish = [&](int nt, double c0, double c1) {
        const int c = 8 * nt + 2 * t;
        const float s0 = __fadd_rn(__double2float_rn(c0), b[c]);
        const float s1 = __fadd_rn(__double2float_rn(c1), b[c + 1]);
        if (last) {
          float* o = out + (size_t)(row0 + g) * nout + c;
          if (g < rows && c < nout) o[0] = s0;
          if (g < rows && c + 1 < nout) o[1] = s1;
        } else {
          dst[g * desc.lda + c] = c < nout ? (double)tanhf(s0) : 0.0;
          dst[g * desc.lda + c + 1] = c + 1 < nout ? (double)tanhf(s1) : 0.0;
        }
      };
      for (int unit = warp; unit < n_nt * split; unit += kWarps) {
        const int nt = unit >> log_split, ks0 = (unit & (split - 1)) * per;
        const int ks1 = min(n_ks, ks0 + per);
        double acc0[2] = {0.0, 0.0}, acc1[2] = {0.0, 0.0};
        auto a_at = [&](int ks) {
          return l == 0 ? (double)x_tile[g * f4 + 4 * ks + t] : src[g * desc.lda + 4 * ks + t];
        };
        int ks = ks0;
#pragma unroll 4
        for (; ks + 1 < ks1; ks += 2) {
          dmma(acc0, a_at(ks), w[(ks * n_nt + nt) * 32 + lane]);
          dmma(acc1, a_at(ks + 1), w[((ks + 1) * n_nt + nt) * 32 + lane]);
        }
        if (ks < ks1) dmma(acc0, a_at(ks), w[(ks * n_nt + nt) * 32 + lane]);
        const double c0 = acc0[0] + acc1[0], c1 = acc0[1] + acc1[1];
        if (split == 1) {
          finish(nt, c0, c1);
        } else {
          part[(unit * 32 + lane) * 2] = c0;
          part[(unit * 32 + lane) * 2 + 1] = c1;
        }
      }
      if (split > 1) {
        // the K parts' sums, in part order
        __syncthreads();
        for (int nt = warp; nt < n_nt; nt += kWarps) {
          double c0 = 0.0, c1 = 0.0;
          for (int q = 0; q < split; ++q) {
            c0 += part[((nt * split + q) * 32 + lane) * 2];
            c1 += part[((nt * split + q) * 32 + lane) * 2 + 1];
          }
          finish(nt, c0, c1);
        }
      }
      if (!last) {
        __syncthreads();
        src = dst;
      }
    }
  }
}

// the descriptor's widths from the host array; false if they are malformed
bool set_widths(TrunkDesc& desc, int n_layers, const int* dims) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  desc = TrunkDesc{};
  desc.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = desc.layer[l];
    if (dims[l] <= 0 || dims[l + 1] <= 0) return false;
    L.nin = dims[l];
    L.nout = dims[l + 1];
    L.n_nt = up8(L.nout) / 8;
    L.n_ks = up4(L.nin) / 4;
  }
  return true;
}

// the whole descriptor from the host arrays; false if they are malformed
bool make_desc(TrunkDesc& desc, int n_layers, const int* dims, void* const* code_ptrs,
               void* const* bias_ptrs, const float* mns, const float* mxs,
               const int* k_split) {
  if (!set_widths(desc, n_layers, dims)) return false;
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = desc.layer[l];
    // a split layer's column tiles x parts fit the warps' partial sums
    const int s = k_split[l];
    if (s < 1 || (s & (s - 1)) != 0 || (s > 1 && L.n_nt * s > kWarps)) return false;
    L.split = s;
    L.log_split = __builtin_ctz(s);
    L.per = (L.n_ks + s - 1) / s;
    L.codes = code_ptrs[l];
    L.bias = static_cast<const float*>(bias_ptrs[l]);
    L.mn = mns[l];
    L.mx = mxs[l];
  }
  return true;
}

template <typename Code>
int launch(const void* x, void* out, int m, TrunkDesc& desc, int bits, int grid, int bulk,
           cudaStream_t stream) {
  if (bulk)
    for (int l = 0; l < desc.n_layers; ++l)
      if (reinterpret_cast<uintptr_t>(desc.layer[l].codes) % 16 != 0 ||
          (desc.layer[l].nin * desc.layer[l].nout * sizeof(Code)) % 16 != 0)
        return (int)cudaErrorInvalidValue;
  const size_t smem = layout(desc, desc.layer[0].nin, (int)sizeof(Code), bulk != 0);
  cudaError_t err = allow_smem<flat_trunk_persistent_kernel<Code>>(smem);
  if (err != cudaSuccess) return (int)err;
  const float levels = (float)((1 << bits) - 1);
  flat_trunk_persistent_kernel<Code><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), m, desc, levels, bulk);
  return (int)cudaGetLastError();
}

// the kernel's shared memory for these widths and the blocks of it an SM
// holds (0 where it does not fit a block)
template <typename Code>
int plan(TrunkDesc& desc, int bulk, long long* smem_bytes, int* blocks) {
  const size_t smem = layout(desc, desc.layer[0].nin, (int)sizeof(Code), bulk != 0);
  *smem_bytes = (long long)smem;
  *blocks = 0;
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess || smem > (size_t)most) return (int)err;
  err = allow_smem<flat_trunk_persistent_kernel<Code>>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, flat_trunk_persistent_kernel<Code>, kThreads, smem);
  return (int)err;
}

}  // namespace

// x: (m, dims[0]) float32; out: (m, dims[n_layers]) float32; dims: n_layers
// + 1 widths; code_ptrs: per-layer (dims[l], dims[l+1]) codes, uint8 for
// bits <= 8, else uint16; bias_ptrs: per-layer (dims[l+1],) float32; mns,
// mxs: per-layer range; k_split: per-layer warps splitting K (a split
// layer's 8-column tiles x parts at most 8); grid: the persistent grid's
// blocks; bulk: 1 for the bulk-copy route (every layer's codes 16-byte
// aligned, a multiple of 16 bytes), 0 for ordinary loads. dims and the
// pointer, range and split arrays are host arrays, copied into the
// descriptor.
extern "C" int repro_flat_trunk(const void* x, void* out, int m, int n_layers,
                                const int* dims, void* const* code_ptrs,
                                void* const* bias_ptrs, const float* mns,
                                const float* mxs, const int* k_split, int bits, int grid,
                                int bulk, void* stream) {
  TrunkDesc desc;
  if (m <= 0 || grid <= 0 || bits < 1 || bits > 16 ||
      !make_desc(desc, n_layers, dims, code_ptrs, bias_ptrs, mns, mxs, k_split))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bits > 8 ? launch<uint16_t>(x, out, m, desc, bits, grid, bulk, s)
                  : launch<uint8_t>(x, out, m, desc, bits, grid, bulk, s);
}

// For the planner (kernels/flat_trunk.py): the shared memory, in bytes,
// that the kernel takes for a trunk of widths dims at `bits` by the bulk
// (1) or loads (0) route, and the blocks of it that one SM of the current
// device holds (0 where it does not fit a block: the persistent grid's
// per-SM count).
extern "C" int repro_flat_trunk_plan(int n_layers, const int* dims, int bits, int bulk,
                                     long long* smem_bytes, int* blocks) {
  TrunkDesc desc;
  if (bits < 1 || bits > 16 || !set_widths(desc, n_layers, dims))
    return (int)cudaErrorInvalidValue;
  return bits > 8 ? plan<uint16_t>(desc, bulk, smem_bytes, blocks)
                  : plan<uint8_t>(desc, bulk, smem_bytes, blocks);
}
