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
// 67 TFLOP/s, against some 0.1 MB of bytes, so the launch bounds it. The
// design is one launch: the TPU kernel keeps every layer's codes resident
// and dequantizes them per 512-row block; here each block of 8 rows
// dequantizes every layer once into shared memory (24.6 KB of f32 at the
// serving widths) with quant.cuh's explicitly rounded multiply and add, so
// the weights are bit-equal to the plain twin's, then runs the layers out
// of two ping-pong activation tiles (8 rows x the widest layer). Small
// blocks give enough of them to fill the SMs at a thousand rows, so the
// dependent FMA chains of many blocks overlap (64-row blocks, 16 at
// M = 1024, left most SMs idle). Each
// output is an f32 FMA chain in k order (TF32 would miss the reference's
// 1e-5), the bias added after it as in h @ w + b. The layer count and
// widths come in a descriptor passed by value, so no width is compiled in.
//
// C interface for ctypes: device pointers as void*, the descriptor as host
// arrays, the CUDA stream as void*, and the return value is
// cudaGetLastError() after the launch. Nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int kRows = 8;         // rows per block: 128 blocks at M = 1024
constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;

struct TrunkDesc {
  int n_layers;
  int dims[kMaxLayers + 1];      // in, hidden..., out
  int w_off[kMaxLayers];         // each layer's offset in the shared weights
  int b_off[kMaxLayers];         // and in the shared biases
  int max_dim;                   // widest activation
  const void* codes[kMaxLayers];
  const float* bias[kMaxLayers];
  float mn[kMaxLayers];
  float mx[kMaxLayers];
};

template <typename Code>
__global__ void __launch_bounds__(kThreads)
flat_trunk_kernel(const float* __restrict__ x, float* __restrict__ out, int m,
                  TrunkDesc desc, float levels, int n_weights, int n_bias) {
  extern __shared__ float sm[];
  float* w_s = sm;
  float* b_s = w_s + n_weights;
  float* act0 = b_s + n_bias;
  float* act1 = act0 + kRows * desc.max_dim;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, m - row0);
  const int stride = desc.max_dim;

  for (int l = 0; l < desc.n_layers; ++l) {
    const Code* codes = static_cast<const Code*>(desc.codes[l]);
    const int count = desc.dims[l] * desc.dims[l + 1];
    const float mn = desc.mn[l];
    const float step = dequant_step(mn, desc.mx[l], levels);
    float* w = w_s + desc.w_off[l];
    for (int i = tid; i < count; i += kThreads) w[i] = dequant_value((float)codes[i], step, mn);
    for (int i = tid; i < desc.dims[l + 1]; i += kThreads) b_s[desc.b_off[l] + i] = desc.bias[l][i];
  }
  const int f = desc.dims[0];
  for (int i = tid; i < rows * f; i += kThreads) {
    const int r = i / f;
    act0[r * stride + (i - r * f)] = x[(size_t)row0 * f + i];
  }
  __syncthreads();

  float* h = act0;
  float* nxt = act1;
  for (int l = 0; l < desc.n_layers; ++l) {
    const int nin = desc.dims[l], nout = desc.dims[l + 1];
    const float* w = w_s + desc.w_off[l];
    const float* b = b_s + desc.b_off[l];
    const bool last = l == desc.n_layers - 1;
    for (int i = tid; i < rows * nout; i += kThreads) {
      const int r = i / nout, j = i - r * nout;
      const float* hr = h + r * stride;
      float acc = 0.0f;
      for (int k = 0; k < nin; ++k) acc = fmaf(hr[k], w[k * nout + j], acc);
      acc = __fadd_rn(acc, b[j]);
      if (last) out[(size_t)(row0 + r) * nout + j] = acc;
      else nxt[r * stride + j] = tanhf(acc);
    }
    __syncthreads();
    float* t = h;
    h = nxt;
    nxt = t;
  }
}

}  // namespace

// x: (m, dims[0]) float32; out: (m, dims[n_layers]) float32; dims: n_layers
// + 1 widths; code_ptrs: per-layer (dims[l], dims[l+1]) codes, uint8 for
// bits <= 8, else uint16; bias_ptrs: per-layer (dims[l+1],) float32; mns,
// mxs: per-layer range. dims and the pointer and range arrays are host
// arrays, copied into the descriptor.
extern "C" int repro_flat_trunk(const void* x, void* out, int m, int n_layers,
                                const int* dims, void* const* code_ptrs,
                                void* const* bias_ptrs, const float* mns,
                                const float* mxs, int bits, void* stream) {
  if (m <= 0 || n_layers < 1 || n_layers > kMaxLayers || bits < 1 || bits > 16)
    return (int)cudaErrorInvalidValue;
  TrunkDesc desc{};
  desc.n_layers = n_layers;
  int n_weights = 0, n_bias = 0, max_dim = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    desc.dims[l] = dims[l];
    max_dim = dims[l] > max_dim ? dims[l] : max_dim;
  }
  for (int l = 0; l < n_layers; ++l) {
    desc.w_off[l] = n_weights;
    desc.b_off[l] = n_bias;
    n_weights += dims[l] * dims[l + 1];
    n_bias += dims[l + 1];
    desc.codes[l] = code_ptrs[l];
    desc.bias[l] = static_cast<const float*>(bias_ptrs[l]);
    desc.mn[l] = mns[l];
    desc.mx[l] = mxs[l];
  }
  desc.max_dim = max_dim;
  const size_t smem = sizeof(float) * ((size_t)n_weights + n_bias + 2 * (size_t)kRows * max_dim);
  const float levels = (float)((1 << bits) - 1);
  const int blocks = (m + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits > 8) {
    err = cudaFuncSetAttribute(flat_trunk_kernel<uint16_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flat_trunk_kernel<uint16_t><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), m, desc, levels,
        n_weights, n_bias);
  } else {
    err = cudaFuncSetAttribute(flat_trunk_kernel<uint8_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flat_trunk_kernel<uint8_t><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), m, desc, levels,
        n_weights, n_bias);
  }
  return (int)cudaGetLastError();
}
