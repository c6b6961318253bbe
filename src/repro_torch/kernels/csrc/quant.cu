// Linear min-max quantize / dequantize (paper Eq. 1-2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/quant.py::quantize_2d
// (_quant_kernel) and ::dequantize_2d (_dequant_kernel).
//
// Bound on the H100: bytes. Each element is read once and written once and
// costs a handful of flops, so the floor is (input + output bytes) over the
// 3.35 TB/s of HBM3. The design is one grid-stride pass with each thread on
// neighbouring addresses, so every warp load and store is coalesced; the
// TPU's (256, 512) VMEM tiling has no counterpart, since nothing is reused.
//
// Numerics match the plain PyTorch twins in kernels/quant.py bit for bit:
//   * rintf rounds half to even, as jnp.round and torch.round do;
//   * every step uses an explicitly rounded intrinsic (__fsub_rn, __fmul_rn,
//     __fadd_rn, __fdiv_rn; dequantize's are in quant.cuh), so nvcc cannot
//     contract y * step + mn into an FMA, whose single rounding would
//     differ from the two roundings of the plain version.
//
// C interface for ctypes: pointers as void*, the CUDA stream as void*, and
// the return value is cudaGetLastError() after the launch. Nothing is
// allocated here: the Python wrapper allocates the output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename In, typename Code>
__global__ void quantize_kernel(const In* __restrict__ x, Code* __restrict__ y,
                                long long n, float mn, float mx, float levels) {
  const float scale = __fdiv_rn(levels, fmaxf(__fsub_rn(mx, mn), 1e-12f));
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float q = rintf(__fmul_rn(__fsub_rn(load_f32(x, i), mn), scale));
    q = fminf(fmaxf(q, 0.0f), levels);
    y[i] = (Code)q;
  }
}

template <typename Code, typename Out>
__global__ void dequantize_kernel(const Code* __restrict__ y, Out* __restrict__ out,
                                  long long n, float mn, float mx, float levels) {
  const float step = dequant_step(mn, mx, levels);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    store_f32(out, i, dequant_value((float)y[i], step, mn));
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename In, typename Code>
void launch_quantize(const void* x, void* y, long long n, float mn, float mx,
                     float levels, cudaStream_t s) {
  quantize_kernel<In, Code><<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const In*>(x), static_cast<Code*>(y), n, mn, mx, levels);
}

template <typename Code, typename Out>
void launch_dequantize(const void* y, void* out, long long n, float mn, float mx,
                       float levels, cudaStream_t s) {
  dequantize_kernel<Code, Out><<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const Code*>(y), static_cast<Out*>(out), n, mn, mx, levels);
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16. Codes are uint8 for bits <= 8, else
// uint16. n > 0 elements, contiguous.
extern "C" int repro_quantize(const void* x, void* y, long long n, int in_dtype,
                              int bits, float mn, float mx, void* stream) {
  if (n <= 0 || bits < 1 || bits > 16 || in_dtype < 0 || in_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float levels = (float)((1 << bits) - 1);
  const bool wide = bits > 8;
  if (in_dtype == 0) {
    if (wide) launch_quantize<float, uint16_t>(x, y, n, mn, mx, levels, s);
    else launch_quantize<float, uint8_t>(x, y, n, mn, mx, levels, s);
  } else {
    if (wide) launch_quantize<__nv_bfloat16, uint16_t>(x, y, n, mn, mx, levels, s);
    else launch_quantize<__nv_bfloat16, uint8_t>(x, y, n, mn, mx, levels, s);
  }
  return (int)cudaGetLastError();
}

// out_dtype: 0 = float32, 1 = bfloat16. Codes as in repro_quantize.
extern "C" int repro_dequantize(const void* y, void* out, long long n, int out_dtype,
                                int bits, float mn, float mx, void* stream) {
  if (n <= 0 || bits < 1 || bits > 16 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float levels = (float)((1 << bits) - 1);
  const bool wide = bits > 8;
  if (out_dtype == 0) {
    if (wide) launch_dequantize<uint16_t, float>(y, out, n, mn, mx, levels, s);
    else launch_dequantize<uint8_t, float>(y, out, n, mn, mx, levels, s);
  } else {
    if (wide) launch_dequantize<uint16_t, __nv_bfloat16>(y, out, n, mn, mx, levels, s);
    else launch_dequantize<uint8_t, __nv_bfloat16>(y, out, n, mn, mx, levels, s);
  }
  return (int)cudaGetLastError();
}
