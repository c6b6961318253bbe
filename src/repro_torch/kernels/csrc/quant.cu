// Linear min-max quantize / dequantize (paper Eq. 1-2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/quant.py::quantize_2d
// (_quant_kernel) and ::dequantize_2d (_dequant_kernel).
//
// Bound on the H100: bytes. Each element is read once and written once and
// costs a handful of flops, so the floor is (input + output bytes) over the
// 3.35 TB/s of HBM3. The TPU's (256, 512) VMEM tiling has no counterpart,
// since nothing is reused.
//
// quantize is one grid-stride pass with each thread on neighbouring
// addresses, so every warp load and store is coalesced.
//
// dequantize moves 5 bytes an element, and at the serving size (2.62 MB)
// launch, latency and drain set its floor, not bytes. Each thread takes
// four codes with one vector load (4 bytes of uint8, 8 of uint16) and
// writes them with one streaming vector store (16 bytes of f32, 8 of bf16),
// so the serving size's 131 072 chunks run as 512 blocks of 256 threads,
// about four resident an SM: many short threads keep more loads and stores
// in flight than few long ones (a sweep of 4, 8 and 16 codes a thread on
// the H100 found 4 fastest and 16 slowest). Larger inputs take a
// grid-stride loop over chunks. A scalar head runs up to the first code
// whose chunk is aligned and a scalar tail takes the rest, so a view at any
// byte offset, of any length, is taken; where the output's chunk is not
// aligned to its vector (a view whose offset is no multiple of four codes)
// the chunk is stored element by element.
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

constexpr int kDqThreads = 256;
constexpr int kDqCodes = 4;            // codes a thread takes: one vector load and store
constexpr int kDqMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs

// four codes loaded as one vector (4 bytes of uint8, 8 of uint16), as f32
__device__ __forceinline__ void load4(const uint8_t* p, float (&c)[4]) {
  const unsigned int w = __ldcs(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = (float)((w >> (8 * i)) & 0xffu);
}
__device__ __forceinline__ void load4(const uint16_t* p, float (&c)[4]) {
  const uint2 w = __ldcs(reinterpret_cast<const uint2*>(p));
  c[0] = (float)(w.x & 0xffffu);
  c[1] = (float)(w.x >> 16);
  c[2] = (float)(w.y & 0xffffu);
  c[3] = (float)(w.y >> 16);
}

// four values stored as one streaming vector (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                 *reinterpret_cast<const uint32_t*>(&hi)));
}

// Codes [0, head) and [head + 4 chunks, n) one a thread, the chunks of four
// between one a thread per grid-stride step. kVecOut: out + head is aligned
// to a vector of four outputs.
template <typename Code, typename Out, bool kVecOut>
__global__ void __launch_bounds__(kDqThreads)
dequantize_vec_kernel(const Code* __restrict__ y, Out* __restrict__ out, long long n,
                      long long head, long long chunks, float mn, float mx, float levels) {
  const float step = dequant_step(mn, mx, levels);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long tail = head + chunks * kDqCodes;
  if (tid < head) store_f32(out, tid, dequant_value((float)y[tid], step, mn));
  if (tid < n - tail) store_f32(out, tail + tid, dequant_value((float)y[tail + tid], step, mn));
  const Code* src = y + head;
  Out* dst = out + head;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = tid; c < chunks; c += stride) {
    float v[kDqCodes];
    load4(src + c * kDqCodes, v);
#pragma unroll
    for (int i = 0; i < kDqCodes; ++i) v[i] = dequant_value(v[i], step, mn);
    if constexpr (kVecOut) {
      store4(dst + c * kDqCodes, v);
    } else {
#pragma unroll
      for (int i = 0; i < kDqCodes; ++i) store_f32(dst, c * kDqCodes + i, v[i]);
    }
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
  constexpr uintptr_t kVecIn = kDqCodes * sizeof(Code);      // bytes of a chunk's codes
  const uintptr_t misaligned = reinterpret_cast<uintptr_t>(y) % kVecIn;
  long long head = misaligned ? (long long)((kVecIn - misaligned) / sizeof(Code)) : 0;
  if (head > n) head = n;
  const long long chunks = (n - head) / kDqCodes;
  long long blocks = (chunks + kDqThreads - 1) / kDqThreads;
  blocks = blocks < 1 ? 1 : (blocks > kDqMaxBlocks ? kDqMaxBlocks : blocks);
  const Code* yc = static_cast<const Code*>(y);
  Out* o = static_cast<Out*>(out);
  if (reinterpret_cast<uintptr_t>(o + head) % (kDqCodes * sizeof(Out)) == 0)
    dequantize_vec_kernel<Code, Out, true><<<(int)blocks, kDqThreads, 0, s>>>(
        yc, o, n, head, chunks, mn, mx, levels);
  else
    dequantize_vec_kernel<Code, Out, false><<<(int)blocks, kDqThreads, 0, s>>>(
        yc, o, n, head, chunks, mn, mx, levels);
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

// out_dtype: 0 = float32, 1 = bfloat16. Codes as in repro_quantize, at any
// address (a view); out as allocated by the caller.
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
