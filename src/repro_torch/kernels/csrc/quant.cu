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
// Both kernels have one shape. Each thread takes four elements with one
// vector load (quantize: 16 bytes of f32 or 8 of bf16; dequantize: 4 bytes
// of uint8 codes or 8 of uint16) and writes them with one vector store
// (quantize: 4 bytes of uint8 codes or 8 of uint16; dequantize: 16 bytes
// of f32 or 8 of bf16), streaming both past L1. At the serving size, 1024 x
// 512 elements (2.62 MB each way), launch, latency and drain set the
// floor, not bytes: its 131 072 chunks run as 512 blocks of 256 threads,
// about four resident an SM, since many short threads keep more loads and
// stores in flight than few long ones (a sweep of 4, 8 and 16 codes a
// thread of dequantize on the H100 found 4 fastest and 16 slowest). Larger
// inputs take a grid-stride loop over chunks. A scalar head runs up to the
// first element whose chunk is aligned and a scalar tail takes the rest,
// so a view at any element offset, of any length, is taken; where the
// output's chunk is not aligned to its vector (a view whose offset is no
// multiple of four elements) the chunk is stored element by element.
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

constexpr int kVecThreads = 256;
constexpr int kVec = 4;              // elements a thread takes: one vector load and store
constexpr int kVecMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Eq. 1 for one value, as a float holding the code
__device__ __forceinline__ float quant_code(float x, float mn, float scale, float levels) {
  const float q = rintf(__fmul_rn(__fsub_rn(x, mn), scale));
  return fminf(fmaxf(q, 0.0f), levels);
}

// four values loaded as one vector (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 w = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 w = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

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

// four codes (whole floats in [0, levels]) stored as one streaming vector
// (4 bytes of uint8, 8 of uint16)
__device__ __forceinline__ void store4(uint8_t* p, const float (&q)[4]) {
  const unsigned int w = (unsigned int)q[0] | ((unsigned int)q[1] << 8) |
                         ((unsigned int)q[2] << 16) | ((unsigned int)q[3] << 24);
  __stcs(reinterpret_cast<unsigned int*>(p), w);
}
__device__ __forceinline__ void store4(uint16_t* p, const float (&q)[4]) {
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2((unsigned int)q[0] | ((unsigned int)q[1] << 16),
                    (unsigned int)q[2] | ((unsigned int)q[3] << 16)));
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

// Elements [0, head) and [head + 4 chunks, n) one a thread, the chunks of
// four between one a thread per grid-stride step. kVecOut: y + head is
// aligned to a vector of four codes.
template <typename In, typename Code, bool kVecOut>
__global__ void __launch_bounds__(kVecThreads)
quantize_vec_kernel(const In* __restrict__ x, Code* __restrict__ y, long long n,
                    long long head, long long chunks, float mn, float mx, float levels) {
  const float scale = __fdiv_rn(levels, fmaxf(__fsub_rn(mx, mn), 1e-12f));
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long tail = head + chunks * kVec;
  if (tid < head) y[tid] = (Code)quant_code(load_f32(x, tid), mn, scale, levels);
  if (tid < n - tail) y[tail + tid] = (Code)quant_code(load_f32(x, tail + tid), mn, scale, levels);
  const In* src = x + head;
  Code* dst = y + head;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = tid; c < chunks; c += stride) {
    float v[kVec];
    load4(src + c * kVec, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = quant_code(v[i], mn, scale, levels);
    if constexpr (kVecOut) {
      store4(dst + c * kVec, v);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) dst[c * kVec + i] = (Code)v[i];
    }
  }
}

// Codes [0, head) and [head + 4 chunks, n) one a thread, the chunks of four
// between one a thread per grid-stride step. kVecOut: out + head is aligned
// to a vector of four outputs.
template <typename Code, typename Out, bool kVecOut>
__global__ void __launch_bounds__(kVecThreads)
dequantize_vec_kernel(const Code* __restrict__ y, Out* __restrict__ out, long long n,
                      long long head, long long chunks, float mn, float mx, float levels) {
  const float step = dequant_step(mn, mx, levels);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long tail = head + chunks * kVec;
  if (tid < head) store_f32(out, tid, dequant_value((float)y[tid], step, mn));
  if (tid < n - tail) store_f32(out, tail + tid, dequant_value((float)y[tail + tid], step, mn));
  const Code* src = y + head;
  Out* dst = out + head;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = tid; c < chunks; c += stride) {
    float v[kVec];
    load4(src + c * kVec, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = dequant_value(v[i], step, mn);
    if constexpr (kVecOut) {
      store4(dst + c * kVec, v);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) store_f32(dst, c * kVec + i, v[i]);
    }
  }
}

// Elements before the first aligned chunk of ``p``: the scalar head.
template <typename T>
long long head_of(const void* p, long long n) {
  constexpr uintptr_t kVecBytes = kVec * sizeof(T);
  const uintptr_t misaligned = reinterpret_cast<uintptr_t>(p) % kVecBytes;
  const long long head = misaligned ? (long long)((kVecBytes - misaligned) / sizeof(T)) : 0;
  return head < n ? head : n;
}

int vec_grid(long long chunks) {
  const long long blocks = (chunks + kVecThreads - 1) / kVecThreads;
  return (int)(blocks < 1 ? 1 : (blocks > kVecMaxBlocks ? kVecMaxBlocks : blocks));
}

template <typename In, typename Code>
void launch_quantize(const void* x, void* y, long long n, float mn, float mx,
                     float levels, cudaStream_t s) {
  const long long head = head_of<In>(x, n);
  const long long chunks = (n - head) / kVec;
  const In* xi = static_cast<const In*>(x);
  Code* yc = static_cast<Code*>(y);
  if (reinterpret_cast<uintptr_t>(yc + head) % (kVec * sizeof(Code)) == 0)
    quantize_vec_kernel<In, Code, true><<<vec_grid(chunks), kVecThreads, 0, s>>>(
        xi, yc, n, head, chunks, mn, mx, levels);
  else
    quantize_vec_kernel<In, Code, false><<<vec_grid(chunks), kVecThreads, 0, s>>>(
        xi, yc, n, head, chunks, mn, mx, levels);
}

template <typename Code, typename Out>
void launch_dequantize(const void* y, void* out, long long n, float mn, float mx,
                       float levels, cudaStream_t s) {
  const long long head = head_of<Code>(y, n);
  const long long chunks = (n - head) / kVec;
  const Code* yc = static_cast<const Code*>(y);
  Out* o = static_cast<Out*>(out);
  if (reinterpret_cast<uintptr_t>(o + head) % (kVec * sizeof(Out)) == 0)
    dequantize_vec_kernel<Code, Out, true><<<vec_grid(chunks), kVecThreads, 0, s>>>(
        yc, o, n, head, chunks, mn, mx, levels);
  else
    dequantize_vec_kernel<Code, Out, false><<<vec_grid(chunks), kVecThreads, 0, s>>>(
        yc, o, n, head, chunks, mn, mx, levels);
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16, at any address (a view). Codes are
// uint8 for bits <= 8, else uint16, as allocated by the caller. n > 0
// elements, contiguous.
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
