// Device helpers for f32-grade products on Hopper's TF32 tensor cores
// (3xTF32), shared by the kernels that use them: cp.async copies into
// shared memory, the explicit TF32 rounding and hi / lo split, the
// mma.sync.m16n8k8 TF32 product and an ldmatrix load of A fragments.
//
// 3xTF32: each f32 operand a is split into a TF32 high part hi = rna(a) and
// a TF32 low part lo = rna(a - hi), and a b accumulates lo.hi + hi.lo +
// hi.hi in f32; the dropped lo.lo term and lo's rounding are near 2^-21 of
// a product, close to f32's own rounding. Hopper's TF32 path ignores an
// operand's low 13 bits, so both roundings are explicit. bf16 values are
// exact in TF32 and need no split.
//
// Fragments (PTX m16n8k8 .tf32), with g = lane / 4 and t = lane % 4: A
// element r is row g + 8 (r & 1), column t + 4 (r >> 1); B element r is
// row t + 4 r, column g; C element r is row g + 8 (r >> 1), column
// 2 t + (r & 1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// four elements, global to shared (16 bytes of f32, 8 of bf16); valid false
// fills zeros and reads nothing
template <typename In>
__device__ __forceinline__ void cp_async_chunk(In* smem, const In* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int src_bytes = valid ? 4 * (int)sizeof(In) : 0;
  if constexpr (sizeof(In) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes) : "memory");
}

// one f32, global to shared; valid false fills a zero
__device__ __forceinline__ void cp_async_f32(float* smem, const float* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: half a TF32 unit added to the magnitude's bits, the low 13 cleared
// (a carry into the exponent is the correct rounding up); cvt.rna.tf32.f32's
// bits for every finite v, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32 (low 13 bits zero); a - hi is exact in f32
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(__fsub_rn(a, __uint_as_float(hi)));
}

// v as TF32 hi, and lo when kSplit (a bf16 value is exact in TF32: hi is
// v itself and lo is 0)
template <bool kSplit>
__device__ __forceinline__ void to_tf32(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (kSplit)
    split_tf32(v, hi, lo);
  else
    hi = __float_as_uint(v), lo = 0u;
}

// d += a b for one m16n8k8 TF32 tile, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 4 f32 blocks of a row-major tile with one ldmatrix.x4: read as
// b16 pairs, lane i of block j gets the f32 at row i / 4, column i % 4,
// which is the m16n8k8 A fragment's layout. Lane l gives the address of
// row l % 8 of block l / 8; rows start on 16-byte boundaries.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
