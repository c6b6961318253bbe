// Eq. 2 dequantization as device functions, shared by quant.cu's
// dequantize kernel and flat_trunk.cu's in-block weight dequantization.
//
// Every step is an explicitly rounded intrinsic, so nvcc cannot contract
// code * step + mn into an FMA: the result is bit-equal to the plain
// PyTorch twins, which round after the multiply and after the add.
#pragma once

#include <cuda_runtime.h>

// (mx - mn) / levels, each step rounded to float32
__device__ __forceinline__ float dequant_step(float mn, float mx, float levels) {
  return __fdiv_rn(__fsub_rn(mx, mn), levels);
}

// code * step + mn with two roundings
__device__ __forceinline__ float dequant_value(float code, float step, float mn) {
  return __fadd_rn(__fmul_rn(code, step), mn);
}
