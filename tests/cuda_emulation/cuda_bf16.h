// Stand-in for <cuda_bf16.h>: bfloat16 as the upper half of a float32, rounded
// to nearest even, with the conversions the scan kernels use.
#pragma once

#include "cuda_runtime.h"

struct __nv_bfloat16 { uint16_t x; };

inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  if (std::isnan(f)) return {0x7fc0};
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}

struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}
