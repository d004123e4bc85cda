// Shared by the whole-sequence scan kernels (lstm_scan.cu: K4/K5,
// teacher_scan.cu: K6/K7): storage-type conversions with the Pallas kernels'
// rounding points, 8-wide weight loads, and the block-wide product of BT batch
// rows with a weight matrix streamed from global memory (L2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace scan {

constexpr int BT = 4;          // batch rows per block
constexpr int NT = 512;        // threads per block
constexpr int CG = 8;          // weight columns per thread in a product
constexpr int TILE = NT * CG;  // columns per product tile
static_assert(BT == 4, "block_product keeps the BT rows of one k in a float4");

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round to the storage type and back
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// the Pallas kernels' manual logistic, every intermediate in the weight dtype
template <typename T> __device__ __forceinline__ float sig(float v) {
  return rnd<T>(1.0f / rnd<T>(1.0f + rnd<T>(expf(-v))));
}

// eight consecutive values, 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float (&w)[CG]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&w)[CG]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// out_s[r * out_ld + col] (+)= sum_k a_s[k][r] * M[k * ld + col] for r < BT,
// col < ncols (a multiple of CG), with M row-major in global memory (row
// stride ld, so a column slice of a wider matrix works) and a_s one float4
// (the BT rows) per k in shared memory. Threads beyond the column groups take
// ranges of k; part_s (NT*BT*CG floats) holds their partial sums, which are
// added in the order of the ranges. `accumulate` adds to out_s instead of
// overwriting it. Ends with the block synchronised; a_s and out_s are not
// touched before the first barrier inside.
template <typename T>
__device__ __forceinline__ void block_product(const float4* __restrict__ a_s,
                                              const T* __restrict__ M, int K, int ncols, int ld,
                                              float* __restrict__ part_s,
                                              float* __restrict__ out_s, int out_ld,
                                              bool accumulate) {
  const int tid = threadIdx.x;
  for (int col0 = 0; col0 < ncols; col0 += TILE) {
    const int tcols = min(TILE, ncols - col0);
    const int ncg = tcols / CG;
    const int ksplit = NT / ncg;
    const int kper = (K + ksplit - 1) / ksplit;
    const int cg = tid % ncg, ks = tid / ncg;
    if (ks < ksplit) {
      float acc[BT][CG];
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int c = 0; c < CG; ++c) acc[r][c] = 0.0f;
      const int k0 = ks * kper, k1 = min(K, k0 + kper);
      const T* p = M + (size_t)k0 * ld + col0 + cg * CG;
#pragma unroll 8
      for (int k = k0; k < k1; ++k, p += ld) {
        float w[CG];
        load8(p, w);
        const float4 a = a_s[k];
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          acc[0][c] = fmaf(a.x, w[c], acc[0][c]);
          acc[1][c] = fmaf(a.y, w[c], acc[1][c]);
          acc[2][c] = fmaf(a.z, w[c], acc[2][c]);
          acc[3][c] = fmaf(a.w, w[c], acc[3][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        float4* dst = reinterpret_cast<float4*>(part_s + (size_t)(ks * BT + r) * tcols + cg * CG);
        dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
    __syncthreads();
    for (int i = tid; i < BT * tcols; i += NT) {
      const int r = i / tcols, c = i % tcols;
      float s = 0.0f;
      for (int q = 0; q < ksplit; ++q) s += part_s[(size_t)(q * BT + r) * tcols + c];
      float* o = out_s + (size_t)r * out_ld + col0 + c;
      *o = accumulate ? *o + s : s;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace scan
