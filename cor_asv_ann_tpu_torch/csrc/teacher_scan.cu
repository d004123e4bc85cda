// K6: the teacher-forced top decoder layer (local additive attention + LSTM
// cell) over all Td decoder steps in one launch, for Hopper (sm_90a), float32
// or bfloat16. Its reverse-time sweep (K7) is teacher_bwd.cu.
//
// Replaces the JAX package's Pallas kernel ops/pallas_teacher.py: _fwd_kernel.
// With dt the weight dtype, r() a float32 value rounded to dt, zx (Td, B, 4W)
// float32 the hoisted input projection, u (B, T, W), attended (B, T, A), Kc
// (A, 4W) the context half of the cell kernel, R (W, 4W), W_a (W, W), v, b_UW
// (W), b_v a float32 scalar, bias (4W), maskc (4, B, A) per-gate dropout
// multipliers and a the previous alignment, per step t = 0..Td-1:
//
//     wvec = r(h.W_a) + b_UW
//     t0 = sum_i a_i*i + 1 (float32); position i is visible iff |t0 - i| <= ww
//     s_i = r(sum_n tanh(wvec + u_i)_n * v_n) + b_v        (tanh and sums in dt)
//     a = r(softmax over the visible i, float32); aa[t] = a (dense row, 0 elsewhere)
//     ctx = sum_i a_i * attended_i (float32)
//     z = r(zx[t] + sum_g (r(r(ctx)*maskc_g)).Kc_g + h.R) + bias;   zs[t] = z
//     i, f, o = 1/(1+exp(-z)), g = tanh(z), every intermediate in dt
//     c = f*c + i*g,  h = o*tanh(c);  hs[t] = h, cs[t] = c
//
// The hoisted input projection stays outside, as in the JAX package. The
// products h.W_a, ctx.Kc, h.R are computed here.
//
// What bounds it on an H100: operations (2*(W^2 + 4AW + 4W^2) per row and
// step), just above the bytes of the streamed stacks. The TPU kernel keeps a
// batch tile's whole u and attended ((bt, T, W+A)) and all weights (4.5 MB in
// bf16) resident in VMEM and computes the energies densely over T. A Hopper
// block has 227 KB. What this design does about it:
// - the window mask leaves at most 2*ww+1 visible positions per row and step,
//   all others get exp(-1e30 - m) = 0 exactly in float32, so only the visible
//   rows of u and attended are read (bit-identical to the dense form; without
//   a padding mask a row is never all-masked for ww >= 1 because t0 lies in
//   [1, T], so the Pallas body's missing zeroing of such rows is no case
//   here; a row with no visible position would get a zero alignment);
// - one block owns BT = 4 batch rows for the whole sweep, so h, c and the
//   alignment window never leave shared memory and no block waits on another;
//   the weights stream from L2 every step through block_product
//   (scan_common.cuh).
// Plain float32 FMA; tensor cores, TMA and a grid that shares one copy of the
// weights across SMs are later work.

#include "scan_common.cuh"

#include <math.h>

namespace {

using namespace scan;

constexpr int NW = NT / 32;  // warps per block

__host__ __device__ inline int window_max(int ww) { return 2 * ww + 1; }

// shared memory of the kernel in floats (the two ints per row included)
size_t fwd_smem(int W, int A, int ww) {
  return ((size_t)BT * (7 * W + 2 * A) + (size_t)NT * BT * CG + (size_t)BT * (2 * window_max(ww) + 2)) *
         sizeof(float);
}

// wv_s <- r(h.W_a) + b_UW from the product's float32 sums, in place
template <typename T>
__device__ __forceinline__ void finish_wvec(float* wv_s, const T* __restrict__ bUW, int W) {
  for (int i = threadIdx.x; i < BT * W; i += NT)
    wv_s[i] = rnd<T>(rnd<T>(wv_s[i]) + to_f<T>(bUW[i % W]));
}

// sum_n tanh(wvec + u_row)_n * w_n over one row of u for one warp, with the
// tanh argument and result rounded to dt; every lane gets the sum
template <typename T>
__device__ __forceinline__ float warp_energy(const float* wv_row, const T* __restrict__ u_row,
                                             const T* __restrict__ v, int W, int lane) {
  float acc = 0.0f;
  for (int g = lane; g < W / CG; g += 32) {
    float uu[CG], vv[CG];
    load8(u_row + g * CG, uu);
    load8(v + g * CG, vv);
#pragma unroll
    for (int c = 0; c < CG; ++c)
      acc = fmaf(rnd<T>(tanhf(rnd<T>(wv_row[g * CG + c] + uu[c]))), vv[c], acc);
  }
  return warp_sum(acc);
}

template <typename T>
__global__ void __launch_bounds__(NT)
teacher_fwd_kernel(const float* __restrict__ zx, const T* __restrict__ u,
                   const T* __restrict__ att, const T* __restrict__ Kc, const T* __restrict__ R,
                   const T* __restrict__ Wa, const T* __restrict__ v, const T* __restrict__ bUW,
                   const float* __restrict__ b_v, const T* __restrict__ bias,
                   const T* __restrict__ maskc, const T* __restrict__ h0,
                   const T* __restrict__ c0, T* __restrict__ hs, T* __restrict__ cs,
                   T* __restrict__ aa, T* __restrict__ zs, int Td, int B, int Tn, int W, int A,
                   int ww) {
  extern __shared__ float4 smem4[];
  const int WM = window_max(ww);
  float* h_s = reinterpret_cast<float*>(smem4);  // [W][BT]  h, one float4 per unit
  float* c_s = h_s + (size_t)W * BT;              // [BT][W]
  float* wv_s = c_s + (size_t)BT * W;             // [BT][W]  wvec
  float* ctx_s = wv_s + (size_t)BT * W;           // [BT][A]  r(ctx)
  float* cg_s = ctx_s + (size_t)BT * A;           // [A][BT]  one gate's masked ctx
  float* z_s = cg_s + (size_t)A * BT;             // [BT][4W]
  float* part_s = z_s + (size_t)BT * 4 * W;       // [NT*BT*CG]
  float* aw_s = part_s + (size_t)NT * BT * CG;    // [BT][WM]  alignment window
  float* sw_s = aw_s + BT * WM;                   // [BT][WM]  energies
  int* lo_s = reinterpret_cast<int*>(sw_s + BT * WM);  // [BT]  first visible position
  int* cnt_s = lo_s + BT;                              // [BT]  visible positions
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * BT;
  const int W4 = 4 * W;
  const float b_vr = rnd<T>(*b_v);
  for (int i = tid; i < BT * W; i += NT) {
    const int r = i / W, n = i % W, row = b0 + r;
    h_s[n * BT + r] = row < B ? to_f<T>(h0[(size_t)row * W + n]) : 0.0f;
    c_s[i] = row < B ? to_f<T>(c0[(size_t)row * W + n]) : 0.0f;
  }
  if (tid < BT) lo_s[tid] = cnt_s[tid] = 0;
  __syncthreads();
  for (int t = 0; t < Td; ++t) {
    block_product<T>(reinterpret_cast<const float4*>(h_s), Wa, W, W, W, part_s, wv_s, W, false);
    finish_wvec<T>(wv_s, bUW, W);
    if (tid < BT) {
      // the window around t0, from the alignment of the step before (none at
      // t = 0: t0 = 1); t0 - i is exact in float32, so this is the dense
      // form's own test |t0 - i| <= ww on the candidates around floor(t0)
      const int r = tid;
      float t0 = 0.0f;
      for (int j = 0; j < cnt_s[r]; ++j) t0 = fmaf(aw_s[r * WM + j], (float)(lo_s[r] + j), t0);
      t0 += 1.0f;
      const int c = (int)floorf(t0);
      int lo = 0, cnt = 0;
      if (b0 + r < B)
        for (int i = max(0, c - ww - 1); i <= min(Tn - 1, c + ww + 1); ++i)
          if (fabsf(t0 - (float)i) <= (float)ww && cnt < WM) {
            if (cnt == 0) lo = i;
            ++cnt;
          }
      lo_s[r] = lo;
      cnt_s[r] = cnt;
    }
    __syncthreads();
    for (int p = warp; p < BT * WM; p += NW) {
      const int r = p / WM, j = p % WM;
      if (j >= cnt_s[r]) continue;
      const size_t at = (size_t)(b0 + r) * Tn + lo_s[r] + j;
      const float s = warp_energy<T>(wv_s + (size_t)r * W, u + at * W, v, W, lane);
      if (lane == 0) sw_s[p] = rnd<T>(rnd<T>(s) + b_vr);
    }
    __syncthreads();
    if (tid < BT) {
      const int r = tid, cnt = cnt_s[r];
      float m = -INFINITY, sum = 0.0f;
      for (int j = 0; j < cnt; ++j) m = fmaxf(m, sw_s[r * WM + j]);
      for (int j = 0; j < cnt; ++j) {
        const float p = expf(sw_s[r * WM + j] - m);
        aw_s[r * WM + j] = p;
        sum += p;
      }
      for (int j = 0; j < cnt; ++j) aw_s[r * WM + j] = rnd<T>(aw_s[r * WM + j] / sum);
    }
    __syncthreads();
    for (int i = tid; i < BT * Tn; i += NT) {
      const int r = i / Tn, p = i % Tn, row = b0 + r;
      if (row >= B) continue;
      const int j = p - lo_s[r];
      const float a = (j >= 0 && j < cnt_s[r]) ? aw_s[r * WM + j] : 0.0f;
      aa[((size_t)t * B + row) * Tn + p] = from_f<T>(a);
    }
    for (int i = tid; i < BT * A; i += NT) {
      const int r = i / A, k = i % A;
      const T* col = att + ((size_t)(b0 + r) * Tn + lo_s[r]) * A + k;
      float acc = 0.0f;
      for (int j = 0; j < cnt_s[r]; ++j) acc = fmaf(aw_s[r * WM + j], to_f<T>(col[(size_t)j * A]), acc);
      ctx_s[i] = rnd<T>(acc);
    }
    __syncthreads();
    for (int g = 0; g < 4; ++g) {
      for (int i = tid; i < BT * A; i += NT) {
        const int r = i / A, k = i % A, row = b0 + r;
        cg_s[k * BT + r] =
            row < B ? rnd<T>(ctx_s[i] * to_f<T>(maskc[((size_t)g * B + row) * A + k])) : 0.0f;
      }
      __syncthreads();
      block_product<T>(reinterpret_cast<const float4*>(cg_s), Kc + g * W, A, W, W4, part_s,
                       z_s + g * W, W4, false);
    }
    block_product<T>(reinterpret_cast<const float4*>(h_s), R, W, W4, W4, part_s, z_s, W4, true);
    for (int i = tid; i < BT * W; i += NT) {
      const int r = i / W, n = i % W, row = b0 + r;
      if (row >= B) continue;
      const size_t at = (size_t)t * B + row;
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        z[g] = rnd<T>(rnd<T>(zx[at * W4 + g * W + n] + z_s[(size_t)r * W4 + g * W + n]) +
                      to_f<T>(bias[g * W + n]));
        zs[at * W4 + g * W + n] = from_f<T>(z[g]);
      }
      const float ig = sig<T>(z[0]), fg = sig<T>(z[1]), gg = rnd<T>(tanhf(z[2])), og = sig<T>(z[3]);
      const float cn = rnd<T>(rnd<T>(fg * c_s[i]) + rnd<T>(ig * gg));
      const float hn = rnd<T>(og * rnd<T>(tanhf(cn)));
      c_s[i] = cn;
      h_s[n * BT + r] = hn;
      hs[at * W + n] = from_f<T>(hn);
      cs[at * W + n] = from_f<T>(cn);
    }
    __syncthreads();
  }
}

int max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

bool shapes_ok(int Td, int B, int Tn, int W, int A, int ww) {
  return Td >= 1 && B >= 1 && Tn >= 1 && ww >= 1 && W >= CG && W % CG == 0 && A >= CG &&
         A % CG == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* const* p, int Td, int B, int Tn, int W, int A, int ww,
                       cudaStream_t s) {
  const size_t smem = fwd_smem(W, A, ww);
  cudaError_t err = cudaFuncSetAttribute(teacher_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  teacher_fwd_kernel<T><<<(B + BT - 1) / BT, NT, smem, s>>>(
      (const float*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3], (const T*)p[4],
      (const T*)p[5], (const T*)p[6], (const T*)p[7], (const float*)p[8], (const T*)p[9],
      (const T*)p[10], (const T*)p[11], (const T*)p[12], (T*)p[13], (T*)p[14], (T*)p[15],
      (T*)p[16], Td, B, Tn, W, A, ww);
  return cudaGetLastError();
}

}  // namespace

extern "C" int teacher_bwd_supported(int W, int A, int ww);  // teacher_bwd.cu

// 1 if K6 and K7 take these widths and this window on the current device
// (multiples of 8, ww >= 1, K6's scratch within a block's shared memory, which
// sets the upper limit), else 0
extern "C" int teacher_scan_supported(int W, int A, int ww) {
  if (!shapes_ok(1, 1, 1, W, A, ww)) return 0;
  return fwd_smem(W, A, ww) <= (size_t)max_smem() && teacher_bwd_supported(W, A, ww);
}

// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error of the launch.
// K6. Inputs: zx (float32), u, att, Kc, R, Wa, v, bUW, b_v (float32), bias,
// maskc, h0, c0; outputs: hs, cs, aa, zs.
extern "C" int teacher_fwd_launch(int dtype, const void* zx, const void* u, const void* att,
                                  const void* Kc, const void* R, const void* Wa, const void* v,
                                  const void* bUW, const void* b_v, const void* bias,
                                  const void* maskc, const void* h0, const void* c0, void* hs,
                                  void* cs, void* aa, void* zs, int Td, int B, int Tn, int W,
                                  int A, int ww, void* stream) {
  if (!shapes_ok(Td, B, Tn, W, A, ww)) return (int)cudaErrorInvalidValue;
  const void* p[17] = {zx, u, att, Kc, R, Wa, v, bUW, b_v, bias, maskc, h0, c0, hs, cs, aa, zs};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_fwd<float>(p, Td, B, Tn, W, A, ww, s);
  if (dtype == 1) return (int)launch_fwd<__nv_bfloat16>(p, Td, B, Tn, W, A, ww, s);
  return (int)cudaErrorInvalidValue;
}
