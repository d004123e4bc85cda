// K4 and K5: the whole-sequence LSTM recurrence and its reverse-time backward
// sweep for Hopper (sm_90a), float32 or bfloat16.
//
// Replace the JAX package's Pallas kernels ops/pallas_lstm_train.py:
// _fwd_kernel (K4) and _bwd_kernel (K5). With zx (T, B, 4N) time-major (the
// hoisted input projection), R (N, 4N), h0/c0 (B, N) and dt the weight dtype:
//
//   K4, per step t (walked 0..T-1, or T-1..0 when `reverse`):
//     z = zx[t] + r(h.R)                 r(): float32 sum rounded to dt
//     i, f, o = 1/(1+exp(-z)),  g = tanh(z)       every result rounded to dt
//     c = f*c + i*g,  h = o*tanh(c);  hs[t] = h, cs[t] = c;  hT, cT at the end
//   K5, per step in the opposite order, carries dh, dc in float32:
//     recompute z and the gates from zx[t] and hprev[t] exactly as K4, as f32
//     dh = g_hs[t] + dh;  dc = dc + dh*o*(1-tanh(cs[t])^2)
//     dz = [dc*g*i(1-i), dc*cprev[t]*f(1-f), dc*i*(1-g^2), dh*tanh(c)*o(1-o)]
//     dzx[t] = r(dz);  dh = r(dz).R^T (float32);  dc = dc*f;  dh0, dc0 at the end
//
// The input projection and the weight gradient hprev^T.dzx stay outside, as in
// the JAX package. The h.R and dz.R^T products are computed here.
//
// What bounds them on an H100: operations. A sweep does 2*T*B*N*4N of them (K5
// twice that), on 2 MB (bf16) to 4 MB (f32) of recurrent weights that cannot
// stay in one block's 227 KB of shared memory as they stay in the TPU's VMEM.
// What the design does about it: one block owns BT = 4 batch rows for the whole
// sweep, so the carry never leaves shared memory and no block waits on another;
// each step streams R from L2 (where it stays: 64 blocks read the same 2-4 MB)
// with 16- or 32-byte loads, 8 columns per thread, the reduction dimension
// split over the threads that the columns leave idle and summed in a fixed
// order (so a run is reproducible). The loop waits on L2 latency, not on the
// FMA units: 512 threads with 8 loads in flight each measured 1.65x faster
// than 256 threads with 4. K5's second product reads a transposed
// copy of R that the wrapper makes once, which lets it reuse the same routine
// (block_product in scan_common.cuh) with coalesced loads. Plain float32 FMA:
// tensor cores and a grid that shares one copy of R across SMs are later work.

#include "scan_common.cuh"

namespace {

using namespace scan;

constexpr int MAX_N = 1024;    // widest layer whose scratch fits one block

// gate values of one (row, unit) from its four preactivation sums, in dt
template <typename T>
__device__ __forceinline__ void gates(const T* __restrict__ zx_row, const float* __restrict__ z_row,
                                      int N, int u, float& ig, float& fg, float& gg, float& og) {
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    z[g] = rnd<T>(to_f<T>(zx_row[g * N + u]) + rnd<T>(z_row[g * N + u]));
  ig = sig<T>(z[0]);
  fg = sig<T>(z[1]);
  gg = rnd<T>(tanhf(z[2]));
  og = sig<T>(z[3]);
}

template <typename T>
__global__ void __launch_bounds__(NT)
lstm_scan_fwd_kernel(const T* __restrict__ zx, const T* __restrict__ R, const T* __restrict__ h0,
                     const T* __restrict__ c0, T* __restrict__ hs, T* __restrict__ cs,
                     T* __restrict__ hT, T* __restrict__ cT, int Tn, int B, int N, int reverse) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [N][BT]  h, one float4 per unit
  float* c_s = a_s + (size_t)N * BT;              // [BT][N]
  float* z_s = c_s + (size_t)BT * N;              // [BT][4N]
  float* part_s = z_s + (size_t)BT * 4 * N;       // [NT*BT*CG]
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BT;
  const int N4 = 4 * N;
  for (int i = tid; i < BT * N; i += NT) {
    const int r = i / N, u = i % N, row = b0 + r;
    a_s[u * BT + r] = row < B ? to_f<T>(h0[(size_t)row * N + u]) : 0.0f;
    c_s[i] = row < B ? to_f<T>(c0[(size_t)row * N + u]) : 0.0f;
  }
  __syncthreads();
  for (int s = 0; s < Tn; ++s) {
    const int t = reverse ? Tn - 1 - s : s;
    block_product<T>(reinterpret_cast<const float4*>(a_s), R, N, N4, N4, part_s, z_s, N4, false);
    for (int i = tid; i < BT * N; i += NT) {
      const int r = i / N, u = i % N, row = b0 + r;
      if (row >= B) continue;
      const size_t at = (size_t)t * B + row;
      float ig, fg, gg, og;
      gates<T>(zx + at * N4, z_s + (size_t)r * N4, N, u, ig, fg, gg, og);
      const float cn = rnd<T>(rnd<T>(fg * c_s[i]) + rnd<T>(ig * gg));
      const float hn = rnd<T>(og * rnd<T>(tanhf(cn)));
      c_s[i] = cn;
      a_s[u * BT + r] = hn;
      hs[at * N + u] = from_f<T>(hn);
      cs[at * N + u] = from_f<T>(cn);
    }
    __syncthreads();
  }
  for (int i = tid; i < BT * N; i += NT) {
    const int r = i / N, u = i % N, row = b0 + r;
    if (row >= B) continue;
    hT[(size_t)row * N + u] = from_f<T>(a_s[u * BT + r]);
    cT[(size_t)row * N + u] = from_f<T>(c_s[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
lstm_scan_bwd_kernel(const T* __restrict__ g_hs, const T* __restrict__ g_hT,
                     const T* __restrict__ g_cT, const T* __restrict__ zx,
                     const T* __restrict__ R, const T* __restrict__ RT,
                     const T* __restrict__ hprev, const T* __restrict__ cprev,
                     const T* __restrict__ cs, T* __restrict__ dzx, float* __restrict__ dh0,
                     float* __restrict__ dc0, int Tn, int B, int N, int reverse) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [4N][BT]  hprev (N rows), then dz
  float* z_s = a_s + (size_t)4 * N * BT;          // [BT][4N]
  float* dh_s = z_s + (size_t)BT * 4 * N;         // [BT][N]
  float* dc_s = dh_s + (size_t)BT * N;            // [BT][N]
  float* part_s = dc_s + (size_t)BT * N;          // [NT*BT*CG]
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BT;
  const int N4 = 4 * N;
  for (int i = tid; i < BT * N; i += NT) {
    const int r = i / N, u = i % N, row = b0 + r;
    dh_s[i] = row < B ? to_f<T>(g_hT[(size_t)row * N + u]) : 0.0f;
    dc_s[i] = row < B ? to_f<T>(g_cT[(size_t)row * N + u]) : 0.0f;
  }
  for (int s = Tn - 1; s >= 0; --s) {
    const int t = reverse ? Tn - 1 - s : s;
    for (int i = tid; i < BT * N; i += NT) {
      const int r = i / N, u = i % N, row = b0 + r;
      a_s[u * BT + r] = row < B ? to_f<T>(hprev[((size_t)t * B + row) * N + u]) : 0.0f;
    }
    __syncthreads();
    block_product<T>(reinterpret_cast<const float4*>(a_s), R, N, N4, N4, part_s, z_s, N4, false);
    for (int i = tid; i < BT * N; i += NT) {
      const int r = i / N, u = i % N, row = b0 + r;
      float dz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row < B) {
        const size_t at = (size_t)t * B + row;
        float ig, fg, gg, og;
        gates<T>(zx + at * N4, z_s + (size_t)r * N4, N, u, ig, fg, gg, og);
        const float th = tanhf(to_f<T>(cs[at * N + u]));
        const float dh = to_f<T>(g_hs[at * N + u]) + dh_s[i];
        const float dc = dc_s[i] + dh * og * (1.0f - th * th);
        const float d_o = dh * th;
        const float d_i = dc * gg;
        const float d_g = dc * ig;
        const float d_f = dc * to_f<T>(cprev[at * N + u]);
        dz[0] = rnd<T>(d_i * ig * (1.0f - ig));
        dz[1] = rnd<T>(d_f * fg * (1.0f - fg));
        dz[2] = rnd<T>(d_g * (1.0f - gg * gg));
        dz[3] = rnd<T>(d_o * og * (1.0f - og));
        dc_s[i] = dc * fg;
#pragma unroll
        for (int g = 0; g < 4; ++g) dzx[at * N4 + g * N + u] = from_f<T>(dz[g]);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) a_s[(size_t)(g * N + u) * BT + r] = dz[g];
    }
    __syncthreads();
    block_product<T>(reinterpret_cast<const float4*>(a_s), RT, N4, N, N, part_s, dh_s, N, false);
  }
  for (int i = tid; i < BT * N; i += NT) {
    const int r = i / N, u = i % N, row = b0 + r;
    if (row >= B) continue;
    dh0[(size_t)row * N + u] = dh_s[i];
    dc0[(size_t)row * N + u] = dc_s[i];
  }
}

size_t fwd_smem(int N) { return ((size_t)6 * BT * N + (size_t)NT * BT * CG) * sizeof(float); }
size_t bwd_smem(int N) { return ((size_t)10 * BT * N + (size_t)NT * BT * CG) * sizeof(float); }

bool shapes_ok(int Tn, int B, int N) {
  return Tn >= 1 && B >= 1 && N >= CG && N % CG == 0 && N <= MAX_N;
}

template <typename T>
cudaError_t launch_fwd(const void* zx, const void* R, const void* h0, const void* c0, void* hs,
                       void* cs, void* hT, void* cT, int Tn, int B, int N, int reverse,
                       cudaStream_t s) {
  const size_t smem = fwd_smem(N);
  cudaError_t err = cudaFuncSetAttribute(lstm_scan_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lstm_scan_fwd_kernel<T><<<(B + BT - 1) / BT, NT, smem, s>>>(
      (const T*)zx, (const T*)R, (const T*)h0, (const T*)c0, (T*)hs, (T*)cs, (T*)hT, (T*)cT, Tn,
      B, N, reverse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* g_hs, const void* g_hT, const void* g_cT, const void* zx,
                       const void* R, const void* RT, const void* hprev, const void* cprev,
                       const void* cs, void* dzx, void* dh0, void* dc0, int Tn, int B, int N,
                       int reverse, cudaStream_t s) {
  const size_t smem = bwd_smem(N);
  cudaError_t err = cudaFuncSetAttribute(lstm_scan_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lstm_scan_bwd_kernel<T><<<(B + BT - 1) / BT, NT, smem, s>>>(
      (const T*)g_hs, (const T*)g_hT, (const T*)g_cT, (const T*)zx, (const T*)R, (const T*)RT,
      (const T*)hprev, (const T*)cprev, (const T*)cs, (T*)dzx, (float*)dh0, (float*)dc0, Tn, B,
      N, reverse);
  return cudaGetLastError();
}

}  // namespace

// the widest layer the kernels take (their scratch is proportional to N)
extern "C" int lstm_scan_max_width() { return MAX_N; }

// dtype: 0 = float32, 1 = bfloat16. Both return the CUDA error of the launch.
extern "C" int lstm_scan_fwd_launch(int dtype, const void* zx, const void* R, const void* h0,
                                    const void* c0, void* hs, void* cs, void* hT, void* cT,
                                    int Tn, int B, int N, int reverse, void* stream) {
  if (!shapes_ok(Tn, B, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_fwd<float>(zx, R, h0, c0, hs, cs, hT, cT, Tn, B, N, reverse, s);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(zx, R, h0, c0, hs, cs, hT, cT, Tn, B, N, reverse, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lstm_scan_bwd_launch(int dtype, const void* g_hs, const void* g_hT,
                                    const void* g_cT, const void* zx, const void* R,
                                    const void* RT, const void* hprev, const void* cprev,
                                    const void* cs, void* dzx, void* dh0, void* dc0, int Tn,
                                    int B, int N, int reverse, void* stream) {
  if (!shapes_ok(Tn, B, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_bwd<float>(g_hs, g_hT, g_cT, zx, R, RT, hprev, cprev, cs, dzx, dh0, dc0,
                                  Tn, B, N, reverse, s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(g_hs, g_hT, g_cT, zx, R, RT, hprev, cprev, cs, dzx,
                                          dh0, dc0, Tn, B, N, reverse, s);
  return (int)cudaErrorInvalidValue;
}
