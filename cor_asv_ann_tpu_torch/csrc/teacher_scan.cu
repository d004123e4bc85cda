// K6 and K7: the teacher-forced top decoder layer (local additive attention +
// LSTM cell) over all Td decoder steps in one launch, and its reverse-time
// backward sweep, for Hopper (sm_90a), float32 or bfloat16.
//
// Replace the JAX package's Pallas kernels ops/pallas_teacher.py: _fwd_kernel
// (K6) and _b1_kernel (K7). With dt the weight dtype, r() a float32 value
// rounded to dt, zx (Td, B, 4W) float32 the hoisted input projection, u
// (B, T, W), attended (B, T, A), Kc (A, 4W) the context half of the cell
// kernel, R (W, 4W), W_a (W, W), v, b_UW (W), b_v a float32 scalar, bias (4W),
// maskc (4, B, A) per-gate dropout multipliers and a the previous alignment:
//
//   K6, per step t = 0..Td-1:
//     wvec = r(h.W_a) + b_UW
//     t0 = sum_i a_i*i + 1 (float32); position i is visible iff |t0 - i| <= ww
//     s_i = r(sum_n tanh(wvec + u_i)_n * v_n) + b_v        (tanh and sums in dt)
//     a = r(softmax over the visible i, float32); aa[t] = a (dense row, 0 elsewhere)
//     ctx = sum_i a_i * attended_i (float32)
//     z = r(zx[t] + sum_g (r(r(ctx)*maskc_g)).Kc_g + h.R) + bias;   zs[t] = z
//     i, f, o = 1/(1+exp(-z)), g = tanh(z), every intermediate in dt
//     c = f*c + i*g,  h = o*tanh(c);  hs[t] = h, cs[t] = c
//   K7, per step t = Td-1..0, carries dh, dc in float32:
//     gates from zs[t]; wvec recomputed from hprev[t] as in K6
//     dh = g[t] + dh;  dc = dc + dh*o*(1-tanh(cs[t])^2)
//     dz = r([dc*g*i(1-i), dc*cprev[t]*f(1-f), dc*i*(1-g^2), dh*tanh(c)*o(1-o)])
//     dctx = sum_g maskc_g * (dz_g.Kc_g^T);  dh' = dz.R^T;  dc = dc*f
//     da_i = attended_i.dctx;  ds = r(a*(da - sum a*da))       (a = aa[t])
//     e_i = tanh(wvec + u_i);  dva += sum_i e_i*ds_i
//     dpre_i = ds_i*v*(1-e_i^2);  dwvec = r(sum_i dpre_i);  du_i += dpre_i
//     datt_i += a_i*dctx;  dh = dh' + dwvec.W_a^T
//   and emits dz, ds, dctx, dwvec per step (dt), dh0, dc0, the per-row dva
//   partials (B, W), du (B, T, W) and datt (B, T, A) in float32.
//
// The hoisted input projection and every weight gradient stay outside, as in
// the JAX package. The products h.W_a, ctx.Kc, h.R (K6) and h.W_a, dz.Kc^T,
// dz.R^T, dwvec.W_a^T (K7) are computed here.
//
// What bounds them on an H100: operations (2*(W^2 + 4AW + 4W^2) per row and
// step in K6, 2*(2W^2 + 4AW + 4W^2) in K7), just above the bytes of the
// streamed stacks. The TPU kernels keep a batch tile's whole u and attended
// ((bt, T, W+A)) and all weights (4.5 MB in bf16) resident in VMEM and compute
// the energies densely over T. A Hopper block has 227 KB. What this design does
// about it:
// - the window mask leaves at most 2*ww+1 visible positions per row and step,
//   all others get exp(-1e30 - m) = 0 exactly in float32, so only the visible
//   rows of u and attended are read (bit-identical to the dense form; without
//   a padding mask a row is never all-masked for ww >= 1 because t0 lies in
//   [1, T], so the Pallas body's missing zeroing of such rows is no case
//   here; a row with no visible position would get a zero alignment);
// - one block owns BT = 4 batch rows for the whole sweep, so h, c, the
//   alignment window and the float32 (dh, dc) carry never leave shared memory
//   and no block waits on another; the weights stream from L2 every step
//   through block_product (scan_common.cuh), K7's transposed products on
//   transposed copies the wrapper makes once;
// - du and datt are float32 tensors in global memory, zeroed by the wrapper: a
//   row is owned by one block, and within it every (row, column) by one
//   thread, for the whole sweep, so plain read-modify-write of the visible
//   rows is race-free and the result deterministic (no atomics);
// - dva stays per-row partials, summed over the batch outside in a fixed order.
// K7 finds a step's window from the saved alignment row aa[t] (its first
// non-zero entry and the 2*ww+1 positions from there): where a is 0 every term
// of the backward is 0. Plain float32 FMA; tensor cores, TMA and a grid that
// shares one copy of the weights across SMs are later work.

#include "scan_common.cuh"

#include <limits.h>
#include <math.h>

namespace {

using namespace scan;

constexpr int NW = NT / 32;  // warps per block

__host__ __device__ inline int window_max(int ww) { return 2 * ww + 1; }

// shared memory of the two kernels in floats (the two ints per row included)
size_t fwd_smem(int W, int A, int ww) {
  return ((size_t)BT * (7 * W + 2 * A) + (size_t)NT * BT * CG + (size_t)BT * (2 * window_max(ww) + 2)) *
         sizeof(float);
}
size_t bwd_smem(int W, int A, int ww) {
  return ((size_t)BT * (10 * W + 2 * A) + (size_t)NT * BT * CG + (size_t)BT * (3 * window_max(ww) + 2)) *
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

template <typename T>
__global__ void __launch_bounds__(NT)
teacher_bwd_kernel(const T* __restrict__ zs, const T* __restrict__ g_hs,
                   const T* __restrict__ hprev, const T* __restrict__ cprev,
                   const T* __restrict__ cs, const T* __restrict__ aa, const T* __restrict__ u,
                   const T* __restrict__ att, const T* __restrict__ KcT,
                   const T* __restrict__ RT, const T* __restrict__ Wa, const T* __restrict__ WaT,
                   const T* __restrict__ v, const T* __restrict__ bUW,
                   const T* __restrict__ maskc, T* __restrict__ dz_out, T* __restrict__ ds_out,
                   T* __restrict__ dctx_out, T* __restrict__ dwvec_out, float* __restrict__ dh0,
                   float* __restrict__ dc0, float* __restrict__ dva, float* du, float* datt,
                   int Td, int B, int Tn, int W, int A, int ww) {
  extern __shared__ float4 smem4[];
  const int WM = window_max(ww);
  float* a_s = reinterpret_cast<float*>(smem4);  // [W][BT]   hprev
  float* dzT_s = a_s + (size_t)W * BT;            // [4W][BT]  r(dz)
  float* dwT_s = dzT_s + (size_t)4 * W * BT;      // [W][BT]   r(dwvec)
  float* wv_s = dwT_s + (size_t)W * BT;           // [BT][W]   wvec
  float* dh_s = wv_s + (size_t)BT * W;            // [BT][W]
  float* dc_s = dh_s + (size_t)BT * W;            // [BT][W]
  float* dva_s = dc_s + (size_t)BT * W;           // [BT][W]
  float* dctx_s = dva_s + (size_t)BT * W;         // [BT][A]
  float* tmp_s = dctx_s + (size_t)BT * A;         // [BT][A]   one gate's dz_g.Kc_g^T
  float* part_s = tmp_s + (size_t)BT * A;         // [NT*BT*CG]
  float* aw_s = part_s + (size_t)NT * BT * CG;    // [BT][WM]  a over the window
  float* da_s = aw_s + BT * WM;                   // [BT][WM]
  float* ds_s = da_s + BT * WM;                   // [BT][WM]  r(ds)
  int* lo_s = reinterpret_cast<int*>(ds_s + BT * WM);
  int* cnt_s = lo_s + BT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * BT;
  const int W4 = 4 * W;
  for (int i = tid; i < BT * W; i += NT) dh_s[i] = dc_s[i] = dva_s[i] = 0.0f;
  for (int t = Td - 1; t >= 0; --t) {
    for (int i = tid; i < BT * W; i += NT) {
      const int r = i / W, n = i % W, row = b0 + r;
      a_s[n * BT + r] = row < B ? to_f<T>(hprev[((size_t)t * B + row) * W + n]) : 0.0f;
    }
    __syncthreads();
    block_product<T>(reinterpret_cast<const float4*>(a_s), Wa, W, W, W, part_s, wv_s, W, false);
    finish_wvec<T>(wv_s, bUW, W);
    if (warp < BT) {
      // this step's window: from the first non-zero entry of aa[t]
      const int r = warp, row = b0 + r;
      const T* arow = aa + ((size_t)t * B + min(row, B - 1)) * Tn;
      int first = INT_MAX;
      if (row < B)
        for (int p = lane; p < Tn; p += 32)
          if (to_f<T>(arow[p]) != 0.0f) {
            first = p;
            break;
          }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
      const int cnt = first == INT_MAX ? 0 : min(WM, Tn - first);
      if (first == INT_MAX) first = 0;
      for (int j = lane; j < cnt; j += 32) aw_s[r * WM + j] = to_f<T>(arow[first + j]);
      if (lane == 0) {
        lo_s[r] = first;
        cnt_s[r] = cnt;
      }
    }
    // LSTM cell backward from the saved preactivations
    for (int i = tid; i < BT * W; i += NT) {
      const int r = i / W, n = i % W, row = b0 + r;
      float dz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row < B) {
        const size_t at = (size_t)t * B + row;
        const T* z = zs + at * W4 + n;
        const float ig = sig<T>(to_f<T>(z[0])), fg = sig<T>(to_f<T>(z[W]));
        const float gg = rnd<T>(tanhf(to_f<T>(z[2 * W]))), og = sig<T>(to_f<T>(z[3 * W]));
        const float th = tanhf(to_f<T>(cs[at * W + n]));
        const float dh = to_f<T>(g_hs[at * W + n]) + dh_s[i];
        const float dc = dc_s[i] + dh * og * (1.0f - th * th);
        const float d_o = dh * th, d_i = dc * gg, d_g = dc * ig;
        const float d_f = dc * to_f<T>(cprev[at * W + n]);
        dz[0] = rnd<T>(d_i * ig * (1.0f - ig));
        dz[1] = rnd<T>(d_f * fg * (1.0f - fg));
        dz[2] = rnd<T>(d_g * (1.0f - gg * gg));
        dz[3] = rnd<T>(d_o * og * (1.0f - og));
        dc_s[i] = dc * fg;
#pragma unroll
        for (int g = 0; g < 4; ++g) dz_out[at * W4 + g * W + n] = from_f<T>(dz[g]);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) dzT_s[(size_t)(g * W + n) * BT + r] = dz[g];
    }
    __syncthreads();
    // dctx = sum_g maskc_g * (dz_g . Kc_g^T), float32
    for (int g = 0; g < 4; ++g) {
      block_product<T>(reinterpret_cast<const float4*>(dzT_s) + (size_t)g * W,
                       KcT + (size_t)g * W * A, W, A, A, part_s, tmp_s, A, false);
      for (int i = tid; i < BT * A; i += NT) {
        const int r = i / A, k = i % A, row = b0 + r;
        const float m = row < B ? to_f<T>(maskc[((size_t)g * B + row) * A + k]) : 0.0f;
        const float d = (g == 0 ? 0.0f : dctx_s[i]) + m * tmp_s[i];
        dctx_s[i] = d;
        if (g == 3 && row < B) dctx_out[((size_t)t * B + row) * A + k] = from_f<T>(d);
      }
    }
    // dh' = dz . R^T (its first barrier also orders the writes of dctx_s)
    block_product<T>(reinterpret_cast<const float4*>(dzT_s), RT, W4, W, W, part_s, dh_s, W, false);
    // attention backward over the window
    for (int p = warp; p < BT * WM; p += NW) {
      const int r = p / WM, j = p % WM;
      if (j >= cnt_s[r]) continue;
      const T* arow = att + ((size_t)(b0 + r) * Tn + lo_s[r] + j) * A;
      float acc = 0.0f;
      for (int g = lane; g < A / CG; g += 32) {
        float x[CG];
        load8(arow + g * CG, x);
#pragma unroll
        for (int c = 0; c < CG; ++c) acc = fmaf(x[c], dctx_s[(size_t)r * A + g * CG + c], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) da_s[p] = acc;
    }
    __syncthreads();
    if (tid < BT) {
      const int r = tid, cnt = cnt_s[r];
      float dot = 0.0f;
      for (int j = 0; j < cnt; ++j) dot = fmaf(aw_s[r * WM + j], da_s[r * WM + j], dot);
      for (int j = 0; j < cnt; ++j)
        ds_s[r * WM + j] = rnd<T>(aw_s[r * WM + j] * (da_s[r * WM + j] - dot));
    }
    __syncthreads();
    for (int i = tid; i < BT * Tn; i += NT) {
      const int r = i / Tn, p = i % Tn, row = b0 + r;
      if (row >= B) continue;
      const int j = p - lo_s[r];
      const float d = (j >= 0 && j < cnt_s[r]) ? ds_s[r * WM + j] : 0.0f;
      ds_out[((size_t)t * B + row) * Tn + p] = from_f<T>(d);
    }
    for (int i = tid; i < BT * W; i += NT) {
      const int r = i / W, n = i % W, row = b0 + r;
      float dw = 0.0f;
      if (row < B) {
        const float wv = wv_s[i], vn = to_f<T>(v[n]);
        float acc = dva_s[i];
        size_t at = ((size_t)row * Tn + lo_s[r]) * W + n;
        for (int j = 0; j < cnt_s[r]; ++j, at += W) {
          const float e = rnd<T>(tanhf(rnd<T>(wv + to_f<T>(u[at]))));
          const float d = ds_s[r * WM + j];
          acc = fmaf(e, d, acc);
          const float dpre = d * vn * (1.0f - e * e);
          dw += dpre;
          du[at] += dpre;
        }
        dva_s[i] = acc;
        dw = rnd<T>(dw);
        dwvec_out[((size_t)t * B + row) * W + n] = from_f<T>(dw);
      }
      dwT_s[n * BT + r] = dw;
    }
    for (int i = tid; i < BT * A; i += NT) {
      const int r = i / A, k = i % A, row = b0 + r;
      if (row >= B) continue;
      const float d = dctx_s[i];
      size_t at = ((size_t)row * Tn + lo_s[r]) * A + k;
      for (int j = 0; j < cnt_s[r]; ++j, at += A) datt[at] += aw_s[r * WM + j] * d;
    }
    __syncthreads();
    // dh = dh' + r(dwvec) . W_a^T
    block_product<T>(reinterpret_cast<const float4*>(dwT_s), WaT, W, W, W, part_s, dh_s, W, true);
  }
  for (int i = tid; i < BT * W; i += NT) {
    const int r = i / W, n = i % W, row = b0 + r;
    if (row >= B) continue;
    dh0[(size_t)row * W + n] = dh_s[i];
    dc0[(size_t)row * W + n] = dc_s[i];
    dva[(size_t)row * W + n] = dva_s[i];
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

template <typename T>
cudaError_t launch_bwd(const void* const* p, int Td, int B, int Tn, int W, int A, int ww,
                       cudaStream_t s) {
  const size_t smem = bwd_smem(W, A, ww);
  cudaError_t err = cudaFuncSetAttribute(teacher_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  teacher_bwd_kernel<T><<<(B + BT - 1) / BT, NT, smem, s>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3], (const T*)p[4],
      (const T*)p[5], (const T*)p[6], (const T*)p[7], (const T*)p[8], (const T*)p[9],
      (const T*)p[10], (const T*)p[11], (const T*)p[12], (const T*)p[13], (const T*)p[14],
      (T*)p[15], (T*)p[16], (T*)p[17], (T*)p[18], (float*)p[19], (float*)p[20], (float*)p[21],
      (float*)p[22], (float*)p[23], Td, B, Tn, W, A, ww);
  return cudaGetLastError();
}

}  // namespace

// 1 if the kernels take these widths and this window on the current device
// (multiples of 8, ww >= 1, scratch within a block's shared memory), else 0
extern "C" int teacher_scan_supported(int W, int A, int ww) {
  if (!shapes_ok(1, 1, 1, W, A, ww)) return 0;
  return bwd_smem(W, A, ww) <= (size_t)max_smem() && fwd_smem(W, A, ww) <= (size_t)max_smem();
}

// dtype: 0 = float32, 1 = bfloat16. Both return the CUDA error of the launch.
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

// K7. Inputs: zs, g, hprev, cprev, cs, aa, u, att, KcT (4W, A), RT (4W, W),
// Wa, WaT, v, bUW, maskc; outputs: dz, ds, dctx, dwvec (dt), dh0, dc0, dva,
// du, datt (float32; du and datt zeroed by the caller).
extern "C" int teacher_bwd_launch(int dtype, const void* zs, const void* g, const void* hprev,
                                  const void* cprev, const void* cs, const void* aa,
                                  const void* u, const void* att, const void* KcT,
                                  const void* RT, const void* Wa, const void* WaT,
                                  const void* v, const void* bUW, const void* maskc, void* dz,
                                  void* ds, void* dctx, void* dwvec, void* dh0, void* dc0,
                                  void* dva, void* du, void* datt, int Td, int B, int Tn, int W,
                                  int A, int ww, void* stream) {
  if (!shapes_ok(Td, B, Tn, W, A, ww)) return (int)cudaErrorInvalidValue;
  const void* p[24] = {zs, g,  hprev, cprev, cs, aa,    u,   att, KcT, RT, Wa,  WaT,
                       v,  bUW, maskc, dz,    ds, dctx, dwvec, dh0, dc0, dva, du, datt};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_bwd<float>(p, Td, B, Tn, W, A, ww, s);
  if (dtype == 1) return (int)launch_bwd<__nv_bfloat16>(p, Td, B, Tn, W, A, ww, s);
  return (int)cudaErrorInvalidValue;
}
