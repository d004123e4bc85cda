// K6: the teacher-forced top decoder layer (local additive attention + LSTM
// cell) over all Td decoder steps, for Hopper (sm_90a), float32 or bfloat16.
// Its reverse-time sweep (K7) is teacher_bwd.cu.
//
// Replaces the JAX package's Pallas kernel ops/pallas_teacher.py: _fwd_kernel.
// With dt the weight dtype, r() a float32 value rounded to dt, zx (Td, B, 4W)
// float32 the hoisted input projection, u (B, T, W), attended (B, T, A), Kc
// (A, 4W) the context half of the cell kernel, R (W, 4W), W_a (W, W), v, b_UW
// (W), b_v a float32 scalar, bias (4W), maskc (4, B, A) per-gate dropout
// multipliers and a the previous alignment, per step t = 0..Td-1:
//
//     wvec = r(r(h.W_a) + b_UW)
//     t0 = sum_i a_i*i + 1 (float32); position i is visible iff |t0 - i| <= ww
//       and, under a padding mask, its byte is 1
//     s_i = r(r(sum_n r(tanh(r(wvec + u_i)))_n * v_n) + b_v)
//     a = r(softmax over the visible i, float32); aa[t] = a (dense row, 0 elsewhere;
//       a row with no visible position gets a = 0, so ctx = 0 and the next t0 = 1)
//     ctx = r(sum_i a_i * attended_i);  cg_g = r(ctx * maskc_g)
//     z = r(r(zx[t] + sum_g cg_g.Kc_g + h.R) + bias);   zs[t] = z
//     i, f, o = 1/(1+exp(-z)), g = tanh(z), every intermediate in dt
//     c = f*c + i*g,  h = o*tanh(c);  hs[t] = h, cs[t] = c
//
// The hoisted input projection stays outside, as in the JAX package. The
// products h.W_a, cg.Kc, h.R are computed here.
//
// What bounds it on an H100: operations (2*(W^2 + 4AW + 4W^2) per row and
// step: 0.16 ms in bf16 at B=256, Td=T=128, W=A=512; 2.3 ms in float32 on
// the FMA pipe). The TPU kernel keeps a batch tile's u and attended and all
// weights (4.5 MB in bf16) resident in VMEM; a Hopper block has 227 KB. Step t
// depends on step t-1 through h and through the alignment that places the
// window, so the attention stays in the recurrence and no product leaves it.
// What this design does about it: the sweep runs as stage kernels on the
// caller's stream, issued by one C call (no Python in the per-step loop), each
// with a grid of its own so that a batch of 256 rows fills the 132 SMs, and
// every product a tile product of step_tile.cuh that reads each weight once
// per row tile:
//   product    h.[W_a | R] per 64-row tile x 64-column slice of the 5W columns
//              (B=256, W=512: 160 blocks): wvec in the weight dtype to a
//              scratch (B, W), h.R as float32 to a scratch (B, 4W);
//   attention  a block of 512 threads a row: t0 as the previous step's
//              attention left it in a scratch (B), the visible positions, their
//              energies (a warp for each 256 columns of a position), the float32
//              softmax, the dense aa[t] row, the next step's t0, ctx and the four
//              masked cg_g to a scratch (4, B, A) in the weight dtype;
//   gates      cg_g.Kc_g per 64-row tile x 16-unit slice (128 blocks): the
//              block owns its units' four gate columns of Kc, each gate's
//              warps or threads reading that gate's cg rows, and the Keras
//              gates in the epilogue (K2's pattern, lstm_step.cu), which
//              writes hs[t], cs[t], zs[t]; hs[t] is the next step's h.
// Each step's three kernels are chains of dependent loads at low occupancy,
// so the loads that wait on nothing within a kernel are issued first: the
// gates stage's zx, h.R and previous c go to shared memory with the first
// chunk of its product, the attention's context rows and masks to registers
// before its energies.
// The window mask leaves at most 2*ww+1 visible positions per row and step,
// all others get exp(-1e30 - m) = 0 exactly in float32, so only the rows of u
// and attended inside the window are read (bit-identical to the dense form).
// Without a padding mask (a null pointer, no byte loaded) a row is never
// all-masked for ww >= 1, because t0 lies in [1, T]. An optional (B, T) byte
// mask, the encoder's padding mask, narrows the window to the positions whose
// byte is 1: the attention loads a byte a window position, a masked position
// gets a = 0, and a row whose window holds no valid position (an all-padding
// row, or one whose first ww + 2 positions are padding: a window that held a
// valid position leads to one that holds another) gets an all-zero aa[t] row,
// a zero context and zero cg, and the next step's t0 is 1, as in the dense form.
// The products stream both operands through shared memory by cp.async with
// NS - 1 chunks in flight: bf16 on tensor cores (mma.sync m16n8k16,
// ldmatrix.x4 fragments, float32 accumulators), float32 as exact FMA register
// tiles. Every sum runs in a fixed order, with no atomics: two launches give
// the same bits.

#include "step_tile.cuh"

#include <math.h>

namespace {

using scan::CG;
using scan::from_f;
using scan::load8;
using scan::rnd;
using scan::sig;
using scan::to_f;
using scan::warp_sum;
using namespace scan::grid;
using namespace scan::tile;

constexpr int BR = 64;    // rows of a product tile
constexpr int NCOL = 64;  // columns of a product tile
constexpr int NS = 4;     // chunk buffers
constexpr int GR = 64;    // rows of a gates tile
constexpr int US = 16;    // units of a gates tile (4 * US gate columns)
constexpr int JB = 8;     // window positions whose loads a thread issues together
constexpr int NTA = 512;  // threads of an attention block
constexpr int NWA = NTA / 32;

__host__ __device__ inline int window_max(int ww) { return 2 * ww + 1; }

// t0 - 1 = sum_i a_i*i over a row's window (`aw`: `pcnt` values from position
// `plo`), summed in the order in which the dense form's product a . positions
// (ops/attention.py: _window_center, a float32 matrix-vector product) sums it on
// an H100 (cuBLAS's gemv; found by probing it at B = 8 to 1024): a line of up to
// 56 positions as two partial sums over its halves, a longer one as 32 partial
// sums over blocks of ceil(T/32) consecutive positions, each in order by fma,
// combined by an xor butterfly. The window's placement is discontinuous in t0:
// at initialisation the alignment is close to uniform, so t0 falls within an ulp
// of an integer where a window holds an odd number of valid positions, and a sum
// in another order moves the window's edge. Every lane of the calling warp gets
// the same value.
__device__ __forceinline__ float window_centre(const float* __restrict__ aw, int plo, int pcnt,
                                               int Tn, int lane) {
  const int lanes = Tn <= 56 ? 2 : 32, n = (Tn + lanes - 1) / lanes;
  float acc = 0.0f;
  if (lane < lanes)
    for (int i = max(lane * n, plo); i < min((lane + 1) * n, plo + pcnt); ++i)
      acc = fmaf(aw[i - plo], (float)i, acc);
  return warp_sum(acc);
}

template <typename T> struct Fwd {
  const float* zx;
  const T *u, *att, *Kc, *WR, *v, *bUW;
  const float* b_v;
  const T *bias, *maskc, *h0, *c0;
  const uint8_t* mask;  // (B, T), 0 at a padded position of a row; or null
  T *hs, *cs, *aa, *zs;
  T* wv;       // scratch (B, W): this step's wvec
  float* zr;   // scratch (B, 4W): this step's h.R
  T* cg;       // scratch (4, B, A): this step's masked context per gate
  float* t0n;  // scratch (B): each row's window centre for the next step
  int Td, B, Tn, W, A, ww;
};

// dynamic shared memory of a product block
template <typename T> size_t product_smem() { return tile_product_smem<T, BR, NCOL, NS>(); }

// W columns of an energy item: a warp's 32 lanes x 8
constexpr int ECOL = 32 * CG;

// of an attention block: the window's energies, then its alignment, and the
// energies' partial sums, ceil(W / ECOL) a position
size_t attention_smem(int W, int ww) {
  return (size_t)window_max(ww) * (1 + ceil_div(W, ECOL)) * sizeof(float);
}

// the product of a gates block: 8 warps (bf16) as 2 row halves x 4 gates, or
// 256 threads (float32) as 16 rows x 16 column quads, 4 quads a gate; each
// reads its own gate's rows of cg
template <typename T> struct GateTile;
template <> struct GateTile<__nv_bfloat16> {
  using type = WarpTile<GR, 4 * US, 2, true>;
  static __device__ __forceinline__ int gate() { return (int)threadIdx.x / 64; }
};
template <> struct GateTile<float> {
  using type = FmaTile<GR, 4 * US, true>;
  static_assert(4 * US == 64, "a thread's four columns lie in one gate");
  static __device__ __forceinline__ int gate() { return ((int)threadIdx.x % 16) / 4; }
};

// of a gates block: per chunk buffer the four gates' cg rows and the gate
// columns of Kc (which the float32 product reuses), then the epilogue's zx
// and h.R (float32) and previous c of its tile
template <typename T> __host__ __device__ constexpr size_t gates_stages() {
  return (size_t)NS * ((size_t)4 * GR * chunk_ld<T>() + (size_t)kc<T>() * (4 * US + pad<T>())) *
         sizeof(T);
}
template <typename T> size_t gates_smem() {
  return gates_stages<T>() + (size_t)GR * US * (8 * sizeof(float) + sizeof(T));
}

// step t's h.[W_a | R]: a block for each row tile and slice of NCOL of the
// W_a columns or of the 4W R columns; wvec = r(r(h.W_a) + b_UW) to wv, h.R
// in float32 to zr
template <typename T>
__global__ void __launch_bounds__(NT, 2) teacher_fwd_product(const Fwd<T> a, int t) {
  extern __shared__ float4 smem4[];
  const int W = a.W, B = a.B, sa = ceil_div(W, NCOL), S = sa + ceil_div(4 * W, NCOL);
  const int s = blockIdx.x % S, b0 = (blockIdx.x / S) * BR;
  const bool wa = s < sa;
  const int c0 = (wa ? s : s - sa) * NCOL;
  const int nr = min(BR, B - b0), nc = min(NCOL, (wa ? W : 4 * W) - c0);
  const T* h = t == 0 ? a.h0 : a.hs + (size_t)(t - 1) * B * W;
  tile_product<T, BR, NCOL, NS>(smem4, h + (size_t)b0 * W, W, nr,
                                a.WR + (size_t)((wa ? 0 : W) + c0) * W, W, nc, W);
  const float* __restrict__ out = reinterpret_cast<const float*>(smem4);
  for (int i = threadIdx.x; i < nr * nc; i += NT) {
    const int r = i / nc, c = i % nc, row = b0 + r;
    if (wa)
      a.wv[(size_t)row * W + c0 + c] =
          from_f<T>(rnd<T>(out[r * NCOL + c]) + to_f<T>(a.bUW[c0 + c]));
    else
      a.zr[(size_t)row * 4 * W + c0 + c] = out[r * NCOL + c];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// this lane's part of sum_n r(tanh(r(wvec + u_row)))_n * v_n over the 8
// columns n = 8*g .. 8*g + 7
template <typename T>
__device__ __forceinline__ float lane_energy(const T* __restrict__ wv_row,
                                             const T* __restrict__ u_row,
                                             const T* __restrict__ v, int g) {
  float wq[CG], uu[CG], vv[CG], acc = 0.0f;
  load8(wv_row + g * CG, wq);
  load8(u_row + g * CG, uu);
  load8(v + g * CG, vv);
#pragma unroll
  for (int c = 0; c < CG; ++c) acc = fmaf(rnd<T>(tanhf(rnd<T>(wq[c] + uu[c]))), vv[c], acc);
  return acc;
}

// step t's attention, a block a row. Every thread finds the window from t0 (1
// at t = 0, else what step t - 1 left: `window_centre`); t0 - i is exact in
// float32, so this is the dense form's own test |t0 - i| <= ww on the
// candidates around floor(t0).
template <typename T>
__global__ void __launch_bounds__(NTA) teacher_fwd_attention(const Fwd<T> a, int t) {
  extern __shared__ float4 smem4[];
  const int A = a.A, B = a.B, Tn = a.Tn, ww = a.ww, WM = window_max(ww);
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = ceil_div(a.W, ECOL);              // energy items a position
  float* s_s = reinterpret_cast<float*>(smem4);  // [WM] energies, then a
  float* p_s = s_s + WM;                          // [WM][P] the energies' parts
  // the previous step's attention left this row's window centre
  const float t0 = t > 0 ? a.t0n[row] : 1.0f;
  const int c = (int)floorf(t0);
  int lo = 0, cnt = 0;
  for (int i = max(0, c - ww - 1); i <= min(Tn - 1, c + ww + 1); ++i)
    if (fabsf(t0 - (float)i) <= (float)ww && cnt < WM) {
      if (cnt == 0) lo = i;
      ++cnt;
    }
  // the loads of a thread's first context column at JB positions, and its
  // masks, issued before the energies
  const T* att = a.att + ((size_t)row * Tn + lo) * A;
  const int last = max(cnt - 1, 0);
  float x[JB], mk[4];
  auto load_att = [&](int k0, int j0) {
#pragma unroll
    for (int j = 0; j < JB; ++j)
      x[j] = to_f<T>(att[(size_t)min(j0 + j, last) * A + min(k0 + tid, A - 1)]);
  };
  auto load_masks = [&](int k0) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      mk[g] = to_f<T>(a.maskc[((size_t)g * B + row) * A + min(k0 + tid, A - 1)]);
  };
  load_att(0, 0);
  load_masks(0);
  // the energies as items of ECOL columns of one position, a warp an item,
  // each summed over the warp
  const T* wv_row = a.wv + (size_t)row * a.W;
  for (int item = warp; item < cnt * P; item += NWA) {
    const int g = (item % P) * 32 + lane;
    const T* u_row = a.u + ((size_t)row * Tn + lo + item / P) * a.W;
    const float e = warp_sum(g < a.W / CG ? lane_energy<T>(wv_row, u_row, a.v, g) : 0.0f);
    if (lane == 0) p_s[item] = e;
  }
  __syncthreads();
  if (warp == 0) {
    const float b_vr = rnd<T>(*a.b_v);
    const uint8_t* mrow = a.mask ? a.mask + (size_t)row * Tn + lo : nullptr;
    float m = -INFINITY, sum = 0.0f;
    for (int j = lane; j < cnt; j += 32) {
      float s = 0.0f;
      for (int q = 0; q < P; ++q) s += p_s[j * P + q];
      // a padded position: no energy, so exp gives it 0
      s_s[j] = mrow && !mrow[j] ? -INFINITY : rnd<T>(rnd<T>(s) + b_vr);
      m = fmaxf(m, s_s[j]);
    }
    m = warp_max(m);
    // m is -inf only where the mask leaves the window empty: a = 0 there
    const bool empty = m == -INFINITY;
    for (int j = lane; j < cnt; j += 32) {
      const float p = empty ? 0.0f : expf(s_s[j] - m);
      s_s[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < cnt; j += 32) s_s[j] = empty ? 0.0f : rnd<T>(s_s[j] / sum);
    // the next step's window centre from this alignment
    __syncwarp();
    const float c0 = window_centre(s_s, lo, cnt, Tn, lane);
    if (lane == 0) a.t0n[row] = c0 + 1.0f;
  }
  __syncthreads();
  const size_t at = (size_t)t * B + row;
  for (int p = tid; p < Tn; p += NTA) {
    const int j = p - lo;
    a.aa[at * Tn + p] = from_f<T>(j >= 0 && j < cnt ? s_s[j] : 0.0f);
  }
  for (int k0 = 0; k0 < A; k0 += NTA) {
    if (k0 > 0) load_masks(k0);
    float acc = 0.0f;
    for (int j0 = 0; j0 < cnt; j0 += JB) {
      if (k0 > 0 || j0 > 0) load_att(k0, j0);
#pragma unroll
      for (int j = 0; j < JB; ++j)
        if (j0 + j < cnt) acc = fmaf(s_s[j0 + j], x[j], acc);
    }
    const int k = k0 + tid;
    if (k >= A) continue;
    const float ctx = rnd<T>(acc);
#pragma unroll
    for (int g = 0; g < 4; ++g) a.cg[((size_t)g * B + row) * A + k] = from_f<T>(ctx * mk[g]);
  }
}

// step t's gates: a block for each tile of GR rows and slice of US units,
// sum_g cg_g.Kc_g over the four gate columns of its units, then
// z = r(r(zx[t] + zc + zr) + bias), the Keras gates, c and h
template <typename T>
__global__ void __launch_bounds__(NT) teacher_fwd_gates(const Fwd<T> a, int t) {
  extern __shared__ float4 smem4[];
  constexpr int KC = kc<T>(), ld = chunk_ld<T>(), ldb = 4 * US + pad<T>();
  const int W = a.W, A = a.A, B = a.B, slices = ceil_div(W, US);
  const int r0 = (blockIdx.x / slices) * GR, u0 = (blockIdx.x % slices) * US;
  const int nr = min(GR, B - r0), nu = min(US, W - u0);
  T* abuf = reinterpret_cast<T*>(smem4);             // NS x 4 gates x [GR][ld]: cg rows
  T* bbuf = abuf + (size_t)NS * 4 * GR * ld;          // NS x [KC][ldb]: Kc's gate columns
  // the epilogue's inputs, copied into shared memory with the first chunk
  // so that they arrive under the product: zx and h.R of the tile's rows
  // and gate columns, and the previous c
  const size_t W4 = (size_t)4 * W;
  float* zx_s = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + gates_stages<T>());
  float* zr_s = zx_s + GR * 4 * US;                   // [GR][4 * US] each
  T* cp_s = reinterpret_cast<T*>(zr_s + GR * 4 * US);  // [GR][US]
  const T* c_in = t == 0 ? a.c0 : a.cs + (size_t)(t - 1) * B * W;
  constexpr int VF = 4, VT = 16 / sizeof(T);  // values of a 16-byte copy
  for (int i = threadIdx.x; i < GR * 4 * US / VF; i += NT) {
    const int r = i / (4 * US / VF), g = i / (US / VF) % 4, j = i % (US / VF) * VF;
    const bool valid = r < nr && j < nu;
    const size_t col = (size_t)(r0 + r) * W4 + (size_t)g * W + u0 + j;
    const int at = r * 4 * US + g * US + j;
    cp_async16(zx_s + at, valid ? a.zx + (size_t)t * B * W4 + col : a.zx, valid);
    cp_async16(zr_s + at, valid ? a.zr + col : a.zr, valid);
  }
  for (int i = threadIdx.x; i < GR * US / VT; i += NT) {
    const int r = i / (US / VT), j = i % (US / VT) * VT;
    const bool valid = r < nr && j < nu;
    cp_async16(cp_s + r * US + j, valid ? c_in + (size_t)(r0 + r) * W + u0 + j : c_in, valid);
  }
  const int j = threadIdx.x % US, n = u0 + min(j, nu - 1);
  float bs[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bs[g] = to_f<T>(a.bias[g * W + n]);
  typename GateTile<T>::type acc(ld, ldb);
  const int gate = GateTile<T>::gate();
  pipeline<NS>(
      ceil_div(A, KC),
      [&](int c, int buf) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          copy_rows<T>(abuf + (size_t)(buf * 4 + g) * GR * ld, ld,
                       a.cg + ((size_t)g * B + r0) * A, A, GR, nr, c * KC, KC, A, true);
        copy_gate_cols<T>(bbuf + (size_t)buf * KC * ldb, ldb, a.Kc, W, u0, US, nu, c * KC, KC, A,
                          true);
      },
      [&](int c, int buf) {
        acc.template chunk<KC>(abuf + (size_t)(buf * 4 + gate) * GR * ld,
                               bbuf + (size_t)buf * KC * ldb);
      });
  acc.store(reinterpret_cast<float*>(smem4), 4 * US);
  __syncthreads();
  const float* __restrict__ zc = reinterpret_cast<const float*>(smem4);  // [GR][4 * US]
  // the tile's elements, EB a thread, all of one unit j
  constexpr int EB = GR * US / NT;
  static_assert(GR * US % NT == 0 && NT % US == 0, "whole rows of elements a thread");
#pragma unroll
  for (int e = 0; e < EB; ++e) {
    const int r = (int)(threadIdx.x + e * NT) / US;
    if (r >= nr || j >= nu) continue;
    const size_t at = (size_t)t * B + r0 + r;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int i = r * 4 * US + g * US + j;
      z[g] = rnd<T>(rnd<T>(zx_s[i] + zc[i] + zr_s[i]) + bs[g]);
      a.zs[at * W4 + (size_t)g * W + n] = from_f<T>(z[g]);
    }
    const float ig = sig<T>(z[0]), fg = sig<T>(z[1]), gg = rnd<T>(tanhf(z[2])), og = sig<T>(z[3]);
    const float cn = rnd<T>(rnd<T>(fg * to_f<T>(cp_s[r * US + j])) + rnd<T>(ig * gg));
    const float hn = rnd<T>(og * rnd<T>(tanhf(cn)));
    a.hs[at * W + n] = from_f<T>(hn);
    a.cs[at * W + n] = from_f<T>(cn);
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
         A % CG == 0 && attention_smem(W, ww) <= (size_t)max_smem() &&
         product_smem<float>() <= (size_t)max_smem() &&
         product_smem<__nv_bfloat16>() <= (size_t)max_smem() &&
         gates_smem<float>() <= (size_t)max_smem() &&
         gates_smem<__nv_bfloat16>() <= (size_t)max_smem();
}

template <class K> cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T> cudaError_t launch(const Fwd<T>& a, cudaStream_t s) {
  const size_t psmem = product_smem<T>(), gsmem = gates_smem<T>();
  const size_t asmem = attention_smem(a.W, a.ww);
  cudaError_t err;
  if ((err = allow_smem(teacher_fwd_product<T>, psmem)) != cudaSuccess ||
      (err = allow_smem(teacher_fwd_attention<T>, asmem)) != cudaSuccess ||
      (err = allow_smem(teacher_fwd_gates<T>, gsmem)) != cudaSuccess)
    return err;
  const int product_blocks =
      ceil_div(a.B, BR) * (ceil_div(a.W, NCOL) + ceil_div(4 * a.W, NCOL));
  const int gates_blocks = ceil_div(a.B, GR) * ceil_div(a.W, US);
  for (int t = 0; t < a.Td; ++t) {
    teacher_fwd_product<T><<<product_blocks, NT, psmem, s>>>(a, t);
    teacher_fwd_attention<T><<<a.B, NTA, asmem, s>>>(a, t);
    teacher_fwd_gates<T><<<gates_blocks, NT, gsmem, s>>>(a, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_dtype(const void* const* in, void* const* out, const void* mask, int Td, int B,
                         int Tn, int W, int A, int ww, cudaStream_t s) {
  const Fwd<T> a{(const float*)in[0], (const T*)in[1],  (const T*)in[2],  (const T*)in[3],
                 (const T*)in[4],     (const T*)in[5],  (const T*)in[6],  (const float*)in[7],
                 (const T*)in[8],     (const T*)in[9],  (const T*)in[10], (const T*)in[11],
                 (const uint8_t*)mask,
                 (T*)out[0],          (T*)out[1],       (T*)out[2],       (T*)out[3],
                 (T*)out[4],          (float*)out[5],   (T*)out[6],       (float*)out[7],
                 Td,                  B,                Tn,               W,
                 A,                   ww};
  return launch<T>(a, s);
}

}  // namespace

extern "C" int teacher_bwd_supported(int W, int A, int ww);  // teacher_bwd.cu

// 1 if K6 and K7 take these widths and this window on the current device
// (multiples of 8, ww >= 1, their blocks' scratch within a block's shared
// memory), else 0
extern "C" int teacher_scan_supported(int W, int A, int ww) {
  return shapes_ok(1, 1, 1, W, A, ww) && teacher_bwd_supported(W, A, ww);
}

// K6. dtype: 0 = float32, 1 = bfloat16. `in`: zx (float32), u, att, Kc
// (A, 4W), [W_a | R]^T (5W, W), v, b_UW, b_v (float32), bias, maskc, h0, c0;
// `out`: hs, cs, aa, zs, then the scratch: wvec (B, W) in dt, h.R (B, 4W)
// float32, cg (4, B, A) in dt, and each row's next window centre (B float32).
// `mask`: null, or (B, T) bytes, 0 at a padded position.
// Issues 3*Td launches on `stream`; returns the first CUDA error.
extern "C" int teacher_fwd_launch(int dtype, const void* const* in, void* const* out,
                                  const void* mask, int Td, int B, int Tn, int W, int A, int ww,
                                  void* stream) {
  if (!shapes_ok(Td, B, Tn, W, A, ww)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_dtype<float>(in, out, mask, Td, B, Tn, W, A, ww, s);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16>(in, out, mask, Td, B, Tn, W, A, ww, s);
  return (int)cudaErrorInvalidValue;
}
