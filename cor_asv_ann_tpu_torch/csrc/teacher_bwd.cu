// K7: the reverse-time sweep of the teacher-forced top decoder layer (local
// additive attention + LSTM cell), for Hopper (sm_90a), float32 or bfloat16.
//
// Replaces the JAX package's Pallas kernel ops/pallas_teacher.py: _b1_kernel
// (the backward of teacher_top_fused). With dt the weight dtype, r() a float32
// value rounded to dt, u (B, T, W), attended (B, T, A), Kc (A, 4W) the context
// half of the cell kernel, R (W, 4W), W_a (W, W), v, b_UW (W), maskc (4, B, A)
// per-gate dropout multipliers, and the residuals of K6 (teacher_scan.cu):
// zs, cs (Td, B, 4W / W), aa (Td, B, T), hprev, cprev (the state each step
// started from), per step t = Td-1..0 with dh, dc carried in float32:
//
//     wvec = r(r(hprev[t].W_a) + b_UW)
//     gates from zs[t];  dh = g[t] + dh;  dc = dc + dh*o*(1-tanh(cs[t])^2)
//     dz = r([dc*g*i(1-i), dc*cprev[t]*f(1-f), dc*i*(1-g^2), dh*tanh(c)*o(1-o)])
//     dctx = sum_g maskc_g * (dz_g.Kc_g^T)  (float32);  dh' = dz.R^T;  dc = dc*f
//     da_i = attended_i.dctx;  ds = r(a*(da - sum a*da))       (a = aa[t])
//     e_i = r(tanh(r(wvec + u_i)));  dva += sum_i e_i*ds_i
//     dpre_i = ds_i*v*(1-e_i^2);  dwvec = r(sum_i dpre_i);  du_i += dpre_i
//     datt_i += a_i*dctx;  dh = dh' + dwvec.W_a^T
//
// emitting dz, ds, dctx, dwvec per step (dt), dh0, dc0, the per-row dva
// partials (B, W), du (B, T, W) and datt (B, T, A) in float32. A step's window
// is found from the first non-zero entry of aa[t] (2*ww + 1 positions from
// there): where a is 0 every term is 0, and a row whose aa[t] is all zero (a
// padding mask left its window empty) adds nothing. Under K6's optional (B, T)
// byte mask the window terms take only the positions whose byte is 1, as K6's
// softmax did: a padded position gets da = ds = 0 and no read-modify-write of
// du or datt (a null pointer loads no byte). Every sum runs in a fixed order,
// with no atomics: two launches give the same bits.
//
// What bounds it on an H100: in bf16 the bytes of the stacks (0.19 ms at
// B=256, Td=T=128, W=A=512), in float32 the operations of the four products,
// 2*(2W^2 + 4AW + 4W^2) per row and step (2.6 ms on the FMA pipe there).
// The bound that chip_smoke.py computes counts du and datt once, but the sweep
// read-modify-writes their window rows every step: up to (2*ww+1)*(W+A)*8
// bytes a row and step, 23 MB a step at that shape, which L2 (50 MB) holds only
// while the windows of neighbouring steps overlap. The TPU kernel keeps a
// batch tile's u, attended and all weights in VMEM; a Hopper block has 227 KB.
// What this design does about it: the sweep runs as stage kernels on the
// caller's stream, issued by one C call (no Python in the per-step loop), each
// with a grid of its own so that a batch of 256 rows fills the 132 SMs:
//   wvec       before the sweep, one product over all Td*B rows, hprev.W_a with
//              the rounding of K6's finish_wvec in its epilogue: the one
//              product of the four that does not depend on the carry leaves
//              the recurrence;
//   prologue   the cell backward of step Td-1 from g alone (elementwise);
//   product    per step, dz_t.[Kc | R]^T per row tile x 64-column slice x
//              gate: float32 partial sums per gate to a scratch (4, B, A+W),
//              so that the masks apply per gate and each weight is read once
//              per 64-row tile;
//   attention  per step, a block for each row and ACOL of its W or A columns:
//              dctx from the gate partials and the masks, da, ds, the window
//              terms, and the read-modify-write of the visible rows of du and
//              datt, each (row, position, column) owned by one thread;
//   carry      per step, dh = dh' + r(dwvec).W_a^T per 16-row tile x 64-unit
//              slice, and in its epilogue the cell backward of the next step
//              down: dz_{t-1} for the next product stage, dc <- dc*f.
// These steps are chains of dependent loads at low occupancy, so a thread
// issues the loads of several window positions (JB) or carry elements (EB)
// before any of their stores.
// The products stream both operands through shared memory by cp.async with
// NS - 1 chunks in flight (step_tile.cuh): bf16 on tensor cores (mma.sync
// m16n8k16, ldmatrix.x4 fragments, float32 accumulators), float32 as exact FMA
// register tiles. wvec lives in a scratch (Td, B, W) in dt; the carried dc in
// dc0, the dva partials in dva.

#include "step_tile.cuh"

#include <limits.h>
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
constexpr int NS = 3;     // chunk buffers
constexpr int BRC = 16;   // rows of a carry tile
constexpr int CCOL = 64;  // columns of a carry tile
constexpr int ACOL = 512; // W or A columns of an attention block
constexpr int JB = 8;     // window positions whose loads a thread issues together
constexpr int EB = 4;     // carry elements whose loads a thread issues together

__host__ __device__ inline int window_max(int ww) { return 2 * ww + 1; }

template <typename T> struct Bwd {
  const T *zs, *g, *hprev, *cprev, *cs, *aa, *u, *att, *Kc, *R, *Wa, *WaT, *v, *bUW, *maskc;
  const uint8_t* mask;  // (B, T), 0 at a padded position of a row; or null
  T *dz, *ds, *dctx, *dwvec;
  float *dh0, *dc0, *dva, *du, *datt;
  T* wv;        // scratch (Td, B, W): wvec of every step
  float* part;  // scratch (4, B, A + W): per gate, dz_g.Kc_g^T | dz_g.R_g^T
  int Td, B, Tn, W, A, ww;
};

// dynamic shared memory of a product block
template <typename T> size_t product_smem() { return tile_product_smem<T, BR, NCOL, NS>(); }

// of a carry block: the chunk buffers, which the product's float32 result and
// the partial sums of its split reduction reuse
template <typename T> size_t carry_smem() {
  const size_t stages = (size_t)NS * (BRC + CCOL) * chunk_ld<T>() * sizeof(T);
  const size_t out = ((size_t)BRC * CCOL + part_floats<T>()) * sizeof(float);
  return stages > out ? stages : out;
}

// of the attention kernel: dctx, the window's a, da, ds, its start and size,
// and whether each of its positions is valid
size_t attention_smem(int A, int ww) {
  return ((size_t)A + 4 * (size_t)window_max(ww) + 2) * sizeof(float);
}

// what the cell backward of step t at (row, n) reads
struct CellIn {
  float z[4], c, g, cprev;
};

template <typename T>
__device__ __forceinline__ CellIn cell_in(const Bwd<T>& a, int t, int row, int n) {
  const int W = a.W;
  const size_t at = (size_t)t * a.B + row;
  const T* z = a.zs + at * 4 * W + n;
  CellIn x;
#pragma unroll
  for (int g = 0; g < 4; ++g) x.z[g] = to_f<T>(z[g * W]);
  x.c = to_f<T>(a.cs[at * W + n]);
  x.g = to_f<T>(a.g[at * W + n]);
  x.cprev = to_f<T>(a.cprev[at * W + n]);
  return x;
}

// the cell backward of step t at (row, n) from what it reads, the carried dh
// (g[t] not yet added) and dc: emits dz[t] there and returns the next carry
// dc*f
template <typename T>
__device__ __forceinline__ float cell_bwd(const Bwd<T>& a, int t, int row, int n, const CellIn& x,
                                          float dh_in, float dc_in) {
  const int W = a.W;
  const float ig = sig<T>(x.z[0]), fg = sig<T>(x.z[1]);
  const float gg = rnd<T>(tanhf(x.z[2])), og = sig<T>(x.z[3]);
  const float th = tanhf(x.c);
  const float dh = x.g + dh_in;
  const float dc = dc_in + dh * og * (1.0f - th * th);
  const float d_o = dh * th, d_i = dc * gg, d_g = dc * ig;
  const float d_f = dc * x.cprev;
  T* dz = a.dz + ((size_t)t * a.B + row) * 4 * W + n;
  dz[0] = from_f<T>(d_i * ig * (1.0f - ig));
  dz[W] = from_f<T>(d_f * fg * (1.0f - fg));
  dz[2 * W] = from_f<T>(d_g * (1.0f - gg * gg));
  dz[3 * W] = from_f<T>(d_o * og * (1.0f - og));
  return dc * fg;
}

// wvec of every step: a block for each tile of the Td*B rows of hprev and
// slice of NCOL columns
template <typename T>
__global__ void __launch_bounds__(NT, 2) teacher_bwd_wvec(const Bwd<T> a) {
  extern __shared__ float4 smem4[];
  const int W = a.W, slices = ceil_div(W, NCOL), rows = a.Td * a.B;
  const int r0 = (blockIdx.x / slices) * BR, c0 = (blockIdx.x % slices) * NCOL;
  const int nr = min(BR, rows - r0), nc = min(NCOL, W - c0);
  tile_product<T, BR, NCOL, NS>(smem4, a.hprev + (size_t)r0 * W, W, nr, a.WaT + (size_t)c0 * W,
                                W, nc, W);
  const float* out = reinterpret_cast<const float*>(smem4);
  for (int i = threadIdx.x; i < nr * nc; i += NT) {
    const int r = i / nc, c = i % nc;
    a.wv[(size_t)(r0 + r) * W + c0 + c] =
        from_f<T>(rnd<T>(out[r * NCOL + c]) + to_f<T>(a.bUW[c0 + c]));
  }
}

// the cell backward of step Td-1 (no carry yet); dva starts at 0
template <typename T> __global__ void __launch_bounds__(NT) teacher_bwd_prologue(const Bwd<T> a) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= a.B * a.W) return;
  const int t = a.Td - 1, row = i / a.W, n = i % a.W;
  a.dc0[i] = cell_bwd<T>(a, t, row, n, cell_in<T>(a, t, row, n), 0.0f, 0.0f);
  a.dva[i] = 0.0f;
}

// step t's dz_t.[Kc | R]^T: a block for each row tile, slice of NCOL columns
// of dctx or of dh', and gate, its float32 sum over the gate's W to part
template <typename T>
__global__ void __launch_bounds__(NT, 2) teacher_bwd_product(const Bwd<T> a, int t) {
  extern __shared__ float4 smem4[];
  const int W = a.W, A = a.A, B = a.B, sa = ceil_div(A, NCOL), S = sa + ceil_div(W, NCOL);
  const int gate = blockIdx.x % 4, s = (blockIdx.x / 4) % S, b0 = (blockIdx.x / (4 * S)) * BR;
  const bool ctx = s < sa;
  const int c0 = (ctx ? s : s - sa) * NCOL;
  const int nr = min(BR, B - b0), nc = min(NCOL, (ctx ? A : W) - c0);
  const size_t W4 = (size_t)4 * W;
  tile_product<T, BR, NCOL, NS>(smem4, a.dz + ((size_t)t * B + b0) * W4 + gate * W, W4, nr,
                                (ctx ? a.Kc : a.R) + c0 * W4 + gate * W, W4, nc, W);
  const float* out = reinterpret_cast<const float*>(smem4);
  float* dst = a.part + ((size_t)gate * B + b0) * (A + W) + (ctx ? 0 : A) + c0;
  for (int i = threadIdx.x; i < nr * nc; i += NT) {
    const int r = i / nc, c = i % nc;
    dst[(size_t)r * (A + W) + c] = out[r * NCOL + c];
  }
}

// step t's attention backward: ceil(W / ACOL) blocks a row for its W columns
// (u, du, dva, dwvec; the first also ds) and ceil(A / ACOL) for its A columns
// (dctx, datt). Each thread issues the loads of JB window positions before
// their stores.
template <typename T>
__global__ void __launch_bounds__(NT) teacher_bwd_attention(const Bwd<T> a, int t) {
  extern __shared__ float4 smem4[];
  const int W = a.W, A = a.A, B = a.B, Tn = a.Tn, WM = window_max(a.ww);
  const int PW = ceil_div(W, ACOL), parts = PW + ceil_div(A, ACOL);
  const int row = blockIdx.x / parts, part = blockIdx.x % parts;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* dctx_s = reinterpret_cast<float*>(smem4);  // [A]
  float* aw_s = dctx_s + A;                          // [WM]  a over the window
  float* da_s = aw_s + WM;                           // [WM]
  float* ds_s = da_s + WM;                           // [WM]  r(ds)
  int* win_s = reinterpret_cast<int*>(ds_s + WM);    // first visible position, count
  int* ok_s = win_s + 2;                             // [WM]  1 where the mask holds
  const size_t at = (size_t)t * B + row;
  if (warp == 0) {
    // this step's window: from the first non-zero entry of aa[t]
    const T* arow = a.aa + at * Tn;
    int first = INT_MAX;
    for (int p0 = lane; p0 < Tn && first == INT_MAX; p0 += 32 * JB) {
      float x[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) x[q] = to_f<T>(arow[min(p0 + 32 * q, Tn - 1)]);
#pragma unroll
      for (int q = JB - 1; q >= 0; --q)
        if (p0 + 32 * q < Tn && x[q] != 0.0f) first = p0 + 32 * q;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
    const int cnt = first == INT_MAX ? 0 : min(WM, Tn - first);
    if (first == INT_MAX) first = 0;
    const uint8_t* mrow = a.mask ? a.mask + (size_t)row * Tn + first : nullptr;
    for (int j = lane; j < cnt; j += 32) {
      aw_s[j] = to_f<T>(arow[first + j]);
      ok_s[j] = mrow ? mrow[j] : 1;
    }
    if (lane == 0) {
      win_s[0] = first;
      win_s[1] = cnt;
    }
  }
  // dctx = sum_g maskc_g * (dz_g . Kc_g^T), float32, the gates in order: all
  // of it for a W block (da), its own column for an A block
  const size_t gstride = (size_t)B * (A + W);
  const float* prow = a.part + (size_t)row * (A + W);
  const int c0 = (part < PW ? part : part - PW) * ACOL;
  const int k0 = part < PW ? 0 : c0, k1 = part < PW ? A : min(A, c0 + ACOL);
  for (int k = k0 + tid; k < k1; k += NT) {
    float d = 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      d = d + to_f<T>(a.maskc[((size_t)g * B + row) * A + k]) * prow[g * gstride + k];
    dctx_s[k] = d;
  }
  __syncthreads();
  const int lo = win_s[0], cnt = win_s[1];
  if (part >= PW) {
    for (int k = k0 + tid; k < k1; k += NT) {
      const float d = dctx_s[k];
      a.dctx[at * A + k] = from_f<T>(d);
      float* p0 = a.datt + ((size_t)row * Tn + lo) * A + k;
      for (int j0 = 0; j0 < cnt; j0 += JB) {
        float x[JB];
#pragma unroll
        for (int q = 0; q < JB; ++q) x[q] = p0[(size_t)min(j0 + q, cnt - 1) * A];
#pragma unroll
        for (int q = 0; q < JB; ++q)
          if (j0 + q < cnt && ok_s[j0 + q]) p0[(size_t)(j0 + q) * A] = x[q] + aw_s[j0 + q] * d;
      }
    }
    return;
  }
  for (int j = warp; j < cnt; j += NW) {
    if (!ok_s[j]) {
      if (lane == 0) da_s[j] = 0.0f;
      continue;
    }
    const T* arow = a.att + ((size_t)row * Tn + lo + j) * A;
    float acc = 0.0f;
    for (int q = lane; q < A / CG; q += 32) {
      float x[CG];
      load8(arow + q * CG, x);
#pragma unroll
      for (int c = 0; c < CG; ++c) acc = fmaf(x[c], dctx_s[q * CG + c], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) da_s[j] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    float dot = 0.0f;
    for (int j = 0; j < cnt; ++j) dot = fmaf(aw_s[j], da_s[j], dot);
    for (int j = 0; j < cnt; ++j) ds_s[j] = ok_s[j] ? rnd<T>(aw_s[j] * (da_s[j] - dot)) : 0.0f;
  }
  __syncthreads();
  if (part == 0)
    for (int p = tid; p < Tn; p += NT) {
      const int j = p - lo;
      a.ds[at * Tn + p] = from_f<T>(j >= 0 && j < cnt ? ds_s[j] : 0.0f);
    }
  for (int n = c0 + tid; n < min(W, c0 + ACOL); n += NT) {
    const float wv = to_f<T>(a.wv[at * W + n]), vn = to_f<T>(a.v[n]);
    float acc = a.dva[(size_t)row * W + n], dw = 0.0f;
    const size_t p0 = ((size_t)row * Tn + lo) * W + n;
    for (int j0 = 0; j0 < cnt; j0 += JB) {
      float uu[JB], dd[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const size_t p = p0 + (size_t)min(j0 + q, cnt - 1) * W;
        uu[q] = to_f<T>(a.u[p]);
        dd[q] = a.du[p];
      }
#pragma unroll
      for (int q = 0; q < JB; ++q)
        if (j0 + q < cnt && ok_s[j0 + q]) {
          const float e = rnd<T>(tanhf(rnd<T>(wv + uu[q])));
          const float d = ds_s[j0 + q];
          acc = fmaf(e, d, acc);
          const float dpre = d * vn * (1.0f - e * e);
          dw += dpre;
          a.du[p0 + (size_t)(j0 + q) * W] = dd[q] + dpre;
        }
    }
    a.dva[(size_t)row * W + n] = acc;
    a.dwvec[at * W + n] = from_f<T>(dw);
  }
}

// step t's dh = dh' + r(dwvec) . W_a^T: a block for each tile of BRC rows and
// slice of CCOL units (a small product: TileProduct, whose runtime tiles take
// 16 rows), then the cell backward of step t - 1 (or, after step 0, dh0), a
// thread's EB elements' loads first, then their arithmetic and stores
template <typename T>
__global__ void __launch_bounds__(NT, 2) teacher_bwd_carry(const Bwd<T> a, int t) {
  extern __shared__ float4 smem4[];
  constexpr int KC = kc<T>(), ld = chunk_ld<T>();
  const int W = a.W, A = a.A, B = a.B, slices = ceil_div(W, CCOL);
  const int b0 = (blockIdx.x / slices) * BRC, c0 = (blockIdx.x % slices) * CCOL;
  const int nr = min(BRC, B - b0), nc = min(CCOL, W - c0);
  T* abuf = reinterpret_cast<T*>(smem4);
  T* bbuf = abuf + (size_t)NS * BRC * ld;
  const T* asrc = a.dwvec + ((size_t)t * B + b0) * W;
  const T* bsrc = a.Wa + (size_t)c0 * W;
  TileProduct<T> prod(BRC, CCOL);
  pipeline<NS>(
      ceil_div(W, KC),
      [&](int c, int buf) {
        copy_rows<T>(abuf + (size_t)buf * BRC * ld, ld, asrc, W, BRC, nr, c * KC, KC, W, true);
        copy_rows<T>(bbuf + (size_t)buf * CCOL * ld, ld, bsrc, W, CCOL, nc, c * KC, KC, W, true);
      },
      [&](int c, int buf) {
        prod.chunk(abuf + (size_t)buf * BRC * ld, ld, bbuf + (size_t)buf * CCOL * ld, ld, KC);
      });
  float* out = reinterpret_cast<float*>(smem4);
  prod.finish(out, CCOL, out + BRC * CCOL);
  const size_t gstride = (size_t)B * (A + W);
  const int m = nr * nc;
  for (int i0 = threadIdx.x; i0 < m; i0 += EB * NT) {
    float dh[EB], dc[EB];
    CellIn x[EB];
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      const int i = min(i0 + e * NT, m - 1), r = i / nc, row = b0 + r, n = c0 + i % nc;
      const float* p = a.part + (size_t)row * (A + W) + A + n;
      float s = 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g) s += p[g * gstride];
      dh[e] = s + out[r * CCOL + i % nc];
      if (t > 0) {
        x[e] = cell_in<T>(a, t - 1, row, n);
        dc[e] = a.dc0[(size_t)row * W + n];
      }
    }
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      const int i = i0 + e * NT, row = b0 + i / nc, n = c0 + i % nc;
      if (i >= m) break;
      if (t > 0)
        a.dc0[(size_t)row * W + n] = cell_bwd<T>(a, t - 1, row, n, x[e], dh[e], dc[e]);
      else
        a.dh0[(size_t)row * W + n] = dh[e];
    }
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
         A % CG == 0 && attention_smem(A, ww) <= (size_t)max_smem() &&
         product_smem<float>() <= (size_t)max_smem() &&
         product_smem<__nv_bfloat16>() <= (size_t)max_smem() &&
         carry_smem<float>() <= (size_t)max_smem() &&
         carry_smem<__nv_bfloat16>() <= (size_t)max_smem();
}

template <class K> cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T> cudaError_t launch(const Bwd<T>& a, cudaStream_t s) {
  const size_t psmem = product_smem<T>(), csmem = carry_smem<T>();
  const size_t asmem = attention_smem(a.A, a.ww);
  cudaError_t err;
  if ((err = allow_smem(teacher_bwd_wvec<T>, psmem)) != cudaSuccess ||
      (err = allow_smem(teacher_bwd_product<T>, psmem)) != cudaSuccess ||
      (err = allow_smem(teacher_bwd_carry<T>, csmem)) != cudaSuccess ||
      (err = allow_smem(teacher_bwd_attention<T>, asmem)) != cudaSuccess)
    return err;
  const int tiles = ceil_div(a.B, BR), slices = ceil_div(a.W, NCOL);
  const int wv_blocks = ceil_div(a.Td * a.B, BR) * slices;
  const int cell_blocks = ceil_div(a.B * a.W, NT);
  const int product_blocks = tiles * (ceil_div(a.A, NCOL) + slices) * 4;
  const int carry_blocks = ceil_div(a.B, BRC) * ceil_div(a.W, CCOL);
  const int att_blocks = a.B * (ceil_div(a.W, ACOL) + ceil_div(a.A, ACOL));
  teacher_bwd_wvec<T><<<wv_blocks, NT, psmem, s>>>(a);
  teacher_bwd_prologue<T><<<cell_blocks, NT, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int t = a.Td - 1; t >= 0; --t) {
    teacher_bwd_product<T><<<product_blocks, NT, psmem, s>>>(a, t);
    teacher_bwd_attention<T><<<att_blocks, NT, asmem, s>>>(a, t);
    teacher_bwd_carry<T><<<carry_blocks, NT, csmem, s>>>(a, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_dtype(const void* const* in, void* const* out, const void* mask, int Td, int B,
                         int Tn, int W, int A, int ww, cudaStream_t s) {
  const Bwd<T> a{(const T*)in[0],  (const T*)in[1],  (const T*)in[2],  (const T*)in[3],
                 (const T*)in[4],  (const T*)in[5],  (const T*)in[6],  (const T*)in[7],
                 (const T*)in[8],  (const T*)in[9],  (const T*)in[10], (const T*)in[11],
                 (const T*)in[12], (const T*)in[13], (const T*)in[14], (const uint8_t*)mask,
                 (T*)out[0],
                 (T*)out[1],       (T*)out[2],       (T*)out[3],       (float*)out[4],
                 (float*)out[5],   (float*)out[6],   (float*)out[7],   (float*)out[8],
                 (T*)out[9],       (float*)out[10],  Td,               B,
                 Tn,               W,                A,                ww};
  return launch<T>(a, s);
}

}  // namespace

// 1 if K7 takes these widths and this window on the current device (multiples
// of 8, ww >= 1, its blocks' scratch within a block's shared memory), else 0
extern "C" int teacher_bwd_supported(int W, int A, int ww) {
  return shapes_ok(1, 1, 1, W, A, ww) ? 1 : 0;
}

// K7. dtype: 0 = float32, 1 = bfloat16. `in`: zs, g, hprev, cprev, cs, aa, u,
// att, Kc (A, 4W), R (W, 4W), W_a, W_a^T, v, b_UW, maskc; `out`: dz, ds, dctx,
// dwvec (dt), dh0, dc0, dva, du, datt (float32; du and datt zeroed by the
// caller), then the scratch: wvec (Td, B, W) in dt and the gate partials
// (4, B, A + W) float32. `mask`: null, or K6's (B, T) bytes. Issues
// 2 + 3*Td launches on `stream`; returns the first CUDA error.
extern "C" int teacher_bwd_launch(int dtype, const void* const* in, void* const* out,
                                  const void* mask, int Td, int B, int Tn, int W, int A, int ww,
                                  void* stream) {
  if (!shapes_ok(Td, B, Tn, W, A, ww)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_dtype<float>(in, out, mask, Td, B, Tn, W, A, ww, s);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16>(in, out, mask, Td, B, Tn, W, A, ww, s);
  return (int)cudaErrorInvalidValue;
}
