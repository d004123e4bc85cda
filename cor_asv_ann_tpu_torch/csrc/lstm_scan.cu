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
// An optional padding mask (T, B) of bytes gives both the semantics of the JAX
// package's ops/lstm.py:lstm_scan(mask=): at a step whose byte is 0 K4 passes
// the row's carry on unchanged (hs[t], cs[t] hold the carry, so the final state
// is the carry after the last valid step) and K5 writes dzx[t] = 0, adds no
// cotangent of hs[t] and passes the carried dh, dc on unchanged. The zeroed
// outputs of masked steps are the caller's (ops/lstm_scan_kernel.py). Without
// a mask (a null pointer) no step loads a byte.
//
// The input projection and the weight gradient hprev^T.dzx stay outside, as in
// the JAX package. The h.R and dz.R^T products are computed here.
//
// What bounds them on an H100: operations (2*T*B*N*4N, K5 twice that) if the
// recurrent weights stay on chip, as they stay in the TPU's VMEM. They do not
// fit one block's shared memory (2 MB in bf16 at N = 512), so the design
// spreads them over the grid: one cooperative launch of G row groups x S unit
// slices, at most one block per SM. Block (g, s) owns the ceil(B/G) rows of
// group g and the N/S units of slice s, and keeps for the whole sweep the 4N/S
// gate columns of R for its units (K5 also the N/S rows of R, for dz.R^T) in
// shared memory, so the gate math and the carry of its units never leave the
// block. Once a step the blocks of a row group exchange what the next step
// needs through L2: K4 reads h_{t-1} of the group's rows back from hs itself,
// K5 reads r(dz) of the step before from dzx itself (both are outputs and
// already rounded to dt, so the exchange is exact), and they meet at a
// counter per row group (scan_grid.cuh). What is left on the serial chain per
// step is one product of the group's rows with the resident slice (bf16 on
// tensor cores, mma.sync m16n8k16; f32 exact FMA), the exchange read and the
// barrier: K5 recomputes z = zx[t] + r(hprev[t].R) before it waits, since
// hprev is known for every t before the sweep starts. The launcher picks G,
// S, the reduction chunk and what stays resident from B, N and the card's SM
// count and shared memory; a batch too large for one co-resident grid runs as
// several launches over row ranges (rows are independent). Sums run in a
// fixed order, so two runs give the same bits.

#include "scan_grid.cuh"

namespace {

using scan::from_f;
using scan::rnd;
using scan::sig;
using scan::to_f;
using namespace scan::grid;

constexpr int MAX_N = 1024;    // the widest layer the kernels take

// how a launch splits the work; `res` bit 0: R's gate columns of the block's
// units stay in shared memory, bit 1 (K5): R's rows of its units
struct Plan {
  int BR, US, G, S, KC, res, rows;  // rows: batch rows per launch
};

// buffers for chunks of A: two (one filled while the other is multiplied)
// where a product takes more than one chunk
__host__ __device__ inline int a_buffers(int kind, int N, const Plan& p) {
  return p.KC < round_up(kind == 0 ? N : 4 * N, 16) ? 2 : 1;
}

// dynamic shared memory of a block, in bytes (kind 0: K4, 1: K5)
template <typename T>
__host__ __device__ size_t plan_smem(int kind, int N, const Plan& p) {
  const size_t E = sizeof(T);
  const int P = pad<T>();
  const int Mp = p.BR;                     // a multiple of 16
  size_t b = 0;
  if (p.res & 1) b += (size_t)4 * p.US * (round_up(N, 16) + P) * E;
  if (kind == 1 && (p.res & 2)) b += (size_t)p.US * (4 * N + P) * E;
  int stage = 0;                           // columns of a staged chunk of B
  if (!(p.res & 1)) stage = 4 * p.US;
  if (kind == 1 && !(p.res & 2)) stage = max(stage, p.US);
  b += (size_t)stage * (p.KC + P) * E;
  b += (size_t)a_buffers(kind, N, p) * Mp * (p.KC + P) * E;   // chunks of A
  b += (size_t)Mp * 4 * p.US * 4;          // z
  b += (size_t)(kind == 1 ? 2 : 1) * Mp * p.US * 4;  // c (K4) or dh, dc (K5)
  b += (size_t)part_floats<T>() * 4;
  return b;
}

// the shared-memory regions of a block, in the order plan_smem counts them
template <typename T> struct Smem {
  T *rc, *rr, *bst, *a, *a2;
  float *z, *s1, *s2, *part;
  __device__ Smem(unsigned char* base, int kind, int N, const Plan& p) {
    const int P = pad<T>();
    unsigned char* q = base;
    auto take = [&](size_t bytes) { unsigned char* r = q; q += bytes; return r; };
    rc = (p.res & 1) ? (T*)take((size_t)4 * p.US * (round_up(N, 16) + P) * sizeof(T)) : nullptr;
    rr = (kind == 1 && (p.res & 2)) ? (T*)take((size_t)p.US * (4 * N + P) * sizeof(T)) : nullptr;
    int stage = 0;
    if (!(p.res & 1)) stage = 4 * p.US;
    if (kind == 1 && !(p.res & 2)) stage = max(stage, p.US);
    bst = (T*)take((size_t)stage * (p.KC + P) * sizeof(T));
    a = (T*)take((size_t)p.BR * (p.KC + P) * sizeof(T));
    a2 = a_buffers(kind, N, p) == 2 ? (T*)take((size_t)p.BR * (p.KC + P) * sizeof(T)) : nullptr;
    z = (float*)take((size_t)p.BR * 4 * p.US * 4);
    s1 = (float*)take((size_t)p.BR * p.US * 4);
    s2 = kind == 1 ? (float*)take((size_t)p.BR * p.US * 4) : nullptr;
    part = (float*)take((size_t)part_floats<T>() * 4);
  }
};

template <typename T> struct FwdArgs {
  const T *zx, *R, *h0, *c0;
  const uint8_t* mask;  // (T, B), 0 where a row's step is padding; or null
  T *hs, *cs, *hT, *cT;
  int* bar;
  int Tn, B, N, reverse, row0, nrows;
  Plan p;
};

template <typename T> struct BwdArgs {
  const T *g_hs, *g_hT, *g_cT, *zx, *R, *hprev, *cprev, *cs;
  const uint8_t* mask;
  T* dzx;
  float *dh0, *dc0;
  int* bar;
  int Tn, B, N, reverse, row0, nrows;
  Plan p;
};

constexpr int EPT = 4;  // gate elements of a thread whose inputs are loaded together

// gate values of one (row, unit) from its four zx values and the float32
// sums of h.R, in dt
template <typename T>
__device__ __forceinline__ void gates(const float (&zxv)[4], const float* __restrict__ z_row,
                                      int US, int j, float& ig, float& fg, float& gg, float& og) {
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) z[g] = rnd<T>(zxv[g] + rnd<T>(z_row[g * US + j]));
  ig = sig<T>(z[0]);
  fg = sig<T>(z[1]);
  gg = rnd<T>(tanhf(z[2]));
  og = sig<T>(z[3]);
}

// the block's place in the grid: its rows [rb, rb + nr) and units [u0, u0 + nu)
struct Place {
  int g, s, rb, nr, Mp, u0, nu;
  int* counter;
  __device__ Place(const Plan& p, int row0, int nrows, int N, int* bar) {
    g = blockIdx.x / p.S;
    s = blockIdx.x % p.S;
    rb = row0 + g * p.BR;
    nr = min(p.BR, row0 + nrows - rb);
    Mp = round_up(nr, 16);
    u0 = s * p.US;
    nu = min(p.US, N - u0);
    counter = bar + rb / p.BR;
  }
};

template <typename T>
__global__ void __launch_bounds__(NT) lstm_scan_fwd_kernel(const FwdArgs<T> a) {
  extern __shared__ float4 smem4[];
  const Plan& p = a.p;
  const int N = a.N, N4 = 4 * N, US = p.US;
  const Place pl(p, a.row0, a.nrows, N, a.bar);
  Smem<T> sm(reinterpret_cast<unsigned char*>(smem4), 0, N, p);
  const int ldr = round_up(N, 16) + pad<T>();
  if (sm.rc) stage_gate_cols<T>(sm.rc, ldr, a.R, N, pl.u0, US, pl.nu, 0, round_up(N, 16));
  for (int i = threadIdx.x; i < pl.nr * US; i += NT) {
    const int r = i / US, j = i % US;
    sm.s1[i] = j < pl.nu ? to_f<T>(a.c0[(size_t)(pl.rb + r) * N + pl.u0 + j]) : 0.0f;
  }
  __syncthreads();
  auto stage_b = [&](T* dst, int ldd, int k0, int kc) {
    stage_gate_cols<T>(dst, ldd, a.R, N, pl.u0, US, pl.nu, k0, kc);
  };
  for (int i = 0; i < a.Tn; ++i) {
    const int t = a.reverse ? a.Tn - 1 - i : i;
    const T* h;
    if (i == 0) {
      h = a.h0 + (size_t)pl.rb * N;
    } else {
      group_wait(pl.counter, i * p.S);
      const int tp = a.reverse ? t + 1 : t - 1;
      h = a.hs + ((size_t)tp * a.B + pl.rb) * N;
    }
    product<T>(h, N, pl.Mp, pl.nr, N, 4 * US, sm.rc, ldr, stage_b, sm.a, sm.a2, sm.bst, p.KC, sm.part,
               sm.z, 4 * US);
    const bool last = i == a.Tn - 1;
    // the inputs of EPT elements first, so that their loads are in flight
    // together; then the gate math
    for (int e0 = threadIdx.x; e0 < pl.nr * US; e0 += EPT * NT) {
      float zxv[EPT][4];
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int e = e0 + k * NT, r = e / US, j = e % US;
        if (e < pl.nr * US && j < pl.nu) {
          const T* zr = a.zx + ((size_t)t * a.B + pl.rb + r) * N4 + pl.u0 + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) zxv[k][g] = to_f<T>(zr[g * N]);
        }
      }
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int e = e0 + k * NT, r = e / US, j = e % US;
        if (e >= pl.nr * US || j >= pl.nu) continue;
        const int row = pl.rb + r, u = pl.u0 + j;
        const size_t at = (size_t)t * a.B + row;
        float cn, hn;
        if (a.mask && !a.mask[at]) {
          // padding: the carry passes on (h of the unit as the product read it)
          cn = sm.s1[e];
          hn = to_f<T>(h[(size_t)r * N + u]);
        } else {
          float ig, fg, gg, og;
          gates<T>(zxv[k], sm.z + (size_t)r * 4 * US, US, j, ig, fg, gg, og);
          cn = rnd<T>(rnd<T>(fg * sm.s1[e]) + rnd<T>(ig * gg));
          hn = rnd<T>(og * rnd<T>(tanhf(cn)));
          sm.s1[e] = cn;
        }
        a.hs[at * N + u] = from_f<T>(hn);
        a.cs[at * N + u] = from_f<T>(cn);
        if (last) {
          a.hT[(size_t)row * N + u] = from_f<T>(hn);
          a.cT[(size_t)row * N + u] = from_f<T>(cn);
        }
      }
    }
    if (!last) group_arrive(pl.counter);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) lstm_scan_bwd_kernel(const BwdArgs<T> a) {
  extern __shared__ float4 smem4[];
  const Plan& p = a.p;
  const int N = a.N, N4 = 4 * N, US = p.US;
  const Place pl(p, a.row0, a.nrows, N, a.bar);
  Smem<T> sm(reinterpret_cast<unsigned char*>(smem4), 1, N, p);
  const int ldc = round_up(N, 16) + pad<T>(), ldrr = N4 + pad<T>();
  if (sm.rc) stage_gate_cols<T>(sm.rc, ldc, a.R, N, pl.u0, US, pl.nu, 0, round_up(N, 16));
  if (sm.rr) stage_rows<T>(sm.rr, ldrr, a.R + (size_t)pl.u0 * N4, N4, US, pl.nu, 0, N4, N4);
  cp_async_wait<0>();
  float* dh_s = sm.s1;
  float* dc_s = sm.s2;
  for (int i = threadIdx.x; i < pl.nr * US; i += NT) {
    const int r = i / US, j = i % US;
    const size_t at = (size_t)(pl.rb + r) * N + pl.u0 + j;
    dh_s[i] = j < pl.nu ? to_f<T>(a.g_hT[at]) : 0.0f;
    dc_s[i] = j < pl.nu ? to_f<T>(a.g_cT[at]) : 0.0f;
  }
  __syncthreads();
  auto stage_cols = [&](T* dst, int ldd, int k0, int kc) {
    stage_gate_cols<T>(dst, ldd, a.R, N, pl.u0, US, pl.nu, k0, kc);
  };
  auto stage_rows_r = [&](T* dst, int ldd, int k0, int kc) {
    stage_rows<T>(dst, ldd, a.R + (size_t)pl.u0 * N4, N4, US, pl.nu, k0, kc, N4);
    cp_async_wait<0>();
  };
  // dh = r(dz of the step processed before).R^T for the block's units; a row
  // that step held as padding takes back the carry it parked in dh0 (each
  // element stays with the thread e % NT, here as in the gate loop)
  auto dh_product = [&](int n_done, int t_done) {
    group_wait(pl.counter, n_done * p.S);
    product<T>(a.dzx + ((size_t)t_done * a.B + pl.rb) * N4, N4, pl.Mp, pl.nr, N4, US, sm.rr,
               ldrr, stage_rows_r, sm.a, sm.a2, sm.bst, p.KC, sm.part, dh_s, US);
    if (!a.mask) return;
    for (int e = threadIdx.x; e < pl.nr * US; e += NT) {
      const int r = e / US, j = e % US;
      if (j < pl.nu && !a.mask[(size_t)t_done * a.B + pl.rb + r])
        dh_s[e] = a.dh0[(size_t)(pl.rb + r) * N + pl.u0 + j];
    }
  };
  int t_done = 0;
  for (int i = 0; i < a.Tn; ++i) {
    const int t = a.reverse ? i : a.Tn - 1 - i;
    // off the serial chain: z from hprev[t], which the forward saved
    product<T>(a.hprev + ((size_t)t * a.B + pl.rb) * N, N, pl.Mp, pl.nr, N, 4 * US, sm.rc, ldc,
               stage_cols, sm.a, sm.a2, sm.bst, p.KC, sm.part, sm.z, 4 * US);
    if (i > 0) dh_product(i, t_done);
    for (int e0 = threadIdx.x; e0 < pl.nr * US; e0 += EPT * NT) {
      float zxv[EPT][4], csv[EPT], ghv[EPT], cpv[EPT];
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int e = e0 + k * NT, r = e / US, j = e % US;
        if (e < pl.nr * US && j < pl.nu) {
          const size_t at = (size_t)t * a.B + pl.rb + r, u = pl.u0 + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) zxv[k][g] = to_f<T>(a.zx[at * N4 + g * N + u]);
          csv[k] = to_f<T>(a.cs[at * N + u]);
          ghv[k] = to_f<T>(a.g_hs[at * N + u]);
          cpv[k] = to_f<T>(a.cprev[at * N + u]);
        }
      }
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int e = e0 + k * NT, r = e / US, j = e % US;
        if (e >= pl.nr * US || j >= pl.nu) continue;
        const size_t at = (size_t)t * a.B + pl.rb + r;
        T* dz = a.dzx + at * N4 + pl.u0 + j;
        if (a.mask && !a.mask[at]) {
          // padding: no gradient enters z, dc stays, dh is parked in dh0
          // until the product below has overwritten the row
#pragma unroll
          for (int g = 0; g < 4; ++g) dz[g * N] = from_f<T>(0.0f);
          a.dh0[(size_t)(pl.rb + r) * N + pl.u0 + j] = dh_s[e];
          continue;
        }
        float ig, fg, gg, og;
        gates<T>(zxv[k], sm.z + (size_t)r * 4 * US, US, j, ig, fg, gg, og);
        const float th = tanhf(csv[k]);
        const float dh = ghv[k] + dh_s[e];
        const float dc = dc_s[e] + dh * og * (1.0f - th * th);
        const float d_o = dh * th;
        const float d_i = dc * gg;
        const float d_g = dc * ig;
        const float d_f = dc * cpv[k];
        dz[0] = from_f<T>(d_i * ig * (1.0f - ig));
        dz[N] = from_f<T>(d_f * fg * (1.0f - fg));
        dz[2 * N] = from_f<T>(d_g * (1.0f - gg * gg));
        dz[3 * N] = from_f<T>(d_o * og * (1.0f - og));
        dc_s[e] = dc * fg;
      }
    }
    group_arrive(pl.counter);
    t_done = t;
  }
  dh_product(a.Tn, t_done);
  for (int e = threadIdx.x; e < pl.nr * US; e += NT) {
    const int r = e / US, j = e % US;
    if (j >= pl.nu) continue;
    const size_t at = (size_t)(pl.rb + r) * N + pl.u0 + j;
    a.dh0[at] = dh_s[e];
    a.dc0[at] = dc_s[e];
  }
}

bool shapes_ok(int Tn, int B, int N) {
  return Tn >= 1 && B >= 1 && N >= 8 && N % 8 == 0 && N <= MAX_N;
}

template <typename T>
cudaError_t set_smem_limit(int kind, size_t smem) {
  return kind == 0 ? cudaFuncSetAttribute(lstm_scan_fwd_kernel<T>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                   : cudaFuncSetAttribute(lstm_scan_bwd_kernel<T>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t blocks_per_sm(int kind, size_t smem, int* n) {
  cudaError_t err = set_smem_limit<T>(kind, smem);
  if (err != cudaSuccess) return err;
  return kind == 0
             ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, lstm_scan_fwd_kernel<T>, NT, smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, lstm_scan_bwd_kernel<T>, NT, smem);
}

// Bytes a block brings in from L2 for one step of the plan: the rows of
// the group for each product, and whatever of R is not resident, which
// counts double (it is staged again for every chunk of every step, and the
// gate columns element by element).
template <typename T>
size_t step_bytes(int kind, int N, const Plan& p) {
  const size_t E = sizeof(T);
  size_t b = (size_t)p.BR * N * E;
  if (kind == 1) b += (size_t)p.BR * 4 * N * E;
  if (!(p.res & 1)) b += (size_t)2 * 4 * p.US * N * E;
  if (kind == 1 && !(p.res & 2)) b += (size_t)2 * p.US * 4 * N * E;
  return b;
}

// Choose the plan: among the unit slices whose S slices fit on the SMs
// (two blocks per SM where the occupancy query allows, else one), with the
// rows spread over as many groups as the remaining blocks allow, each way
// of keeping R resident and the longest reduction chunk that then fits in
// shared memory, the plan that brings the fewest bytes into a block per
// step (ties: the first, which keeps more resident). br, us > 0 impose the
// rows per group and units per slice (then the grid may exceed what can be
// co-resident, which the launch refuses).
template <typename T>
cudaError_t make_plan(int kind, int B, int N, int br, int us, Plan* out) {
  int dev, nsm, limit;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if ((br && (br < 16 || br % 16)) || (us && (us < 8 || us % 8))) return cudaErrorInvalidValue;
  const int n8 = round_up(N, 8);
  const int widths[] = {n8, 128, 64, 32, 16, 8};
  const int res_k4[] = {1, 0}, res_k5[] = {3, 2, 1, 0};
  const int* resv = kind == 0 ? res_k4 : res_k5;
  const int nres = kind == 0 ? 2 : 4;
  const int kmax = round_up(kind == 0 ? N : 4 * N, 16);
  bool found = false;
  size_t best = 0;
  for (int ri = 0; ri < nres; ++ri) {
    for (int per_sm = 2; per_sm >= 1; --per_sm) {
      const int slots = nsm * per_sm;
      for (int wi = 0; wi < 6; ++wi) {
        const int US = us ? us : widths[wi];
        if (US > n8 || US > 128 || (wi > 0 && US == widths[0] && !us)) continue;
        const int S = ceil_div(N, US);
        if (!us && S > slots) continue;
        const int cap = MAX_OUT / (4 * US) / 16 * 16;   // rows a product can hold
        if (cap < 16) continue;
        const int gmax = max(1, slots / S);
        const int BR = br ? br : min(cap, round_up(ceil_div(B, gmax), 16));
        if (BR > cap) return cudaErrorInvalidValue;
        const int groups = ceil_div(B, BR);
        const int G = br ? groups : min(groups, gmax);
        for (int KC = min(kmax, 2048); KC >= 16; KC = KC > 16 ? round_up(KC / 2, 16) : 0) {
          const Plan p{BR, US, G, S, KC, resv[ri], G * BR};
          const size_t smem = plan_smem<T>(kind, N, p);
          if (smem > (size_t)limit) continue;
          int fit = 1;
          if (per_sm > 1 && (blocks_per_sm<T>(kind, smem, &fit) != cudaSuccess || fit < per_sm))
            continue;
          const size_t cost = step_bytes<T>(kind, N, p);
          if (!found || cost < best) {
            *out = p;
            best = cost;
            found = true;
          }
          break;
        }
        if (us) break;
      }
    }
  }
  return found ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, typename A>
cudaError_t launch(int kind, A args, int B, const Plan& p, cudaStream_t s) {
  int dev, nsm, per_sm = 0;
  const size_t smem = plan_smem<T>(kind, args.N, p);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm<T>(kind, smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (p.G * p.S > per_sm * nsm) return cudaErrorCooperativeLaunchTooLarge;
  for (int row0 = 0; row0 < B; row0 += p.rows) {
    args.row0 = row0;
    args.nrows = min(p.rows, B - row0);
    args.p = p;
    void* params[] = {&args};
    const int grid = ceil_div(args.nrows, p.BR) * p.S;
    err = kind == 0
              ? cudaLaunchCooperativeKernel(lstm_scan_fwd_kernel<T>, grid, NT, params, smem, s)
              : cudaLaunchCooperativeKernel(lstm_scan_bwd_kernel<T>, grid, NT, params, smem, s);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* zx, const void* R, const void* h0, const void* c0,
                       const void* mask, void* hs, void* cs, void* hT, void* cT, int* bar, int Tn,
                       int B, int N, int reverse, int br, int us, cudaStream_t s) {
  Plan p;
  cudaError_t err = make_plan<T>(0, B, N, br, us, &p);
  if (err != cudaSuccess) return err;
  FwdArgs<T> a{(const T*)zx, (const T*)R, (const T*)h0, (const T*)c0, (const uint8_t*)mask,
               (T*)hs, (T*)cs, (T*)hT, (T*)cT, bar, Tn, B, N, reverse, 0, 0, p};
  return launch<T>(0, a, B, p, s);
}

template <typename T>
cudaError_t launch_bwd(const void* g_hs, const void* g_hT, const void* g_cT, const void* zx,
                       const void* R, const void* hprev, const void* cprev, const void* cs,
                       const void* mask, void* dzx, void* dh0, void* dc0, int* bar, int Tn, int B,
                       int N, int reverse, int br, int us, cudaStream_t s) {
  Plan p;
  cudaError_t err = make_plan<T>(1, B, N, br, us, &p);
  if (err != cudaSuccess) return err;
  BwdArgs<T> a{(const T*)g_hs, (const T*)g_hT, (const T*)g_cT, (const T*)zx, (const T*)R,
               (const T*)hprev, (const T*)cprev, (const T*)cs, (const uint8_t*)mask, (T*)dzx,
               (float*)dh0, (float*)dc0, bar, Tn, B, N, reverse, 0, 0, p};
  return launch<T>(1, a, B, p, s);
}

}  // namespace

// the widest layer the kernels take
extern "C" int lstm_scan_max_width() { return MAX_N; }

// The plan a launch takes (kind 0: K4, 1: K5; dtype 0: float32, 1: bfloat16;
// br, us: 0 or imposed, as the launchers take them): out[] = G (row groups of
// one launch), S (unit slices), rows per group, units per slice, reduction
// chunk, what stays resident (bit 0: R's gate columns, bit 1: R's rows),
// dynamic shared memory in bytes, launches over the batch. Returns the CUDA
// error of the choice.
extern "C" int lstm_scan_plan(int kind, int dtype, int B, int N, int br, int us, int* out) {
  if (!shapes_ok(1, B, N) || (kind != 0 && kind != 1) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = dtype == 0 ? make_plan<float>(kind, B, N, br, us, &p)
                                     : make_plan<__nv_bfloat16>(kind, B, N, br, us, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.G;
  out[1] = p.S;
  out[2] = p.BR;
  out[3] = p.US;
  out[4] = p.KC;
  out[5] = p.res;
  out[6] = (int)(dtype == 0 ? plan_smem<float>(kind, N, p) : plan_smem<__nv_bfloat16>(kind, N, p));
  out[7] = ceil_div(B, p.rows);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. `mask`: null, or (T, B) bytes, 0 at a
// padded step. `bar`: ceil(B/16) ints, zero. br, us: 0 (the launcher's plan)
// or imposed rows per group and units per slice. Both return the CUDA error of
// the launch.
extern "C" int lstm_scan_fwd_launch(int dtype, const void* zx, const void* R, const void* h0,
                                    const void* c0, const void* mask, void* hs, void* cs,
                                    void* hT, void* cT, void* bar, int Tn, int B, int N,
                                    int reverse, int br, int us, void* stream) {
  if (!shapes_ok(Tn, B, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_fwd<float>(zx, R, h0, c0, mask, hs, cs, hT, cT, (int*)bar, Tn, B, N,
                                  reverse, br, us, s);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(zx, R, h0, c0, mask, hs, cs, hT, cT, (int*)bar, Tn, B,
                                          N, reverse, br, us, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lstm_scan_bwd_launch(int dtype, const void* g_hs, const void* g_hT,
                                    const void* g_cT, const void* zx, const void* R,
                                    const void* hprev, const void* cprev, const void* cs,
                                    const void* mask, void* dzx, void* dh0, void* dc0, void* bar,
                                    int Tn, int B, int N, int reverse, int br, int us,
                                    void* stream) {
  if (!shapes_ok(Tn, B, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_bwd<float>(g_hs, g_hT, g_cT, zx, R, hprev, cprev, cs, mask, dzx, dh0,
                                  dc0, (int*)bar, Tn, B, N, reverse, br, us, s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(g_hs, g_hT, g_cT, zx, R, hprev, cprev, cs, mask, dzx,
                                          dh0, dc0, (int*)bar, Tn, B, N, reverse, br, us, s);
  return (int)cudaErrorInvalidValue;
}
