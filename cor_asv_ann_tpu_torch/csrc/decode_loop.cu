// K1: the whole greedy decode loop of a depth-2 attention model, for Hopper
// (sm_90a), bfloat16 weights: one cooperative launch per tile of up to 16
// lines, the tile's steps all inside it.
//
// Replaces the JAX package's Pallas kernel ops/pallas_decode_loop.py:_kernel
// (decode_greedy_fused). Per step of a line: x = r(fb.E); LSTM 1; dense
// window-masked additive attention; the attention LSTM cell over
// [h1, r(ctx)]; the tied softmax readout; argmax over indices >= 1 with
// lowest-index ties; newline / S-step stop; score += -log(max(p, 1e-30)).
// Rounding points mirror _kernel: every matrix product is accumulated in
// float32 and rounded to bf16, the z sums are taken in bf16, gates run in
// float32 and are rounded to bf16 at the state boundary, the energies are
// float32 plus b_v with a float32 softmax, the alignment is multiplied by
// any(keep) and rounded to bf16, ctx is a float32 sum rounded to bf16 at the
// cell input, the logits and their softmax are float32 and the probs are
// rounded to bf16. The plain twin is
// ops/decode_loop_kernel.py:decode_loop_reference.
//
// What bounds it on an H100: latency. A line's step is ~5.5 M multiply-adds
// against ~11 MB of weights (W = A = 512), and each step hangs on the one
// before; the TPU kernel kept the weights resident in 16 MB of VMEM. What
// this design does about it: the weights are spread over the SMs and stay
// in shared memory for the whole launch, so they cross HBM/L2 once a call,
// not once a step. A launch has three kinds of blocks, one an SM:
// - unit blocks (blockIdx < units), each owning US units of W: the 4*US
//   gate columns of k1, r1, k2 and r2 and US columns of W_a, kept [k][c]
//   (32 bytes of padding every 8 rows, so that ldmatrix.trans reads them
//   without bank conflicts). Their products take the tile's 16 lines as
//   one mma.sync m16n8k16 row tile (float32 accumulators, the reduction
//   split over the warps and the warps' sums added in warp order), with A's
//   rows read from L2 straight into registers, and the Keras gates in the
//   epilogue;
// - attention blocks, each owning lines of the tile: the energies of the
//   +-ww window rows of u, their softmax and ctx over the window rows of
//   attended (both prefetched into shared memory by cp.async while the
//   unit blocks run (b)), 2*ww+1 alignment values kept for the next window;
// - readout blocks, as many, with E resident: the logits, the softmax, the
//   pick, the bookkeeping and the next step's x = r(fb.E).
// What one block writes for the others goes through small exchange buffers
// in global memory (h1 in two copies by step parity, h2, x, wvec, ctx, the
// lines' done flags), and the blocks meet at four counters (scan_grid.cuh's
// group_arrive/group_wait, zeroed by the wrapper, only growing). Step s:
//   (a) unit blocks: z1 = r(r(x.k1) + r(h1.r1)) + b1 (x from the readouts
//       of step s - 1: counter 3), the gates, h1n;
//       attention blocks: the attention (wvec from counter 2)  -> counter 0
//   (b) unit blocks: z2 = r(r([h1n | ctx].k2) + r(h2.r2)) + b2, the gates,
//       h2n, and r(h1n.r1) for the next (a) over the same rows -> counter 1
//   (c) unit blocks: wvec = r(r(h2n.W_a) + b_UW)               -> counter 2
//       then r(h2n.r2) for the next (b);
//       readout blocks: the readout of h2n                      -> counter 3
// so the attention of step s + 1 runs beside the readout of step s. Every
// block reads the lines' done flags after counter 3 of the step before, so
// they all stop at the same step. Sums run in a fixed order, with no
// atomics in any sum, so two launches give the same bits. The launcher picks
// US from W, A, V, the SM count and the shared memory a block may opt in to,
// for as many line blocks (up to an attention and a readout block a line)
// as the SMs left over allow; a grid that cannot be co-resident is refused,
// and the wrapper raises.

#include "step_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using scan::load8;
using scan::warp_sum;
using namespace scan::grid;
using scan::tile::ldmatrix_x4;

constexpr int ROWS = 16;       // lines of a tile: one mma row tile
constexpr int MAX_US = 16;     // units of a unit block
constexpr int MAX_T = 1 << 16; // positions: a.t of t0's sum is exact in float32
constexpr int ECOL = 256;      // columns of an energy item: a warp, 8 a lane
constexpr float NEG = -1e30f;

__device__ __forceinline__ float r16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A load past L1 of what another block of the grid wrote since the last
// meeting (a host compiler has a stand-in)
template <typename V> __device__ __forceinline__ V ld_cg(const V* p) {
#ifdef __CUDACC__
  return __ldcg(p);
#else
  return ld_cg_standin(p);
#endif
}

__host__ __device__ inline int window_max(int ww) { return 2 * ww + 1; }

// element offset of row k of a [k][c] weight slice: ld per row and 16 more
// every 8 rows, so that the 8 rows an ldmatrix.trans reads (k, k+1, k+8,
// k+9, ... below) fall on distinct banks (ld / 8 odd)
__host__ __device__ inline int brow(int k, int ld) { return k * ld + (k >> 3) * 16; }
__host__ __device__ inline size_t slice_bytes(int K32, int ld) {
  return (size_t)round_up(brow(K32, ld), 8) * sizeof(bf16);
}
// a row stride of whole 16-byte pieces, an odd number of them
__host__ __device__ inline int odd_ld(int cols) { return (cols / 8) % 2 ? cols : cols + 8; }

struct Plan {
  int US, units, LB, LPB;  // units a unit block, unit blocks, attention blocks (as many readout
                           // blocks), lines of each
  int NC, ldb, NCA, ldba;  // gate columns (4 US, whole n8 tiles), W_a columns, their row strides
  int K32, K32c, PI;       // reductions of W and W + A padded to 32; product tiles a reduction pass
  int WM, P, NPF;          // window positions, energy items a position, windows prefetched
};

// dynamic shared memory of a unit block, an attention block and a readout
// block, in bytes, in the order the blocks take it
__host__ __device__ inline size_t unit_smem(const Plan& p) {
  return 3 * slice_bytes(p.K32, p.ldb) + slice_bytes(p.K32, p.ldba) +
         slice_bytes(p.K32c, p.ldb) + (size_t)NW * p.PI * 128 * 4 +
         (size_t)4 * ROWS * p.NC * 4 + (size_t)2 * ROWS * p.US * 4;
}
__host__ __device__ inline size_t attention_smem(const Plan& p, int W, int A) {
  return (size_t)p.NPF * p.WM * (W + A) * sizeof(bf16) + (size_t)2 * W * sizeof(bf16) +
         (size_t)round_up(p.WM * p.P, 4) * 4 + round_up(p.WM, 4) * 4 +
         (size_t)2 * round_up(p.LPB * p.WM, 4) * 4 + (size_t)p.LPB * 4 * 4;
}
__host__ __device__ inline size_t readout_smem(const Plan& p, int W, int V) {
  return (size_t)round_up(V * W, 8) * sizeof(bf16) + (size_t)W * sizeof(bf16) +
         round_up(V, 4) * 4 + (size_t)4 * W * 4 + (size_t)p.LPB * 5 * 4;
}
__host__ __device__ inline size_t plan_smem(const Plan& p, int W, int A, int V) {
  const size_t u = unit_smem(p), at = attention_smem(p, W, A), ro = readout_smem(p, W, V);
  return u > at ? (u > ro ? u : ro) : (at > ro ? at : ro);
}

struct Args {
  const bf16 *att, *u, *h1, *c1, *h2, *c2;  // the tile's lines
  const int *live, *mask;
  const bf16 *E, *k1, *r1, *b1, *k2, *r2, *b2, *Wa, *va, *bUW, *bv;
  int* out_idx;
  float* out_prob;
  int* out_len;
  float* out_score;
  // exchange: h1 (2 x [16][W], by step parity), h2, x, wvec ([16][W]), ctx ([16][A])
  bf16 *h1x, *h2x, *xx, *wx, *cx;
  int* done_x;  // [16]
  int* bar;     // 3 counters, zero at the launch
  int L, T, W, A, V, S, ww, newline;
  Plan p;
};

// ---------------------------------------------------------------- unit blocks

// rows r < rows of [p0 (K0 columns) | p1 (K1 columns)], zero elsewhere, as
// 16-byte pieces (k % 8 == 0) read past L1
struct ARows {
  const bf16* p0;
  int ld0, K0;
  const bf16* p1;
  int ld1, K1;
  __device__ __forceinline__ uint4 piece(int r, int k, int rows) const {
    if (r < rows) {
      if (k < K0) return ld_cg(reinterpret_cast<const uint4*>(p0 + (size_t)r * ld0 + k));
      if (k < K0 + K1)
        return ld_cg(reinterpret_cast<const uint4*>(p1 + (size_t)r * ld1 + (k - K0)));
    }
    return uint4{0u, 0u, 0u, 0u};
  }
};

// A product of the block: out[r * ldo + c] (r < 16, c < 8 nt) = A . B over
// the first K32 (a multiple of 32) of A's columns, B a resident [k][c] slice.
struct Operand {
  const bf16* b;
  int ldb, nt;
  float* out;
  int ldo, K32;
};

// The products of NO operands over NA row sets A (NA = NO: operand o reads
// A[o]; NA = 1: every operand reads A[0]). Warp w takes the 32-deep
// blocks w, w + NW, ... of the reduction, 4 / NA at a time (at the
// flagship's widths all of them), their A pieces loaded before any mma: lane (g, q) holds A[g][8q .. 8q+7] and
// A[g+8][8q .. 8q+7] of a block, which are the fragments of two mma k-steps
// (k-step 0: 8q+{0,1} and 8q+{2,3}; k-step 1: 8q+{4,5} and 8q+{6,7}); the
// matching B fragments come from one ldmatrix.x4.trans whose lanes name the
// rows in that order. The warps' partial sums meet in `part` (NW x PI tiles)
// and are added in warp order. Starts and ends with the block synchronised.
template <int NA, int NO, int MT>
__device__ __forceinline__ void block_product(const ARows (&A)[NA], const Operand (&op)[NO],
                                              int K32, int rows, int PI, float* part) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  const int kl = 8 * ((lane & 7) >> 1) + 2 * (lane >> 3) + (lane & 1);  // this lane's ldmatrix row
  float acc[NO][MT][4];
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[o][t][e] = 0.0f;
  constexpr int KG = 4 / NA;  // 32-deep blocks a warp loads at once
  for (int kb0 = w * 32; kb0 < K32; kb0 += KG * NW * 32) {
    uint4 lo[NA][KG], hi[NA][KG];
#pragma unroll
    for (int x = 0; x < KG; ++x) {
      const int k = kb0 + x * NW * 32 + 8 * q;
#pragma unroll
      for (int s = 0; s < NA; ++s) {
        lo[s][x] = k < K32 ? A[s].piece(g, k, rows) : uint4{0u, 0u, 0u, 0u};
        hi[s][x] = k < K32 ? A[s].piece(g + 8, k, rows) : uint4{0u, 0u, 0u, 0u};
      }
    }
#pragma unroll
    for (int x = 0; x < KG; ++x) {
      const int kb = kb0 + x * NW * 32;
      if (kb >= K32) break;
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const int ai = NA == 1 ? 0 : o;
        if (kb >= op[o].K32) continue;
        const uint4 l = lo[ai][x], h = hi[ai][x];
        const uint32_t a0[4] = {l.x, h.x, l.y, h.y}, a1[4] = {l.z, h.z, l.w, h.w};
        const bf16* brow_k = op[o].b + brow(kb + kl, op[o].ldb);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          if (t >= op[o].nt) break;
          uint32_t b[4];
          ldmatrix_x4<true>(b, brow_k + 8 * t);
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
          mma_bf16_16816(acc[o][t], a0, b0);
          mma_bf16_16816(acc[o][t], a1, b1);
        }
      }
    }
  }
  // the warps' sums, PI tiles a pass, added in warp order
  int items = 0;
#pragma unroll
  for (int o = 0; o < NO; ++o) items += op[o].nt;
  for (int i0 = 0; i0 < items; i0 += PI) {
    int item = 0;
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (t >= op[o].nt) break;
        if (item >= i0 && item < i0 + PI)
          reinterpret_cast<float4*>(part)[((size_t)w * PI + item - i0) * 32 + lane] =
              make_float4(acc[o][t][0], acc[o][t][1], acc[o][t][2], acc[o][t][3]);
        ++item;
      }
    __syncthreads();
    const int n = min(PI, items - i0);
    for (int i = threadIdx.x; i < n * 128; i += NT) {
      float s = 0.0f;
      for (int v = 0; v < NW; ++v) s += part[((size_t)v * PI + i / 128) * 128 + i % 128];
      int it = i0 + i / 128;
      const bool second = NO > 1 && it >= op[0].nt;
      float* out = second ? op[NO - 1].out : op[0].out;
      const int ldo = second ? op[NO - 1].ldo : op[0].ldo;
      it -= second ? op[0].nt : 0;
      const int l = (i % 128) / 4, e = i % 4;
      out[(size_t)((l >> 2) + (e >> 1) * 8) * ldo + it * 8 + 2 * (l & 3) + (e & 1)] = s;
    }
    __syncthreads();
  }
}

// dst[brow(k, ld) + g * US + j] = M[k * ldm + g * gw + u0 + j] for k < K,
// g < G, j < nu (dst zero elsewhere beforehand): a thread keeps one column
// (g, j) and walks its rows, neighbouring threads on neighbouring columns
__device__ __forceinline__ void gather_cols(bf16* __restrict__ dst, int ld,
                                            const bf16* __restrict__ M, size_t ldm, int gw,
                                            int G, int K, int u0, int US, int nu) {
  constexpr int U = 16;  // loads in flight a thread
  const int cols = G * nu, rows = NT / cols, c = threadIdx.x % cols, r0 = threadIdx.x / cols;
  if (r0 >= rows) return;
  const bf16* src = M + (c / nu) * gw + u0 + c % nu;
  bf16* d = dst + (c / nu) * US + c % nu;
  for (int k0 = r0; k0 < K; k0 += U * rows) {
    bf16 v[U];
#pragma unroll
    for (int x = 0; x < U; ++x)
      if (k0 + x * rows < K) v[x] = src[(size_t)(k0 + x * rows) * ldm];
#pragma unroll
    for (int x = 0; x < U; ++x)
      if (k0 + x * rows < K) d[brow(k0 + x * rows, ld)] = v[x];
  }
}

// the LSTM cell of _kernel's `gates`: float32 gate math on the bf16 z, h and
// c rounded to bf16
__device__ __forceinline__ void cell(const float (&z)[4], float c_prev, float& h, float& c) {
  const float ig = sigmoid_f(z[0]), fg = sigmoid_f(z[1]), gg = tanhf(z[2]), og = sigmoid_f(z[3]);
  const float cn = fg * c_prev + ig * gg;
  h = r16(og * tanhf(cn));
  c = r16(cn);
}

// whether line threadIdx.x of the tile is still running at step s: from
// `live` before the first step, else from the done flag that the line's
// readout wrote before meeting 3 of step s - 1. Every block reads it after
// that meeting, so they all stop at the same step.
__device__ __forceinline__ int running(const Args& a, int s) {
  const int l = threadIdx.x;
  if (l >= a.L) return 0;
  return s == 0 ? a.live[l] != 0 : ld_cg(a.done_x + l) == 0;
}

template <int MT> __device__ void unit_block(const Args& a, unsigned char* sm) {
  const Plan& p = a.p;
  const int W = a.W, A = a.A, L = a.L, US = p.US, NC = p.NC;
  const int u0 = blockIdx.x * US, nu = min(US, W - u0), nt = NC / 8;
  auto take = [&](size_t bytes) { unsigned char* r = sm; sm += bytes; return r; };
  bf16* k1s = (bf16*)take(slice_bytes(p.K32, p.ldb));
  bf16* r1s = (bf16*)take(slice_bytes(p.K32, p.ldb));
  bf16* r2s = (bf16*)take(slice_bytes(p.K32, p.ldb));
  bf16* was = (bf16*)take(slice_bytes(p.K32, p.ldba));
  bf16* k2s = (bf16*)take(slice_bytes(p.K32c, p.ldb));
  float* part = (float*)take((size_t)NW * p.PI * 128 * 4);
  float* o0 = (float*)take((size_t)ROWS * NC * 4);
  float* o1 = (float*)take((size_t)ROWS * NC * 4);
  float* zh1 = (float*)take((size_t)ROWS * NC * 4);  // r(h1.r1) of the coming (a)
  float* zh2 = (float*)take((size_t)ROWS * NC * 4);  // r(h2.r2) of the coming (b)
  float* c1 = (float*)take((size_t)ROWS * US * 4);
  float* c2 = (float*)take((size_t)ROWS * US * 4);
  // the block's slices of the weights, resident for the launch
  {
    uint4* z = reinterpret_cast<uint4*>(k1s);
    const size_t n = (size_t)((bf16*)part - k1s) / 8;
    for (size_t i = threadIdx.x; i < n; i += NT) z[i] = uint4{0u, 0u, 0u, 0u};
  }
  __syncthreads();
  gather_cols(k1s, p.ldb, a.k1, (size_t)4 * W, W, 4, W, u0, US, nu);
  gather_cols(r1s, p.ldb, a.r1, (size_t)4 * W, W, 4, W, u0, US, nu);
  gather_cols(r2s, p.ldb, a.r2, (size_t)4 * W, W, 4, W, u0, US, nu);
  gather_cols(was, p.ldba, a.Wa, W, 0, 1, W, u0, US, nu);
  gather_cols(k2s, p.ldb, a.k2, (size_t)4 * W, W, 4, W + A, u0, US, nu);
  for (int i = threadIdx.x; i < ROWS * US; i += NT) {
    const int r = i / US, j = i % US;
    const bool in = r < L && j < nu;
    c1[i] = in ? __bfloat162float(a.c1[(size_t)r * W + u0 + j]) : 0.0f;
    c2[i] = in ? __bfloat162float(a.c2[(size_t)r * W + u0 + j]) : 0.0f;
  }
  __syncthreads();

  // (c), first this block's columns of wvec = r(r(h2.W_a) + b_UW), which the
  // attention blocks wait for, then r(h2.r2) for the next (b)
  auto wvec_product = [&](const bf16* h2) {
    const ARows src[1] = {{h2, W, W, nullptr, 0, 0}};
    const Operand op[1] = {{was, p.ldba, p.NCA / 8, o1, NC, p.K32}};
    block_product<1, 1, MT>(src, op, p.K32, L, p.PI, part);
    for (int i = threadIdx.x; i < L * nu; i += NT) {
      const int r = i / nu, j = i % nu;
      a.wx[(size_t)r * W + u0 + j] =
          __float2bfloat16_rn(r16(o1[r * NC + j]) + __bfloat162float(a.bUW[u0 + j]));
    }
  };
  auto zh2_product = [&](const bf16* h2) {
    const ARows src[1] = {{h2, W, W, nullptr, 0, 0}};
    const Operand op[1] = {{r2s, p.ldb, nt, o0, NC, p.K32}};
    block_product<1, 1, MT>(src, op, p.K32, L, p.PI, part);
    for (int i = threadIdx.x; i < ROWS * NC; i += NT) zh2[i] = r16(o0[i]);
  };

  wvec_product(a.h2);  // the step before the first
  group_arrive(a.bar + 2);
  zh2_product(a.h2);
  {
    const ARows src[1] = {{a.h1, W, W, nullptr, 0, 0}};
    const Operand op[1] = {{r1s, p.ldb, nt, o1, NC, p.K32}};
    block_product<1, 1, MT>(src, op, p.K32, L, p.PI, part);
    for (int i = threadIdx.x; i < ROWS * NC; i += NT) zh1[i] = r16(o1[i]);
  }
  for (int s = 0; s < a.S; ++s) {
    if (s > 0) group_wait(a.bar + 3, s * p.LB);  // x and the done flags of step s - 1
    if (!__syncthreads_or(running(a, s))) break;
    bf16* h1n = a.h1x + (size_t)((s + 1) & 1) * ROWS * W;
    {  // (a): LSTM 1
      const ARows src[1] = {{a.xx, W, s > 0 ? W : 0, nullptr, 0, 0}};
      const Operand op[1] = {{k1s, p.ldb, nt, o0, NC, p.K32}};
      block_product<1, 1, MT>(src, op, p.K32, L, p.PI, part);
      for (int i = threadIdx.x; i < L * nu; i += NT) {
        const int r = i / nu, j = i % nu;
        float z[4];
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) {
          const int at = r * NC + gt * US + j;
          z[gt] = r16(r16(r16(o0[at]) + zh1[at]) + __bfloat162float(a.b1[gt * W + u0 + j]));
        }
        float h, c;
        cell(z, c1[r * US + j], h, c);
        c1[r * US + j] = c;
        h1n[(size_t)r * W + u0 + j] = __float2bfloat16_rn(h);
      }
    }
    group_arrive(a.bar + 0);
    group_wait(a.bar + 0, (s + 1) * (p.units + p.LB));
    {  // (b): the attention cell over [h1n | ctx], and h1n.r1 for the next (a)
      const ARows src[1] = {{h1n, W, W, a.cx, A, A}};
      const Operand op[2] = {{k2s, p.ldb, nt, o0, NC, p.K32c}, {r1s, p.ldb, nt, o1, NC, p.K32}};
      block_product<1, 2, MT>(src, op, p.K32c, L, p.PI, part);
      for (int i = threadIdx.x; i < ROWS * NC; i += NT) zh1[i] = r16(o1[i]);
      for (int i = threadIdx.x; i < L * nu; i += NT) {
        const int r = i / nu, j = i % nu;
        float z[4];
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) {
          const int at = r * NC + gt * US + j;
          z[gt] = r16(r16(r16(o0[at]) + zh2[at]) + __bfloat162float(a.b2[gt * W + u0 + j]));
        }
        float h, c;
        cell(z, c2[r * US + j], h, c);
        c2[r * US + j] = c;
        a.h2x[(size_t)r * W + u0 + j] = __float2bfloat16_rn(h);
      }
    }
    group_arrive(a.bar + 1);
    group_wait(a.bar + 1, (s + 1) * p.units);
    wvec_product(a.h2x);  // (c)
    group_arrive(a.bar + 2);
    zh2_product(a.h2x);
  }
}

// ------------------------------------------------- attention and readout blocks

// the shared memory of an attention block (A) or a readout block (R)
struct LineSmem {
  bf16* E;                 // R: [V][W]
  bf16 *ur, *ar;           // A: [NPF][WM][W], [NPF][WM][A]: the rows of the lines' windows
  bf16 *va, *line;         // A: v_a; A: a line's wvec, R: its h2n
  float* lg;               // R: logits, then probs
  float *ep, *es, *aw;     // A: energy items; the window's energies, then alignment; [LPB][WM]
  float* xp;               // R: [4][W]: x's partial sums over four ranges of V
  int *kp, *st;            // A: [LPB][WM] visible (mask) flags; [LPB][4]: A: window start and
                           // size, R: done, length
  float* sc;               // R: [LPB] score
};

// a butterfly sum of N values over the warp, their shuffles interleaved
template <int N> __device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
}

// the window of a line at a step with centre t0 (none before the first
// step: t0 = 1): t0 - t is exact in float32, so this is _kernel's own test
// |t0 - t| <= ww on the positions around floor(t0); every thread alike
__device__ __forceinline__ void window(const Args& a, float t0, int& lo, int& cnt) {
  const int c = (int)floorf(t0), WM = a.p.WM;
  lo = 0;
  cnt = 0;
  for (int t = max(0, c - a.ww - 1); t <= min(a.T - 1, c + a.ww + 1); ++t)
    if (fabsf(t0 - (float)t) <= (float)a.ww && cnt < WM) {
      if (cnt == 0) lo = t;
      ++cnt;
    }
}

// the rows of line l's (its i-th) window, by cp.async into its slot of
// shared memory (one group, committed)
__device__ __forceinline__ void load_window(const Args& a, const LineSmem& m, int l, int i) {
  const int W = a.W, A = a.A, T = a.T, WM = a.p.WM, slot = i % a.p.NPF;
  const int lo = m.st[4 * i], cnt = m.st[4 * i + 1];
  const bf16* u = a.u + ((size_t)l * T + lo) * W;
  const bf16* att = a.att + ((size_t)l * T + lo) * A;
  for (int k = threadIdx.x; k < cnt * W / 8; k += NT)
    cp_async16(m.ur + (size_t)slot * WM * W + 8 * k, u + 8 * k, true);
  for (int k = threadIdx.x; k < cnt * A / 8; k += NT)
    cp_async16(m.ar + (size_t)slot * WM * A + 8 * k, att + 8 * k, true);
  cp_async_commit();
}

// line l's (its i-th) next window, from the alignment of its last one
// (none before the first step: t0 = 1), its mask flags and, for the lines
// that have a slot of their own, its rows: issued while the unit blocks
// run (b)
__device__ void prefetch(const Args& a, const LineSmem& m, int l, int i) {
  const int T = a.T, WM = a.p.WM;
  float t0 = 0.0f;  // sum a_t * t + 1 in float32 (the products are exact)
  for (int j = 0; j < m.st[4 * i + 1]; ++j) t0 = fmaf(m.aw[i * WM + j], (float)(m.st[4 * i] + j), t0);
  int lo, cnt;
  window(a, t0 + 1.0f, lo, cnt);
  for (int j = threadIdx.x; j < cnt; j += NT) m.kp[i * WM + j] = a.mask[(size_t)l * T + lo + j] > 0;
  __syncthreads();  // every thread has read the last window
  if (threadIdx.x == 0) {
    m.st[4 * i] = lo;
    m.st[4 * i + 1] = cnt;
  }
  __syncthreads();
  if (i < a.p.NPF) load_window(a, m, l, i);
}

// step s's attention of line l (its i-th) over the window prefetched for
// it: the energies of its visible rows, their softmax, ctx = r(sum
// a.attended), the alignment kept for the next window
__device__ void attention(const Args& a, const LineSmem& m, int l, int i) {
  const int W = a.W, A = a.A, WM = a.p.WM, P = a.p.P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cnt = m.st[4 * i + 1], slot = i % a.p.NPF;
  const bf16* ur = m.ur + (size_t)slot * WM * W;
  const bf16* ar = m.ar + (size_t)slot * WM * A;
  const int* kp = m.kp + i * WM;
  if (i >= a.p.NPF) load_window(a, m, l, i);  // a line without a slot of its own
  for (int k8 = tid; k8 < W / 8; k8 += NT)
    reinterpret_cast<uint4*>(m.line)[k8] = ld_cg(reinterpret_cast<const uint4*>(a.wx + (size_t)l * W) + k8);
  cp_async_wait<0>();
  __syncthreads();
  // the energies as items of ECOL columns of one position, a warp an item,
  // EI items at a time
  constexpr int EI = 3;
  for (int item0 = warp; item0 < cnt * P; item0 += EI * NW) {
    float e[EI];
#pragma unroll
    for (int x = 0; x < EI; ++x) {
      const int item = item0 + x * NW, pos = item / P, g8 = (item % P) * 32 + lane;
      e[x] = 0.0f;
      if (item < cnt * P && g8 < W / 8 && kp[pos]) {
        float uu[8], wq[8], vv[8];
        load8(ur + (size_t)pos * W + 8 * g8, uu);
        load8(m.line + 8 * g8, wq);
        load8(m.va + 8 * g8, vv);
#pragma unroll
        for (int q = 0; q < 8; ++q) e[x] = fmaf(r16(tanhf(r16(wq[q] + uu[q]))), vv[q], e[x]);
      }
    }
    warp_sums(e);
#pragma unroll
    for (int x = 0; x < EI; ++x)
      if (lane == 0 && item0 + x * NW < cnt * P) m.ep[item0 + x * NW] = e[x];
  }
  __syncthreads();
  if (warp == 0) {
    const float bv = __bfloat162float(*a.bv);
    float mx = NEG, kept = 0.0f;
    for (int j = lane; j < cnt; j += 32) {
      float sv = NEG;
      if (kp[j]) {
        sv = 0.0f;
        for (int qq = 0; qq < P; ++qq) sv += m.ep[j * P + qq];
        sv += bv;
        kept += 1.0f;
      }
      m.es[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = warp_max(mx);
    kept = warp_sum(kept);
    float sum = 0.0f;
    for (int j = lane; j < cnt; j += 32) {
      const float e = expf(m.es[j] - mx);
      m.es[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < cnt; j += 32) {
      const float al = kept > 0.0f ? r16(m.es[j] / sum) : 0.0f;
      m.es[j] = al;
      m.aw[i * WM + j] = al;
    }
  }
  __syncthreads();
  // ctx, two neighbouring columns a thread
  for (int k = 2 * tid; k < A; k += 2 * NT) {
    float c0 = 0.0f, c1 = 0.0f;
    for (int j = 0; j < cnt; ++j) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ar + (size_t)j * A + k));
      c0 = fmaf(m.es[j], v.x, c0);
      c1 = fmaf(m.es[j], v.y, c1);
    }
    __nv_bfloat162 o;
    o.x = __float2bfloat16_rn(c0);
    o.y = __float2bfloat16_rn(c1);
    *reinterpret_cast<__nv_bfloat162*>(a.cx + (size_t)l * A + k) = o;
  }
  __syncthreads();
}

// step s's readout of line l (its i-th): logits = h2n.E^T, the softmax, the
// pick over indices >= 1 (lowest on a tie), the outputs of an active line,
// and the next step's x = r(probs.E)
__device__ void readout(const Args& a, const LineSmem& m, int l, int i, int s) {
  const int W = a.W, V = a.V, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k8 = tid; k8 < W / 8; k8 += NT)
    reinterpret_cast<uint4*>(m.line)[k8] = ld_cg(reinterpret_cast<const uint4*>(a.h2x + (size_t)l * W) + k8);
  __syncthreads();
  // the logits, a warp a character, LI characters at a time
  constexpr int LI = 4;
  for (int v0 = warp; v0 < V; v0 += LI * NW) {
    float acc[LI];
#pragma unroll
    for (int x = 0; x < LI; ++x) {
      const int v = v0 + x * NW;
      acc[x] = 0.0f;
      if (v < V)
        for (int k8 = lane; k8 < W / 8; k8 += 32) {
          float e[8], h[8];
          load8(m.E + (size_t)v * W + 8 * k8, e);
          load8(m.line + 8 * k8, h);
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[x] = fmaf(h[q], e[q], acc[x]);
        }
    }
    warp_sums(acc);
#pragma unroll
    for (int x = 0; x < LI; ++x)
      if (lane == 0 && v0 + x * NW < V) m.lg[v0 + x * NW] = acc[x];
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
    for (int v = lane; v < V; v += 32) mx = fmaxf(mx, m.lg[v]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int v = lane; v < V; v += 32) {
      const float e = expf(m.lg[v] - mx);
      m.lg[v] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float best = -1.0f;
    int pick = V;
    for (int v = lane; v < V; v += 32) {
      const float pv = r16(m.lg[v] / sum);
      m.lg[v] = pv;
      if (v >= 1 && pv > best) {
        best = pv;
        pick = v;
      }
    }
    const float top = warp_max(best);
    int first = best == top ? pick : V;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
    if (lane == 0) {
      int* st = m.st + 4 * i;
      if (!st[2]) {
        a.out_idx[(size_t)l * a.S + s] = first;
        a.out_prob[(size_t)l * a.S + s] = top;
        st[3] += 1;
        m.sc[i] += -logf(fmaxf(top, 1e-30f));
        st[2] = first == a.newline;
      }
      a.done_x[l] = st[2];
    }
  }
  __syncthreads();
  // x = r(probs.E): a thread 8 neighbouring columns over a quarter of V,
  // the quarters added in order
  const int q4 = tid / 64, vq = (V + 3) / 4;
  for (int k8 = tid % 64; k8 < W / 8; k8 += 64) {
    float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int v = q4 * vq; v < min(V, (q4 + 1) * vq); ++v) {
      float e[8];
      load8(m.E + (size_t)v * W + 8 * k8, e);
      const float pv = m.lg[v];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] = fmaf(pv, e[q], acc[q]);
    }
    float4* xp = reinterpret_cast<float4*>(m.xp + q4 * W + 8 * k8);
    xp[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    xp[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();
  for (int k = tid; k < W; k += NT)
    a.xx[(size_t)l * W + k] =
        __float2bfloat16_rn(((m.xp[k] + m.xp[W + k]) + m.xp[2 * W + k]) + m.xp[3 * W + k]);
  __syncthreads();
}

// the lines of an attention or readout block: lb, lb + LB, ...
#define FOR_LINES(l, i) for (int l = lb, i = 0; l < a.L; l += p.LB, ++i)

__device__ void attention_block(const Args& a, unsigned char* sm) {
  const Plan& p = a.p;
  const int W = a.W, A = a.A, lb = blockIdx.x - p.units;
  auto take = [&](size_t bytes) { unsigned char* r = sm; sm += bytes; return r; };
  LineSmem m{};
  m.ur = (bf16*)take((size_t)p.NPF * p.WM * W * sizeof(bf16));
  m.ar = (bf16*)take((size_t)p.NPF * p.WM * A * sizeof(bf16));
  m.va = (bf16*)take((size_t)W * sizeof(bf16));
  m.line = (bf16*)take((size_t)W * sizeof(bf16));
  m.ep = (float*)take((size_t)round_up(p.WM * p.P, 4) * 4);
  m.es = (float*)take((size_t)round_up(p.WM, 4) * 4);
  m.aw = (float*)take((size_t)round_up(p.LPB * p.WM, 4) * 4);
  m.kp = (int*)take((size_t)round_up(p.LPB * p.WM, 4) * 4);
  m.st = (int*)take((size_t)p.LPB * 4 * 4);
  for (int k = threadIdx.x; k < W; k += NT) m.va[k] = a.va[k];
  FOR_LINES(l, i) if (threadIdx.x == 0) m.st[4 * i] = m.st[4 * i + 1] = 0;  // no window yet
  __syncthreads();
  FOR_LINES(l, i) prefetch(a, m, l, i);
  for (int s = 0; s < a.S; ++s) {
    group_wait(a.bar + 2, (s + 1) * p.units);  // wvec of step s
    FOR_LINES(l, i) attention(a, m, l, i);     // (a)
    if (s > 0) group_wait(a.bar + 3, s * p.LB);
    if (!__syncthreads_or(running(a, s))) break;
    group_arrive(a.bar + 0);
    FOR_LINES(l, i) prefetch(a, m, l, i);
  }
  cp_async_wait<0>();
}

__device__ void readout_block(const Args& a, unsigned char* sm) {
  const Plan& p = a.p;
  const int W = a.W, V = a.V, lb = blockIdx.x - p.units - p.LB;
  auto take = [&](size_t bytes) { unsigned char* r = sm; sm += bytes; return r; };
  LineSmem m{};
  m.E = (bf16*)take((size_t)round_up(V * W, 8) * sizeof(bf16));
  m.line = (bf16*)take((size_t)W * sizeof(bf16));
  m.lg = (float*)take((size_t)round_up(V, 4) * 4);
  m.xp = (float*)take((size_t)4 * W * 4);
  m.st = (int*)take((size_t)p.LPB * 4 * 4);
  m.sc = (float*)take((size_t)p.LPB * 4);
  for (int i = threadIdx.x; i < V * W / 8; i += NT)
    reinterpret_cast<uint4*>(m.E)[i] = reinterpret_cast<const uint4*>(a.E)[i];
  FOR_LINES(l, i)
  if (threadIdx.x == 0) {
    m.st[4 * i + 2] = a.live[l] == 0;
    m.st[4 * i + 3] = 0;
    m.sc[i] = 0.0f;
  }
  __syncthreads();
  for (int s = 0; s < a.S; ++s) {
    if (s > 0) group_wait(a.bar + 3, s * p.LB);
    if (!__syncthreads_or(running(a, s))) break;
    group_wait(a.bar + 1, (s + 1) * p.units);   // h2n of step s
    FOR_LINES(l, i) readout(a, m, l, i, s);     // (c)
    group_arrive(a.bar + 3);
  }
  if (threadIdx.x == 0) FOR_LINES(l, i) {
      a.out_len[l] = m.st[4 * i + 3];
      a.out_score[l] = m.sc[i];
    }
}

#undef FOR_LINES

template <int MT> __global__ void __launch_bounds__(NT) decode_loop_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  if ((int)blockIdx.x < a.p.units)
    unit_block<MT>(a, sm);
  else if ((int)blockIdx.x < a.p.units + a.p.LB)
    attention_block(a, sm);
  else
    readout_block(a, sm);
}

// ---------------------------------------------------------------- host side

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return 0;
  return v;
}

Plan plan_for(int US, int L, int W, int A, int ww, int nsm) {
  Plan p{};
  p.US = US;
  p.units = ceil_div(W, US);
  p.LB = min(L, (nsm - p.units) / 2);
  p.LPB = ceil_div(L, p.LB);
  p.NC = round_up(4 * US, 8);
  p.ldb = odd_ld(p.NC);
  p.NCA = round_up(US, 8);
  p.ldba = odd_ld(p.NCA);
  p.K32 = round_up(W, 32);
  p.K32c = round_up(W + A, 32);
  p.PI = 2 * p.NC / 8;
  p.WM = window_max(ww);
  p.P = ceil_div(W, ECOL);
  p.NPF = p.LPB;
  return p;
}

// The plan of a tile of L lines: us > 0 imposes the units a unit block, else
// the plan with the most line blocks (up to an attention and a readout
// block a line), then the fewest unit blocks (fewer arrivals at each
// meeting), then the fewest n8 tiles of gate columns. One block an SM; where a
// block's shared memory would not fit, the reduction passes shrink, then
// the attention blocks prefetch the windows of fewer of their lines.
bool make_plan(int L, int W, int A, int V, int ww, int us, Plan& out) {
  const int nsm = device_attr(cudaDevAttrMultiProcessorCount);
  const int limit = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  if (L < 1 || L > ROWS || W < 8 || W % 8 || A < 8 || A % 8 || V < 2 || ww < 1 || us < 0 ||
      us > MAX_US)
    return false;
  bool found = false;
  for (int US = us ? us : 1; US <= (us ? us : MAX_US); ++US) {
    if (ceil_div(W, US) > nsm - 2) continue;
    Plan p = plan_for(US, L, W, A, ww, nsm);
    while (p.PI > 1 && unit_smem(p) > (size_t)limit) --p.PI;
    while (p.NPF > 1 && attention_smem(p, W, A) > (size_t)limit) --p.NPF;
    if (plan_smem(p, W, A, V) > (size_t)limit) continue;
    if (!found || p.LB > out.LB ||
        (p.LB == out.LB && (p.units < out.units || (p.units == out.units && p.NC < out.NC)))) {
      out = p;
      found = true;
    }
  }
  return found;
}

template <int MT> cudaError_t launch_tile(const Args& a, cudaStream_t s) {
  const size_t smem = plan_smem(a.p, a.W, a.A, a.V);
  cudaError_t err = cudaFuncSetAttribute(decode_loop_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_loop_kernel<MT>, NT, smem);
  if (err != cudaSuccess) return err;
  const int grid = a.p.units + 2 * a.p.LB;
  if (grid > per_sm * device_attr(cudaDevAttrMultiProcessorCount))
    return cudaErrorCooperativeLaunchTooLarge;
  Args args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(decode_loop_kernel<MT>, grid, NT, params, smem, s);
}

}  // namespace

// The plan of a tile of L lines (us: 0 or imposed units a unit block): out[]
// = unit blocks, attention blocks (as many readout blocks), units a unit block, gate columns a unit block,
// product tiles a reduction pass, dynamic shared memory in bytes, the
// longest bucket T. Returns 0, or cudaErrorInvalidValue where no plan fits.
extern "C" int decode_loop_plan(int L, int W, int A, int V, int ww, int us, int* out) {
  Plan p{};
  if (!make_plan(L, W, A, V, ww, us, p)) return (int)cudaErrorInvalidValue;
  out[0] = p.units;
  out[1] = p.LB;
  out[2] = p.US;
  out[3] = p.NC;
  out[4] = p.PI;
  out[5] = (int)plan_smem(p, W, A, V);
  out[6] = MAX_T;
  return 0;
}

// in: att, u, h1, c1, h2, c2, live, mask, E, k1, r1, b1, k2, r2, b2, W_a,
// v_a, b_UW, b_v; out: idx (B, S), prob (B, S), length (B,), score (B,),
// zeroed by the caller (steps after a line's stop are not written); xch:
// bf16 exchange of 16 x (5 W + A); ints: 16 done flags, then 4 counters a
// tile of 16 lines, zeroed. Launches the tiles in turn on `stream`; returns
// the CUDA error of the first launch that fails, else cudaGetLastError().
extern "C" int decode_loop_launch(const void* const* in, void* const* out, void* xch, void* ints,
                                  int B, int T, int W, int A, int V, int S, int ww, int newline,
                                  int us, void* stream) {
  if (B < 0 || T < 1 || T > MAX_T || S < 0) return (int)cudaErrorInvalidValue;
  const bf16* const* w = reinterpret_cast<const bf16* const*>(in);
  bf16* x = static_cast<bf16*>(xch);
  int* iv = static_cast<int*>(ints);
  for (int row0 = 0; row0 < B; row0 += ROWS) {
    Args a{};
    a.L = min(ROWS, B - row0);
    if (!make_plan(a.L, W, A, V, ww, us, a.p)) return (int)cudaErrorInvalidValue;
    a.att = w[0] + (size_t)row0 * T * A;
    a.u = w[1] + (size_t)row0 * T * W;
    a.h1 = w[2] + (size_t)row0 * W;
    a.c1 = w[3] + (size_t)row0 * W;
    a.h2 = w[4] + (size_t)row0 * W;
    a.c2 = w[5] + (size_t)row0 * W;
    a.live = static_cast<const int*>(in[6]) + row0;
    a.mask = static_cast<const int*>(in[7]) + (size_t)row0 * T;
    a.E = w[8]; a.k1 = w[9]; a.r1 = w[10]; a.b1 = w[11]; a.k2 = w[12]; a.r2 = w[13];
    a.b2 = w[14]; a.Wa = w[15]; a.va = w[16]; a.bUW = w[17]; a.bv = w[18];
    a.out_idx = static_cast<int*>(out[0]) + (size_t)row0 * S;
    a.out_prob = static_cast<float*>(out[1]) + (size_t)row0 * S;
    a.out_len = static_cast<int*>(out[2]) + row0;
    a.out_score = static_cast<float*>(out[3]) + row0;
    a.h1x = x;
    a.h2x = x + (size_t)2 * ROWS * W;
    a.xx = x + (size_t)3 * ROWS * W;
    a.wx = x + (size_t)4 * ROWS * W;
    a.cx = x + (size_t)5 * ROWS * W;
    a.done_x = iv;
    a.bar = iv + ROWS + 4 * (row0 / ROWS);
    a.T = T; a.W = W; a.A = A; a.V = V; a.S = S; a.ww = ww; a.newline = newline;
    const cudaError_t err = a.p.NC <= 32 ? launch_tile<4>(a, (cudaStream_t)stream)
                                         : launch_tile<8>(a, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
