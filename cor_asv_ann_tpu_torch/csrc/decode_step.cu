// K3: one fused decoder step over N hypothesis rows, for Hopper (sm_90a),
// float32 or bfloat16 weights; the attention window rows either gathered by
// the caller or read here by index into the encoder's rows.
//
// Replaces the JAX package's Pallas kernel ops/pallas_decode.py:
// _fused_step_kernel (fused_decode_step). With dt the weight dtype, t() a
// float32 value rounded to dt where it enters a product, fb (N, V) the softmax
// feedback, h1/c1/h2/c2 (N, W) float32 states, u_j and att_j (W and A values)
// the encoder rows of window position j of the row, visible (N, WIN), E (V, W),
// k1/r1 (W, 4W), k2 (W+A, 4W), r2 (W, 4W), W_a (W, W), v_a (W) in dt and b1, b2
// (4W), b_UW (W), b_v float32, per row:
//
//   x    = t(fb).E
//   z1   = t(x).k1 + t(h1).r1 + b1;     h1', c1' = gates(z1, c1)
//   wvec = t(h2).W_a + b_UW
//   s_j  = sum_n t(tanh(wvec + u_j))_n * v_a_n + b_v;  -1e30 where not visible
//   a    = softmax(s) * any(visible);   ctx = sum_j a_j * att_j
//   z2   = t([h1', ctx]).k2 + t(h2).r2 + b2;   h2', c2' = gates(z2, c2)
//   p    = softmax(t(h2').E^T)
//   gates(z, c): i, f, o = sigmoid, g = tanh (Keras order i, f, g, o),
//                c' = f*c + i*g, h' = o*tanh(c')
//
// with every sum, the gate math and both softmaxes in float32. Outputs p (N, V),
// h1', c1', h2', c2' (N, W) and a (N, WIN), all float32. Window rows: gathered,
// u_w (N, WIN, W) and att_w (N, WIN, A); or by index, u (L, T, W) and attended
// (L, T, A) with row n on line n / rows_per_line and position j reading the
// encoder row min(win_start[n] + j, T - 1).
//
// What bounds it on an H100: bytes in bfloat16 (the weights once, ~11 MB, the
// states and, gathered, 2*WIN*W values a row), operations in float32. The TPU
// kernel keeps every weight and a 32-row tile in VMEM; a Hopper block has
// 227 KB. What this design does about it: the step runs as six kernels on
// the stream, each with a grid of its own, so that every N fills the card:
//   prep       t(fb), t(h1), t(h2) into the scratch (elementwise);
//   xw         x = t(fb).E and wvec = t(h2).W_a + b_UW: row tiles x slices of
//              128 columns of either product;
//   lstm (1)   z1 = [t(x), t(h1)].[k1; r1] and its gates: row tiles x slices
//              of US units (the 4*US gate columns their gate math needs);
//   attention  one warp a row: its WIN energies, the softmax and the context;
//   lstm (2)   z2 = [t(h1'), t(ctx), t(h2)].[k2; r2] and its gates;
//   readout    t(h2').E^T and the softmax over V, 64 rows a block.
// A product block owns BR rows (64, or 128 in bf16 where the grid stays a
// wave or more) and 128 output columns; its operands stream through shared
// memory by cp.async with NS - 1 chunks in flight (step_tile.cuh), bf16 on
// tensor cores (mma.sync m16n8k16 with ldmatrix.x4 fragments, float32
// accumulators), float32 on exact FMA in register tiles; so each weight comes
// from L2 once per tile of BR rows. The weights come pre-packed
// (ops/decode_step_kernel.py:pack_weights) as rows along the reduction: E^T
// and E padded to a multiple of 16 along V, W_a^T, and [k1; r1], [k2; r2] as
// gate-column-major blocks of US units, so that z1 and z2 are each one
// product over the concatenated reduction and the gates run in its epilogue
// per slice. The stage activations (t(fb), t(x), t(h1), t(h1'), t(ctx),
// t(h2), t(h2') in dt, wvec in float32) go to a scratch buffer of the
// wrapper's, in the order the products read them: each row's own, mostly
// L2-resident between the kernels.

#include "step_tile.cuh"

#include <math.h>

namespace {

using scan::CG;
using scan::from_f;
using scan::load8;
using scan::rnd;
using scan::to_f;
using scan::warp_sum;
using namespace scan::grid;
using namespace scan::tile;

constexpr int US = 32;         // units of an LSTM slice (the packing's, decode_step_kernel.py)
constexpr int NCOL = 4 * US;   // columns of a product block
constexpr int NS = 3;          // chunk buffers
constexpr int RB = 64;         // rows of a readout block
constexpr int EPT = 8;         // elements a thread of the prep kernel

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// widths of one launch, and where each activation sits in a scratch row
struct Dims {
  int N, V, Vp, W, Wp, A, WIN, BR;
  __host__ __device__ int fb() const { return 0; }
  __host__ __device__ int x() const { return Vp; }
  __host__ __device__ int h1() const { return Vp + W; }      // z1's operand: [x, h1]
  __host__ __device__ int h1n() const { return Vp + 2 * W; }  // z2's operand: [h1', ctx, h2]
  __host__ __device__ int ctx() const { return Vp + 3 * W; }
  __host__ __device__ int h2() const { return Vp + 3 * W + A; }
  __host__ __device__ int h2n() const { return Vp + 4 * W + A; }
  __host__ __device__ int width() const { return Vp + 5 * W + A; }
};

template <typename T> struct StepArgs {
  const float *fb, *h1, *c1, *h2, *c2;
  const unsigned char* visible;
  const T *ET, *z1w, *WaT, *z2w, *Ep, *va;
  const float *b1, *b2, *bUW, *b_v;
  float *probs, *h1o, *c1o, *h2o, *c2o, *align;
  T* act;      // scratch (N, d.width()) in dt
  float* wv;   // scratch (N, W): wvec
  Dims d;
};

// window rows gathered by the caller
template <typename U> struct Gathered {
  const U *u, *att;
  int WIN, W, A;
  __device__ const U* u_row(int n, int j) const { return u + ((size_t)n * WIN + j) * W; }
  __device__ const U* att_row(int n, int j) const { return att + ((size_t)n * WIN + j) * A; }
};

// window rows read by index into the encoder's rows
template <typename U> struct Indexed {
  const U *u, *att;
  const int* start;
  int rows_per_line, T, W, A;
  __device__ size_t enc_row(int n, int j) const {
    return (size_t)(n / rows_per_line) * T + min(start[n] + j, T - 1);
  }
  __device__ const U* u_row(int n, int j) const { return u + enc_row(n, j) * W; }
  __device__ const U* att_row(int n, int j) const { return att + enc_row(n, j) * A; }
};

// the block product of a product kernel: BR x NCOL on tensor cores (bf16) or
// FMA (float32)
template <typename T, int BR> struct Fast;
template <int BR> struct Fast<__nv_bfloat16, BR> {
  using type = WarpTile<BR, NCOL, BR / 32, false>;
};
template <int BR> struct Fast<float, BR> {
  using type = FmaTile<BR, NCOL, false>;
};

template <typename T> __host__ __device__ constexpr int chunk_ld() { return kc<T>() + pad<T>(); }

// dynamic shared memory of a product block: the chunk buffers, which the
// product's float32 result reuses
template <typename T> size_t product_smem(int BR) {
  const size_t stages = (size_t)NS * (BR + NCOL) * chunk_ld<T>() * sizeof(T);
  const size_t out = (size_t)BR * NCOL * sizeof(float);
  return stages > out ? stages : out;
}

template <typename T> size_t readout_smem(const Dims& d) {
  return (size_t)NS * (RB + NCOL) * chunk_ld<T>() * sizeof(T) +
         ((size_t)RB * d.Vp + part_floats<T>()) * sizeof(float);
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

// out (BR x NCOL float32, at the start of shared memory, row stride NCOL) =
// rows b0 .. b0+BR of the scratch from column a0, K wide (zero beyond nr
// rows), times rows of B (row-major, K wide; zero beyond nc rows). Ends with
// the block synchronised.
template <typename T, int BR>
__device__ __forceinline__ void tile_product(float4* smem, const T* __restrict__ act, int width,
                                             int b0, int nr, int a0, int K,
                                             const T* __restrict__ B, int nc) {
  constexpr int KC = kc<T>(), ld = chunk_ld<T>();
  T* abuf = reinterpret_cast<T*>(smem);
  T* bbuf = abuf + (size_t)NS * BR * ld;
  const T* a_src = act + (size_t)b0 * width + a0;
  typename Fast<T, BR>::type acc(ld, ld);
  pipeline<NS>(
      ceil_div(K, KC),
      [&](int c, int buf) {
        copy_rows<T>(abuf + (size_t)buf * BR * ld, ld, a_src, width, BR, nr, c * KC, KC, K, true);
        copy_rows<T>(bbuf + (size_t)buf * NCOL * ld, ld, B, K, NCOL, nc, c * KC, KC, K, true);
      },
      [&](int c, int buf) {
        acc.template chunk<KC>(abuf + (size_t)buf * BR * ld, bbuf + (size_t)buf * NCOL * ld);
      });
  acc.store(reinterpret_cast<float*>(smem), NCOL);
  __syncthreads();
}

// t(fb) (zero beyond V), t(h1), t(h2) into the scratch, EPT elements a thread
template <typename T>
__global__ void __launch_bounds__(NT) step_prep_kernel(const StepArgs<T> a) {
  const Dims& d = a.d;
  const size_t n_fb = (size_t)d.N * d.Vp, n = n_fb + (size_t)d.N * d.W, width = d.width();
  const size_t i0 = (size_t)blockIdx.x * NT * EPT + threadIdx.x;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const size_t i = i0 + (size_t)e * NT;
    if (i >= n) break;
    if (i < n_fb) {
      const size_t row = i / d.Vp;
      const int v = (int)(i % d.Vp);
      a.act[row * width + v] = from_f<T>(v < d.V ? a.fb[row * d.V + v] : 0.0f);
    } else {
      const size_t j = i - n_fb, row = j / d.W;
      const int k = (int)(j % d.W);
      a.act[row * width + d.h1() + k] = from_f<T>(a.h1[j]);
      a.act[row * width + d.h2() + k] = from_f<T>(a.h2[j]);
    }
  }
}

// x = t(fb).E into the scratch as t(x), and wvec = t(h2).W_a + b_UW: a block
// for each row tile and slice of NCOL columns of either product
template <typename T, int BR>
__global__ void __launch_bounds__(NT, 2) step_xw_kernel(const StepArgs<T> a) {
  extern __shared__ float4 smem4[];
  const Dims& d = a.d;
  const int W = d.W, width = d.width(), jobs = ceil_div(W, NCOL);
  const int tile = blockIdx.x / (2 * jobs), job = blockIdx.x % (2 * jobs);
  const bool wv = job >= jobs;
  const int c0 = (job % jobs) * NCOL, nc = min(NCOL, W - c0);
  const int b0 = tile * BR, nr = min(BR, d.N - b0);
  tile_product<T, BR>(smem4, a.act, width, b0, nr, wv ? d.h2() : d.fb(), wv ? W : d.Vp,
                      wv ? a.WaT + (size_t)c0 * W : a.ET + (size_t)c0 * d.Vp, nc);
  const float* out = reinterpret_cast<const float*>(smem4);
  for (int i = threadIdx.x; i < nr * nc; i += NT) {
    const int r = i / nc, c = i % nc;
    const size_t row = b0 + r;
    if (wv)
      a.wv[row * W + c0 + c] = out[r * NCOL + c] + a.bUW[c0 + c];
    else
      a.act[row * width + d.x() + c0 + c] = from_f<T>(out[r * NCOL + c]);
  }
}

// an LSTM stage (1: z1 from [t(x), t(h1)], 2: z2 from [t(h1'), t(ctx), t(h2)])
// for a row tile and a slice of US units, and its Keras gates: the new states
// to global memory, t(h') to the scratch
template <typename T, int BR>
__global__ void __launch_bounds__(NT, 2) step_lstm_kernel(const StepArgs<T> a, int stage) {
  extern __shared__ float4 smem4[];
  const Dims& d = a.d;
  const int W = d.W, width = d.width(), slices = d.Wp / US;
  const int tile = blockIdx.x / slices, s = blockIdx.x % slices;
  const int b0 = tile * BR, nr = min(BR, d.N - b0);
  const int K = stage == 1 ? 2 * W : 2 * W + d.A;
  tile_product<T, BR>(smem4, a.act, width, b0, nr, stage == 1 ? d.x() : d.h1n(), K,
                      (stage == 1 ? a.z1w : a.z2w) + (size_t)s * NCOL * K, NCOL);
  const float* out = reinterpret_cast<const float*>(smem4);
  const float* bias = stage == 1 ? a.b1 : a.b2;
  const float* c_in = stage == 1 ? a.c1 : a.c2;
  float* h_out = stage == 1 ? a.h1o : a.h2o;
  float* c_out = stage == 1 ? a.c1o : a.c2o;
  const int col = stage == 1 ? d.h1n() : d.h2n();
  for (int i = threadIdx.x; i < nr * US; i += NT) {
    const int r = i / US, j = i % US, u = s * US + j;
    if (u >= W) continue;
    const size_t row = b0 + r;
    const float* z = out + (size_t)r * NCOL + j;
    const float ig = sigmoidf(z[0] + bias[u]);
    const float fg = sigmoidf(z[US] + bias[W + u]);
    const float gg = tanhf(z[2 * US] + bias[2 * W + u]);
    const float og = sigmoidf(z[3 * US] + bias[3 * W + u]);
    const float cn = fg * c_in[row * W + u] + ig * gg;
    const float hn = og * tanhf(cn);
    h_out[row * W + u] = hn;
    c_out[row * W + u] = cn;
    a.act[row * width + col + u] = from_f<T>(hn);
  }
}

// attention, one warp a row: the WIN energies, the softmax over the window
// (zero where no position is visible) and the context into the scratch
template <typename T, typename U, class Win>
__global__ void __launch_bounds__(NT) step_attention_kernel(const StepArgs<T> a, const Win win) {
  extern __shared__ float4 smem4[];
  const Dims& d = a.d;
  const int W = d.W, A = d.A, WIN = d.WIN, width = d.width();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * NW + warp;
  if (n >= d.N) return;
  float* sw = reinterpret_cast<float*>(smem4) + (size_t)warp * 2 * WIN;
  float* aw = sw + WIN;
  const float* wv = a.wv + (size_t)n * W;
  const float bv = *a.b_v;
  for (int j = 0; j < WIN; ++j) {
    const U* u_row = win.u_row(n, j);
    float acc = 0.0f;
    for (int g = lane; g < W / CG; g += 32) {
      float uu[CG], vv[CG];
      load8(u_row + g * CG, uu);
      load8(a.va + g * CG, vv);
      const float4 w0 = *reinterpret_cast<const float4*>(wv + g * CG);
      const float4 w1 = *reinterpret_cast<const float4*>(wv + g * CG + 4);
      const float ww[CG] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int c = 0; c < CG; ++c) acc = fmaf(rnd<T>(tanhf(ww[c] + uu[c])), vv[c], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) sw[j] = a.visible[(size_t)n * WIN + j] ? acc + bv : -1e30f;
  }
  __syncwarp();
  float m = -INFINITY, sum = 0.0f;
  bool any = false;
  for (int j = 0; j < WIN; ++j) {
    m = fmaxf(m, sw[j]);
    any = any || a.visible[(size_t)n * WIN + j];
  }
  for (int j = 0; j < WIN; ++j) sum += expf(sw[j] - m);
  for (int j = lane; j < WIN; j += 32) {
    const float al = any ? expf(sw[j] - m) / sum : 0.0f;
    aw[j] = al;
    a.align[(size_t)n * WIN + j] = al;
  }
  __syncwarp();
  for (int k = lane * CG; k < A; k += 32 * CG) {
    float acc[CG] = {};
    for (int j = 0; j < WIN; ++j) {
      float at[CG];
      load8(win.att_row(n, j) + k, at);
      const float al = aw[j];
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[c] = fmaf(al, at[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) a.act[(size_t)n * width + d.ctx() + k + c] = from_f<T>(acc[c]);
  }
}

// logits = t(h2').E^T over the padded V for RB rows, then the softmax over
// the first V, one warp a row
template <typename T>
__global__ void __launch_bounds__(NT) step_readout_kernel(const StepArgs<T> a) {
  extern __shared__ float4 smem4[];
  const Dims& d = a.d;
  constexpr int KC = kc<T>(), ld = chunk_ld<T>();
  const int W = d.W, V = d.V, Vp = d.Vp, width = d.width();
  const int b0 = blockIdx.x * RB, nr = min(RB, d.N - b0), M = round_up(nr, 16);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* abuf = reinterpret_cast<T*>(smem4);
  T* bbuf = abuf + (size_t)NS * RB * ld;
  float* lg = reinterpret_cast<float*>(bbuf + (size_t)NS * NCOL * ld);  // [RB][Vp]
  float* part = lg + (size_t)RB * Vp;
  const T* a_src = a.act + (size_t)b0 * width + d.h2n();
  for (int c0 = 0; c0 < Vp; c0 += NCOL) {
    const int nc = min(NCOL, Vp - c0);
    const T* B = a.Ep + (size_t)c0 * W;
    TileProduct<T> acc(M, nc);
    pipeline<NS>(
        ceil_div(W, KC),
        [&](int c, int buf) {
          copy_rows<T>(abuf + (size_t)buf * RB * ld, ld, a_src, width, M, nr, c * KC, KC, W, true);
          copy_rows<T>(bbuf + (size_t)buf * NCOL * ld, ld, B, W, nc, nc, c * KC, KC, W, true);
        },
        [&](int c, int buf) {
          acc.chunk(abuf + (size_t)buf * RB * ld, ld, bbuf + (size_t)buf * NCOL * ld, ld, KC);
        });
    acc.finish(lg + c0, Vp, part);
  }
  for (int r = warp; r < nr; r += NW) {
    float* row = lg + (size_t)r * Vp;
    float m = -INFINITY;
    for (int v = lane; v < V; v += 32) m = fmaxf(m, row[v]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int v = lane; v < V; v += 32) {
      const float e = expf(row[v] - m);
      row[v] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int v = lane; v < V; v += 32) a.probs[(size_t)(b0 + r) * V + v] = row[v] / sum;
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return 0;
  return v;
}

// rows of a product tile: imposed (br > 0: 64, or 128 in bf16) or 128 in
// bf16 where the LSTM stages' grid still covers the SMs, else 64
int rows_per_tile(int wdtype, int N, int W, int br) {
  if (br > 0) return br == 64 || (br == 128 && wdtype == 1) ? br : 0;
  const int sms = imax(1, device_attr(cudaDevAttrMultiProcessorCount));
  const int slices = ceil_div(W, US);
  return wdtype == 1 && ceil_div(N, 128) * slices >= sms ? 128 : 64;
}

Dims dims(int N, int V, int W, int A, int WIN, int BR) {
  return Dims{N, V, round_up(V, 16), W, round_up(W, US), A, WIN, BR};
}

bool shapes_ok(int V, int W, int A, int WIN) {
  if (V < 1 || WIN < 1 || W < CG || A < CG || W % CG != 0 || A % CG != 0) return false;
  const size_t limit = (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const Dims d = dims(1, V, W, A, WIN, 128);
  return readout_smem<float>(d) <= limit && readout_smem<__nv_bfloat16>(d) <= limit &&
         product_smem<float>(64) <= limit && product_smem<__nv_bfloat16>(128) <= limit &&
         (size_t)2 * NW * WIN * sizeof(float) <= limit;
}

template <class K> cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int BR> cudaError_t launch_products(const StepArgs<T>& a, int stage,
                                                          cudaStream_t s) {
  const size_t smem = product_smem<T>(BR);
  const int tiles = ceil_div(a.d.N, BR);
  cudaError_t err;
  if (stage == 0) {
    if ((err = allow_smem(step_xw_kernel<T, BR>, smem)) != cudaSuccess) return err;
    const int blocks = tiles * 2 * ceil_div(a.d.W, NCOL);
    step_xw_kernel<T, BR><<<blocks, NT, smem, s>>>(a);
  } else {
    if ((err = allow_smem(step_lstm_kernel<T, BR>, smem)) != cudaSuccess) return err;
    const int blocks = tiles * (a.d.Wp / US);
    step_lstm_kernel<T, BR><<<blocks, NT, smem, s>>>(a, stage);
  }
  return cudaGetLastError();
}

template <typename T> cudaError_t products(const StepArgs<T>& a, int stage, cudaStream_t s) {
  if (a.d.BR == 128) return launch_products<T, 128>(a, stage, s);
  return launch_products<T, 64>(a, stage, s);
}
template <> cudaError_t products<float>(const StepArgs<float>& a, int stage, cudaStream_t s) {
  return launch_products<float, 64>(a, stage, s);
}

template <typename T, typename U, class Win>
cudaError_t launch(const StepArgs<T>& a, const Win& win, cudaStream_t s) {
  const Dims& d = a.d;
  cudaError_t err;
  const size_t elems = (size_t)d.N * (d.Vp + d.W);
  const int prep_blocks = (int)((elems + (size_t)NT * EPT - 1) / ((size_t)NT * EPT));
  step_prep_kernel<T><<<prep_blocks, NT, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = products<T>(a, 0, s)) != cudaSuccess) return err;
  if ((err = products<T>(a, 1, s)) != cudaSuccess) return err;
  const size_t att_smem = (size_t)2 * NW * d.WIN * sizeof(float);
  if ((err = allow_smem(step_attention_kernel<T, U, Win>, att_smem)) != cudaSuccess) return err;
  step_attention_kernel<T, U, Win><<<ceil_div(d.N, NW), NT, att_smem, s>>>(a, win);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = products<T>(a, 2, s)) != cudaSuccess) return err;
  const size_t ro_smem = readout_smem<T>(d);
  if ((err = allow_smem(step_readout_kernel<T>, ro_smem)) != cudaSuccess) return err;
  step_readout_kernel<T><<<ceil_div(d.N, RB), NT, ro_smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, typename U>
cudaError_t launch_windows(const void* const* in, void* const* out, const Dims& d,
                           int rows_per_line, int T_enc, cudaStream_t s) {
  const StepArgs<T> a{(const float*)in[0],  (const float*)in[1],  (const float*)in[2],
                      (const float*)in[3],  (const float*)in[4],  (const unsigned char*)in[7],
                      (const T*)in[9],      (const T*)in[10],     (const T*)in[11],
                      (const T*)in[12],     (const T*)in[13],     (const T*)in[14],
                      (const float*)in[15], (const float*)in[16], (const float*)in[17],
                      (const float*)in[18], (float*)out[0],       (float*)out[1],
                      (float*)out[2],       (float*)out[3],       (float*)out[4],
                      (float*)out[5],       (T*)out[6],           (float*)out[7],
                      d};
  if (rows_per_line == 0)
    return launch<T, U>(a, Gathered<U>{(const U*)in[5], (const U*)in[6], d.WIN, d.W, d.A}, s);
  return launch<T, U>(a,
                      Indexed<U>{(const U*)in[5], (const U*)in[6], (const int*)in[8],
                                 rows_per_line, T_enc, d.W, d.A},
                      s);
}

}  // namespace

// whether the kernels take these widths (W and A multiples of 8, the
// largest blocks' shared memory within a block's)
extern "C" int decode_step_supported(int V, int W, int A, int WIN) {
  return shapes_ok(V, W, A, WIN) ? 1 : 0;
}

// the rows of a product tile a launch over N rows of width W takes in the
// weights' type (br > 0: imposed), 0 if refused
extern "C" int decode_step_rows_per_tile(int wdtype, int N, int W, int br) {
  return N < 1 || (wdtype != 0 && wdtype != 1) ? 0 : rows_per_tile(wdtype, N, W, br);
}

// wdtype: the weights' type, udtype: the type of the window rows (0 = float32,
// 1 = bfloat16). `in`: fb, h1, c1, h2, c2, u, att, visible, win_start, E^T,
// [k1; r1], W_a^T, [k2; r2], E (padded), v_a, b1, b2, b_UW, b_v (the packed
// matrices of pack_weights); `out`: probs, h1, c1, h2, c2, align, then the
// scratch: (N, Vp + 5W + A) in the weights' type and wvec (N, W) float32.
// rows_per_line 0: u, att are the gathered (N, WIN, W), (N, WIN, A) and
// win_start is not read; else u, att are (L, T, W), (L, T, A) and the rows are
// read by index. br: rows of a product tile (0: picked here). Returns the
// first CUDA error of the six launches.
extern "C" int decode_step_launch(int wdtype, int udtype, const void* const* in,
                                  void* const* out, int N, int V, int W, int A, int WIN,
                                  int rows_per_line, int T_enc, int br, void* stream) {
  const int BR = N < 1 || (wdtype != 0 && wdtype != 1) ? 0 : rows_per_tile(wdtype, N, W, br);
  if (BR == 0 || !shapes_ok(V, W, A, WIN) || rows_per_line < 0 ||
      (rows_per_line > 0 && T_enc < 1))
    return (int)cudaErrorInvalidValue;
  const Dims d = dims(N, V, W, A, WIN, BR);
  cudaStream_t s = (cudaStream_t)stream;
  if (wdtype == 0 && udtype == 0)
    return (int)launch_windows<float, float>(in, out, d, rows_per_line, T_enc, s);
  if (wdtype == 0 && udtype == 1)
    return (int)launch_windows<float, __nv_bfloat16>(in, out, d, rows_per_line, T_enc, s);
  if (wdtype == 1 && udtype == 0)
    return (int)launch_windows<__nv_bfloat16, float>(in, out, d, rows_per_line, T_enc, s);
  if (wdtype == 1 && udtype == 1)
    return (int)launch_windows<__nv_bfloat16, __nv_bfloat16>(in, out, d, rows_per_line, T_enc, s);
  return (int)cudaErrorInvalidValue;
}
