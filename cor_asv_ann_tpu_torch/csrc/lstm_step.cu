// K2: fused LSTM step for Hopper (sm_90a), float32 or bfloat16.
//
// Replaces the JAX package's Pallas kernel ops/pallas_lstm.py:
// _lstm_step_kernel (lstm_step_fused). Computes, for x (B, D), h/c (B, W),
// K (D, 4W), R (W, 4W), b (4W):
//     z = r(x.K) + r(h.R) + b        (sums in the weight dtype, left to right)
//     i, f, c~, o = sigmoid, sigmoid, tanh, sigmoid of the Keras gate blocks
//     c' = f*c + i*c~,  h' = o*tanh(c')
// where r() rounds a float32-accumulated product to the weight dtype. Every
// elementwise result is rounded to the weight dtype as it is produced, which
// is what PyTorch's (and XLA's) per-op bf16 arithmetic does in the plain twin
// ops/lstm.py:lstm_step; in float32 the rounding is the identity.
//
// What bounds it on an H100: operations in float32 (2*B*(D+W)*4W on FMA, no
// TF32: 0.024 ms at B=256, D=1024, W=512), bytes in bfloat16 (the weights,
// 6 MB there). What the design does about it: a block owns a tile of BR rows
// and a slice of US units, i.e. the 4*US gate columns of K and R that the
// gate math of its units needs, so the Keras gates run in the epilogue of the
// block's own products and only h' and c' leave it. The rows of x and h and
// the chunks of the gate columns come in by cp.async, NS - 1 chunks in flight
// under the product of one (step_tile.cuh); the weights stay row-major, as
// the caller passes them every step, and are read so: bf16 on tensor cores
// (mma.sync m16n8k16, fragments by ldmatrix.x4, B's .trans, float32
// accumulators), float32 on exact FMA in register tiles. x.K and h.R are two
// accumulations, each rounded on its own, as the plain version rounds them.
// The launcher picks BR and US from B, D, W and the SM count: the tile that
// covers the card in the fewest waves for the least time a wave, by a model
// of operations and bytes a block, among the tiles whose chunk buffers fit
// a block's shared memory. Tiles of 32 or 64 rows x 16 or 32 units (B=256:
// 64 x 16) run on products of a compile-time shape; greedy serving's
// B <= 16 takes 16 rows and narrow slices, whose product splits the
// reduction among the warps (TileKN).

#include "step_tile.cuh"

namespace {

using scan::from_f;
using scan::rnd;
using scan::to_f;
using namespace scan::grid;
using namespace scan::tile;

constexpr int NS = 3;  // chunk buffers
// reduction chunk: 512 bytes of a row (fewer barriers than step_tile's 128;
// tools/step_ablation.py times 128, 256 and 512)
template <typename T> __host__ __device__ constexpr int kc2() { return 512 / (int)sizeof(T); }

struct Plan {
  int BR, US, tiles, slices;
};

struct Args {
  const void *x, *h, *c, *K, *R, *b;
  void *h_out, *c_out;
  int B, D, W;
  bool vec_x, vec_h, vec_w;  // 16-byte copies of x's rows, h's rows, the gate columns
  Plan p;
};

// whether a tile runs on the compile-time products (fixed_tile) or TileKN
bool fixed_tile(int BR, int US) { return (BR == 64 || BR == 32) && (US == 32 || US == 16); }

// dynamic shared memory of a block, in bytes: the chunk buffers, and the two
// float32 products beside them (TileKN) or in them (fixed tiles)
template <typename T> size_t step_smem(const Plan& p) {
  const int P = pad<T>(), nc = 4 * p.US;
  const size_t stages =
      (size_t)NS * ((size_t)p.BR * (kc2<T>() + P) + (size_t)kc2<T>() * (nc + P)) * sizeof(T);
  const size_t z = (size_t)2 * p.BR * nc * sizeof(float);
  if (fixed_tile(p.BR, p.US)) return stages > z ? stages : z;
  return stages + z + (size_t)part_floats<T>() * sizeof(float);
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

// the Keras gates of the block's (row, unit) pairs from zx and zh ([BR][nc]
// float32 in shared memory), neighbouring threads on neighbouring units
template <typename T>
__device__ __forceinline__ void gates(const Args& a, const float* __restrict__ zx,
                                      const float* __restrict__ zh, int r0, int nr, int u0, int nu,
                                      int US) {
  const int nc = 4 * US;
  const T* bias = static_cast<const T*>(a.b);
  const T* c_in = static_cast<const T*>(a.c);
  T* h_out = static_cast<T*>(a.h_out);
  T* c_out = static_cast<T*>(a.c_out);
  for (int i = threadIdx.x; i < nr * US; i += NT) {
    const int r = i / US, j = i % US;
    if (j >= nu) continue;
    const int u = u0 + j;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int at = r * nc + g * US + j;
      z[g] = rnd<T>(rnd<T>(rnd<T>(zx[at]) + rnd<T>(zh[at])) + to_f<T>(bias[g * a.W + u]));
    }
    const float ig = rnd<T>(sigmoid_f(z[0]));
    const float fg = rnd<T>(sigmoid_f(z[1]));
    const float gg = rnd<T>(tanhf(z[2]));
    const float og = rnd<T>(sigmoid_f(z[3]));
    const size_t at = (size_t)(r0 + r) * a.W + u;
    const float cn = rnd<T>(rnd<T>(fg * to_f<T>(c_in[at])) + rnd<T>(ig * gg));
    const float hn = rnd<T>(og * rnd<T>(tanhf(cn)));
    h_out[at] = from_f<T>(hn);
    c_out[at] = from_f<T>(cn);
  }
}

// the block's products of a compile-time tile (BR rows x US units): bf16 on
// tensor cores, float32 on FMA, both reading the weights' chunks as [k][c]
template <typename T, int BR, int US> struct KnTile;
template <int BR, int US> struct KnTile<__nv_bfloat16, BR, US> {
  using type = WarpTile<BR, 4 * US, 2, true>;
};
template <int BR, int US> struct KnTile<float, BR, US> {
  using type = FmaTile<BR, 4 * US, true>;
};

// one chunk of KC on a compile-time tile; float32 with every k-step unrolled
template <int KC, int BR, int NC>
__device__ __forceinline__ void chunk_of(WarpTile<BR, NC, 2, true>& t, const __nv_bfloat16* a,
                                         const __nv_bfloat16* b) {
  t.template chunk<KC>(a, b);
}
template <int KC, int BR, int NC>
__device__ __forceinline__ void chunk_of(FmaTile<BR, NC, true>& t, const float* a, const float* b) {
  t.template chunk<KC, KC / 4>(a, b);
}

// BR, US > 0: a compile-time tile on the fast products; 0: the tile of the
// plan, on TileKN (any tile, the reduction split among warps where the tile
// has fewer outputs than the block has workers)
template <typename T, int BR_, int US_>
__global__ void __launch_bounds__(NT) lstm_step_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const Plan& p = a.p;
  constexpr bool fixed = BR_ > 0;
  const int BR = fixed ? BR_ : p.BR, US = fixed ? US_ : p.US;
  const int tile = blockIdx.x / p.slices, s = blockIdx.x % p.slices;
  const int r0 = tile * BR, nr = min(BR, a.B - r0), M = round_up(nr, 16);
  const int u0 = s * US, nu = min(US, a.W - u0), nc = 4 * US;
  constexpr int KC = kc2<T>();
  const int lda = KC + pad<T>(), ldb = nc + pad<T>();
  T* abuf = reinterpret_cast<T*>(smem4);          // NS x [BR][lda]: rows of x or h
  T* bbuf = abuf + (size_t)NS * BR * lda;          // NS x [KC][ldb]: gate columns
  const T* x = static_cast<const T*>(a.x);
  const T* h = static_cast<const T*>(a.h);
  const T* K = static_cast<const T*>(a.K);
  const T* R = static_cast<const T*>(a.R);
  const int cx = ceil_div(a.D, KC), ch = ceil_div(a.W, KC);

  // chunks 0 .. cx-1 reduce x.K, chunks cx .. cx+ch-1 reduce h.R
  auto issue = [&](int c, int buf) {
    const bool first = c < cx;
    const int Kd = first ? a.D : a.W, k0 = (first ? c : c - cx) * KC;
    copy_rows<T>(abuf + (size_t)buf * BR * lda, lda, (first ? x : h) + (size_t)r0 * Kd, Kd,
                 fixed ? BR : M, nr, k0, KC, Kd, first ? a.vec_x : a.vec_h);
    copy_gate_cols<T>(bbuf + (size_t)buf * KC * ldb, ldb, first ? K : R, a.W, u0, US, nu, k0, KC,
                      Kd, a.vec_w);
  };
  if constexpr (fixed) {
    // the two accumulations side by side, then both products over the
    // chunk buffers, which are free by then
    typename KnTile<T, BR_, US_>::type ax(lda, ldb), ah(lda, ldb);
    pipeline<NS>(cx + ch, issue, [&](int c, int buf) {
      const T* ab = abuf + (size_t)buf * BR * lda;
      const T* bb = bbuf + (size_t)buf * KC * ldb;
      if (c < cx)
        chunk_of<KC>(ax, ab, bb);
      else
        chunk_of<KC>(ah, ab, bb);
    });
    float* zx = reinterpret_cast<float*>(smem4);
    float* zh = zx + (size_t)BR * nc;
    ax.store(zx, nc);
    ah.store(zh, nc);
    __syncthreads();
    gates<T>(a, zx, zh, r0, nr, u0, nu, US);
  } else {
    float* zx = reinterpret_cast<float*>(bbuf + (size_t)NS * KC * ldb);  // [BR][nc]
    float* zh = zx + (size_t)BR * nc;
    float* part = zh + (size_t)BR * nc;
    TileKN<T> acc(M, nc);
    pipeline<NS>(cx + ch, issue, [&](int c, int buf) {
      acc.chunk(abuf + (size_t)buf * BR * lda, lda, bbuf + (size_t)buf * KC * ldb, ldb, KC);
      if (c == cx - 1) {
        acc.finish(zx, nc, part);
        acc = TileKN<T>(M, nc);
      }
    });
    acc.finish(zh, nc, part);
    gates<T>(a, zx, zh, r0, nr, u0, nu, US);
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return 0;
  return v;
}

// The tile of the launch: BR rows x US units, imposed (br, us > 0) or picked.
// A block's time is modelled as its FMAs (float32: 128 a clock; bf16 on
// mma.sync: ~1024) plus its bytes from L2 (~32 a clock), a launch's as the
// time of a block times the waves of blocks over the SMs (one block an SM).
template <typename T> bool make_plan(int B, int D, int W, int br, int us, Plan& p) {
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  const int smem = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  auto fits = [&](const Plan& q) {
    return q.BR % 16 == 0 && q.BR >= 16 && q.US * (int)sizeof(T) % 16 == 0 &&
           q.BR * 4 * q.US <= MAX_OUT && step_smem<T>(q) <= (size_t)smem;
  };
  if (br > 0 || us > 0) {
    p = {br, us, ceil_div(B, br > 0 ? br : 1), ceil_div(W, us > 0 ? us : 1)};
    return br > 0 && us > 0 && fits(p);
  }
  const double fma_rate = sizeof(T) == 4 ? 128.0 : 1024.0, byte_rate = 32.0;
  double best = -1.0;
  for (int BR : {64, 32, 16}) {
    if (BR > 16 && BR - 16 >= B) continue;  // a tile that is mostly padding
    for (int US : {32, 16, 8, 4}) {
      if (BR > 16 && !fixed_tile(BR, US)) continue;  // wide row tiles: fixed ones
      const Plan q{BR, US, ceil_div(B, BR), ceil_div(W, US)};
      if (!fits(q)) continue;
      const double block = (double)BR * 4 * US * (D + W) / fma_rate +
                           (double)(BR + 4 * US) * (D + W) * sizeof(T) / byte_rate;
      const double t = ceil_div(q.tiles * q.slices, sms > 0 ? sms : 1) * block;
      if (best < 0.0 || t < best) {
        best = t;
        p = q;
      }
    }
  }
  return best >= 0.0;
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

template <typename T, int BR, int US> int run(const Args& a, cudaStream_t s) {
  const size_t smem = step_smem<T>(a.p);
  cudaError_t err = cudaFuncSetAttribute(lstm_step_kernel<T, BR, US>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lstm_step_kernel<T, BR, US><<<a.p.tiles * a.p.slices, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* K, const void* R,
           const void* b, void* h_out, void* c_out, int B, int D, int W, int br, int us,
           cudaStream_t s) {
  Args a{x, h, c, K, R, b, h_out, c_out, B, D, W, false, false, false, {}};
  if (B < 1 || D < 1 || W < 1 || !make_plan<T>(B, D, W, br, us, a.p))
    return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  a.vec_x = D % V == 0 && aligned16(x);
  a.vec_h = W % V == 0 && aligned16(h);
  a.vec_w = W % V == 0 && aligned16(K) && aligned16(R);
  const int BR = a.p.BR, US = a.p.US;
  if (BR == 64 && US == 32) return run<T, 64, 32>(a, s);
  if (BR == 64 && US == 16) return run<T, 64, 16>(a, s);
  if (BR == 32 && US == 32) return run<T, 32, 32>(a, s);
  if (BR == 32 && US == 16) return run<T, 32, 16>(a, s);
  return run<T, 0, 0>(a, s);
}

}  // namespace

extern "C" const char* cor_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// the tile a launch takes: out = {BR, US, row tiles, unit slices}; 0 if the
// shapes (or the imposed br, us > 0) are refused
extern "C" int lstm_step_plan(int dtype, int B, int D, int W, int br, int us, int* out) {
  Plan p{};
  const bool ok = dtype == 0   ? make_plan<float>(B, D, W, br, us, p)
                  : dtype == 1 ? make_plan<__nv_bfloat16>(B, D, W, br, us, p)
                               : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  out[0] = p.BR;
  out[1] = p.US;
  out[2] = p.tiles;
  out[3] = p.slices;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16; br, us: the tile (0: picked here).
// Returns cudaGetLastError() after the launch.
extern "C" int lstm_step_launch(int dtype, const void* x, const void* h, const void* c,
                                const void* K, const void* R, const void* b, void* h_out,
                                void* c_out, int B, int D, int W, int br, int us, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, h, c, K, R, b, h_out, c_out, B, D, W, br, us, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, h, c, K, R, b, h_out, c_out, B, D, W, br, us, s);
  return (int)cudaErrorInvalidValue;
}
