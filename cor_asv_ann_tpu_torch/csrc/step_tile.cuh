// Device code of the per-step kernels (lstm_step.cu: K2, decode_step.cu: K3,
// and the stage kernels of teacher_scan.cu: K6, teacher_bwd.cu: K7): a block
// owns a tile of rows and, per product, a slice of output columns, and streams
// both operands through shared memory by chunks of the reduction.
//
// - `pipeline`: NS buffers of a chunk each; the copies of chunk c + NS - 1 are
//   issued (cp.async) before the product of chunk c runs, so NS - 1 chunks are
//   in flight while one is multiplied; one barrier a chunk.
// - `copy_rows`: rows of a row-major matrix, along the reduction, as 16-byte
//   asynchronous copies (the A operand, and K3's pre-packed B operands, whose
//   rows are output columns: the layout TileProduct of scan_grid.cuh takes).
// - `copy_gate_cols` and `TileKN`: K2 gets its weights row-major ([k][col], the
//   JAX package's layout, with no place to pack them), so a chunk of its B
//   operand keeps that layout in shared memory ([k][c]) and TileKN reads it so:
//   bf16 B fragments of mma.sync by ldmatrix.trans, float32 4x4 register tiles
//   of exact FMA with four consecutive columns a thread.
// - `WarpTile`/`FmaTile`: block products of a compile-time shape;
//   `tile_product` runs one over the pipeline with B as rows ([c][k]).
// Sums run in a fixed order: two runs give the same bits.

#pragma once

#include "scan_grid.cuh"

namespace scan {
namespace tile {

using grid::ceil_div;
using grid::cp_async16;
using grid::cp_async_commit;
using grid::cp_async_wait;
using grid::ld32;
using grid::MAX_OUT;
using grid::mma_bf16_16816;
using grid::NT;
using grid::NW;
using grid::pad;
using grid::part_floats;
using grid::round_up;
using grid::TileProduct;
using grid::TPT;
using grid::TPW;

// chunk of the reduction staged at a time: 128 bytes of a row
template <typename T> __host__ __device__ constexpr int kc() { return 128 / (int)sizeof(T); }

// ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16: lanes 0-15 each name a row
// of 8 bf16 (16 bytes, aligned) of two 8x8 matrices, lanes 0-7 those of
// matrix 0, lanes 8-15 those of matrix 1; lane l receives in r[i] the elements
// (2*(l%4), l/4) and (2*(l%4)+1, l/4) of matrix i, the lower index in the lower
// half. Of a 16x8 tile stored [k][n] that is the B fragment of mma m16n8k16.
// Every lane of the warp must call it. A host compiler (the CPU emulation
// under tests/cuda_emulation) supplies a warp-collective stand-in.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* row) {
#ifdef __CUDACC__
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
#else
  ldmatrix_x2_trans_standin(r, row);
#endif
}

// ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: lanes 8m .. 8m+7 name the
// rows of matrix m (m < 4); r[m] is lane l's part of matrix m: elements
// (l/4, 2*(l%4)) and (l/4, 2*(l%4)+1), or with TRANS (2*(l%4), l/4) and
// (2*(l%4)+1, l/4), the first in the lower half. Every lane of the warp must
// call it; a host compiler has a stand-in.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
#ifdef __CUDACC__
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
#else
  ldmatrix_x4_standin(r, row, TRANS);
#endif
}

// dst[r * ldd + k - k0] = src[r * lds + k] for r < rows, k0 <= k < k0 + kc,
// zero where r >= rvalid or k >= K. With `vec` (rows and K whole 16-byte
// pieces, src 16-byte aligned) as asynchronous 16-byte copies, else element by
// element here. Commits nothing.
template <typename T>
__device__ __forceinline__ void copy_rows(T* __restrict__ dst, int ldd, const T* __restrict__ src,
                                          size_t lds, int rows, int rvalid, int k0, int kc, int K,
                                          bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int vpr = kc / V, n = rows * vpr;
    for (int i = threadIdx.x; i < n; i += NT) {
      const int r = i / vpr, k = k0 + (i % vpr) * V;
      const bool valid = r < rvalid && k < K;
      cp_async16(dst + (size_t)r * ldd + (k - k0), valid ? src + r * lds + k : src, valid);
    }
  } else {
    const int n = rows * kc;
    for (int i = threadIdx.x; i < n; i += NT) {
      const int r = i / kc, k = k0 + i % kc;
      dst[(size_t)r * ldd + (k - k0)] = r < rvalid && k < K ? src[r * lds + k] : from_f<T>(0.0f);
    }
  }
}

// A chunk of the gate columns of a row-major weight matrix M (K, 4W), kept
// row-major: dst[(k - k0) * ldd + gate * US + j] = M[k, gate * W + u0 + j] for
// k0 <= k < k0 + kc, zero where j >= nu or k >= K. With `vec` (W, u0 and US
// whole 16-byte pieces, M 16-byte aligned) as asynchronous 16-byte copies.
template <typename T>
__device__ __forceinline__ void copy_gate_cols(T* __restrict__ dst, int ldd,
                                               const T* __restrict__ M, int W, int u0, int US,
                                               int nu, int k0, int kc, int K, bool vec) {
  const size_t ldm = (size_t)4 * W;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int vpg = US / V, n = kc * 4 * vpg;
    for (int i = threadIdx.x; i < n; i += NT) {
      const int kk = i / (4 * vpg), c = (i % (4 * vpg)) * V, g = c / US, j = c % US;
      const bool valid = j < nu && k0 + kk < K;
      cp_async16(dst + (size_t)kk * ldd + c,
                 valid ? M + (size_t)(k0 + kk) * ldm + g * W + u0 + j : M, valid);
    }
  } else {
    const int n = kc * 4 * US;
    for (int i = threadIdx.x; i < n; i += NT) {
      const int kk = i / (4 * US), c = i % (4 * US), g = c / US, j = c % US;
      dst[(size_t)kk * ldd + c] = j < nu && k0 + kk < K
                                      ? M[(size_t)(k0 + kk) * ldm + g * W + u0 + j]
                                      : from_f<T>(0.0f);
    }
  }
}

// NS chunk buffers: issue(c, buf) copies chunk c into buffer buf (without a
// commit), compute(c, buf) multiplies it. Starts with the buffers free and
// ends with the block synchronised.
template <int NS, class Issue, class Compute>
__device__ __forceinline__ void pipeline(int chunks, Issue issue, Compute compute) {
  static_assert(NS >= 2, "one chunk in flight at least");
  for (int c = 0; c < NS - 1; ++c) {
    if (c < chunks) issue(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    // the buffer of chunk c - 1, which every thread has finished with
    if (c + NS - 1 < chunks) issue(c + NS - 1, (c + NS - 1) % NS);
    cp_async_commit();
    compute(c, c % NS);
  }
  __syncthreads();
}

// Accumulators of one block-wide product out (M x nc) = A (M x K) . B with A
// in shared memory as rows along the reduction (A[r][k]) and B row-major
// (B[k][c]); `chunk` adds kc more of the reduction. M is a multiple of 16, nc
// of 8, kc of 16 (bf16) or 4 (float32). The tiles, the split of a small
// product's reduction and `finish` are those of TileProduct (scan_grid.cuh).
template <typename T> struct TileKN;

template <> struct TileKN<__nv_bfloat16> : TileProduct<__nv_bfloat16> {
  using T = __nv_bfloat16;
  __device__ __forceinline__ TileKN(int M, int nc) : TileProduct<T>(M, nc) {}

  template <int NI>
  __device__ __forceinline__ void chunk_n(const T* __restrict__ a, int lda,
                                          const T* __restrict__ b, int ldb, int kc) {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, q = lane & 3;
    int ao[NI], bo[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int tile = (w + i * NW) % tiles;
      ao[i] = ((tile % mt) * 16 + g) * lda + 2 * q;
      bo[i] = (lane & 15) * ldb + (tile / mt) * 8;  // this lane's row of the ldmatrix
    }
    for (int ks = kq * 16; ks < kc; ks += 16 * ksplit) {
      uint32_t af[4];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (i == 0 || ao[i] != ao[i - 1]) {
          const T* ar = a + ao[i] + ks;
          af[0] = ld32(ar);
          af[1] = ld32(ar + 8 * lda);
          af[2] = ld32(ar + 8);
          af[3] = ld32(ar + 8 * lda + 8);
        }
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, b + bo[i] + (size_t)ks * ldb);
        mma_bf16_16816(acc[i], af, bf);
      }
    }
  }

  __device__ __forceinline__ void chunk(const T* __restrict__ a, int lda, const T* __restrict__ b,
                                        int ldb, int kc) {
    const int w = threadIdx.x / 32;
    switch (items > w ? (items - w + NW - 1) / NW : 0) {
      case 1: chunk_n<1>(a, lda, b, ldb, kc); break;
      case 2: chunk_n<2>(a, lda, b, ldb, kc); break;
      case 3: chunk_n<3>(a, lda, b, ldb, kc); break;
      case 4: chunk_n<4>(a, lda, b, ldb, kc); break;
      case 5: chunk_n<5>(a, lda, b, ldb, kc); break;
      case 6: chunk_n<6>(a, lda, b, ldb, kc); break;
      case 7: chunk_n<7>(a, lda, b, ldb, kc); break;
      case 8: chunk_n<8>(a, lda, b, ldb, kc); break;
      default: break;
    }
  }
};

template <> struct TileKN<float> {
  using T = float;
  int nq, ttiles, ksplit, items, kq;
  float acc[TPT][4][4];

  __device__ __forceinline__ TileKN(int M, int nc) {
    nq = nc / 4;
    ttiles = (M / 4) * nq;
    ksplit = ttiles >= NT ? 1 : NT / ttiles;
    items = ttiles * ksplit;
    kq = threadIdx.x / ttiles;
#pragma unroll
    for (int i = 0; i < TPT; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][r][c] = 0.0f;
  }

  // NI tiles of this thread: rows 4*tr .. 4*tr+3, columns 4*tc .. 4*tc+3
  // (neighbouring threads read neighbouring columns of B)
  template <int NI>
  __device__ __forceinline__ void chunk_n(const T* __restrict__ a, int lda,
                                          const T* __restrict__ b, int ldb, int kc) {
    const int tid = threadIdx.x;
    int ao[NI], bo[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int tt = (tid + i * NT) % ttiles;
      ao[i] = 4 * (tt / nq) * lda;
      bo[i] = 4 * (tt % nq);
    }
    for (int ks = kq * 4; ks < kc; ks += 4 * ksplit) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float4 av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          av[r] = *reinterpret_cast<const float4*>(a + ao[i] + r * lda + ks);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          bv[k] = *reinterpret_cast<const float4*>(b + (size_t)(ks + k) * ldb + bo[i]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float ak[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
          float s0 = acc[i][r][0], s1 = acc[i][r][1], s2 = acc[i][r][2], s3 = acc[i][r][3];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            s0 = fmaf(ak[k], bv[k].x, s0);
            s1 = fmaf(ak[k], bv[k].y, s1);
            s2 = fmaf(ak[k], bv[k].z, s2);
            s3 = fmaf(ak[k], bv[k].w, s3);
          }
          acc[i][r][0] = s0;
          acc[i][r][1] = s1;
          acc[i][r][2] = s2;
          acc[i][r][3] = s3;
        }
      }
    }
  }

  __device__ __forceinline__ void chunk(const T* __restrict__ a, int lda, const T* __restrict__ b,
                                        int ldb, int kc) {
    const int tid = threadIdx.x;
    const int mine = items > tid ? (items - tid + NT - 1) / NT : 0;
    static_assert(TPT == 2, "one case per tile count");
    if (mine == 1) chunk_n<1>(a, lda, b, ldb, kc);
    if (mine == 2) chunk_n<2>(a, lda, b, ldb, kc);
  }

  // out[r * ldo + c] = the product; ends with the block synchronised
  __device__ __forceinline__ void finish(float* __restrict__ out, int ldo,
                                         float* __restrict__ part) {
    if (ksplit == 1) {
#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        const int it = threadIdx.x + i * NT;
        if (it < items) {
          const int tr = it / nq, tc = it % nq;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<float4*>(out + (size_t)(4 * tr + r) * ldo + 4 * tc) =
                make_float4(acc[i][r][0], acc[i][r][1], acc[i][r][2], acc[i][r][3]);
        }
      }
    } else {
      if ((int)threadIdx.x < items) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[(size_t)threadIdx.x * 16 + r * 4 + c] = acc[0][r][c];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < ttiles * 16; i += NT) {
        const int tt = i / 16, r = (i % 16) / 4, c = i % 4;
        float s = 0.0f;
        for (int p = 0; p < ksplit; ++p) s += part[(size_t)(p * ttiles + tt) * 16 + (i % 16)];
        out[(size_t)(4 * (tt / nq) + r) * ldo + 4 * (tt % nq) + c] = s;
      }
    }
    __syncthreads();
  }
};

// Block products of a compile-time shape that fill the block: out (M x NC)
// += A (M x KC chunk, A[r][k] in shared memory) . B, with B in shared memory
// as [c][k] (BT false: rows along the reduction) or [k][c] (BT true:
// row-major weights). The k-steps of a chunk are unrolled and every offset
// is worked out once, so the loop is fragment loads and arithmetic only.
// `store` writes the product to out[r * ldo + c].
//
// bf16, tensor cores: the 8 warps as WM x (8 / WM), a warp owning a
// (M / WM) x (NC * WM / 8) piece, its fragments by ldmatrix.x4 (A: four 8x8
// matrices of a 16x16 tile; B: two n8 tiles over k16, .trans for [k][c]).
template <int M, int NC, int WM, bool BT> struct WarpTile {
  using T = __nv_bfloat16;
  static constexpr int TM = M / WM, TN = NC / (NW / WM), MI = TM / 16, NJ = TN / 8;
  static_assert(NW % WM == 0 && TM % 16 == 0 && TN % 16 == 0, "whole fragments");
  float acc[MI][NJ][4];
  int ao[MI], bo[NJ / 2], ldb;

  __device__ __forceinline__ WarpTile(int lda, int ldb_) : ldb(ldb_) {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = (w % WM) * TM, c0 = (w / WM) * TN, m = lane / 8;
#pragma unroll
    for (int i = 0; i < MI; ++i) ao[i] = (r0 + i * 16 + lane % 16) * lda + (lane / 16) * 8;
#pragma unroll
    for (int j = 0; j < NJ / 2; ++j) {
      const int n = c0 + j * 16 + (m / 2) * 8, k = (m % 2) * 8;
      bo[j] = BT ? (k + lane % 8) * ldb + n : (n + lane % 8) * ldb + k;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  template <int KC>
  __device__ __forceinline__ void chunk(const T* __restrict__ a, const T* __restrict__ b) {
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t af[MI][4], bf[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldmatrix_x4<false>(af[i], a + ao[i] + ks);
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4<BT>(r, b + bo[j] + (BT ? ks * ldb : ks));
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16_16816(acc[i][j], af[i], bf[j]);
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ out, int ldo) const {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = (w % WM) * TM + lane / 4, c0 = (w / WM) * TN + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[(size_t)(r0 + i * 16 + (e >> 1) * 8) * ldo + c0 + j * 8 + (e & 1)] = acc[i][j][e];
  }
};

// float32, exact FMA: the threads as 16 rows x 16 columns, thread (tr, tc)
// owning rows tr + 16*r (r < RT = M/16; neighbouring rows for a warp's two
// thread rows) and CT = NC/16 columns: for [c][k] B, columns tc + 16*c
// (neighbouring threads on neighbouring rows of B), for [k][c] B, columns
// 4*(tc + 16*j) .. +3 (float4 along c). Each sum runs along k in order.
template <int M, int NC, bool BT> struct FmaTile {
  using T = float;
  static constexpr int TC = 16, TR = NT / TC, CT = NC / TC, RT = M / TR;
  static_assert(NC % (4 * TC) == 0 && M % TR == 0, "threads cover the tile");
  float acc[RT][CT];
  int ao, bo, lda, ldb;

  __device__ __forceinline__ FmaTile(int lda_, int ldb_) : lda(lda_), ldb(ldb_) {
    const int tr = threadIdx.x / TC, tc = threadIdx.x % TC;
    ao = tr * lda;
    bo = BT ? 4 * tc : tc * ldb;
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[r][c] = 0.0f;
  }

  // UNROLL: k-steps of 4 unrolled (all of them: loads hoisted ahead of the
  // FMAs, at the cost of registers)
  template <int KC, int UNROLL = 2>
  __device__ __forceinline__ void chunk(const T* __restrict__ a, const T* __restrict__ b) {
#pragma unroll (UNROLL)
    for (int ks = 0; ks < KC; ks += 4) {
      float av[RT][4], bv[CT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(a + ao + TR * r * lda + ks);
        av[r][0] = v.x; av[r][1] = v.y; av[r][2] = v.z; av[r][3] = v.w;
      }
      if (BT) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < CT / 4; ++j) {
            const float4 v =
                *reinterpret_cast<const float4*>(b + bo + (size_t)(ks + k) * ldb + 4 * TC * j);
            bv[4 * j][k] = v.x; bv[4 * j + 1][k] = v.y; bv[4 * j + 2][k] = v.z; bv[4 * j + 3][k] = v.w;
          }
      } else {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(b + bo + (size_t)c * TC * ldb + ks);
          bv[c][0] = v.x; bv[c][1] = v.y; bv[c][2] = v.z; bv[c][3] = v.w;
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          float s = acc[r][c];
#pragma unroll
          for (int k = 0; k < 4; ++k) s = fmaf(av[r][k], bv[c][k], s);
          acc[r][c] = s;
        }
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ out, int ldo) const {
    const int tr = threadIdx.x / TC, tc = threadIdx.x % TC;
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int col = BT ? 4 * (tc + TC * (c / 4)) + c % 4 : tc + TC * c;
        out[(size_t)(tr + TR * r) * ldo + col] = acc[r][c];
      }
  }
};

// The block product of a compile-time tile with B as rows along the
// reduction ([c][k]): bf16 on tensor cores, float32 on exact FMA
template <typename T, int M, int NC> struct RowTile;
template <int M, int NC> struct RowTile<__nv_bfloat16, M, NC> {
  using type = WarpTile<M, NC, M / 32, false>;
};
template <int M, int NC> struct RowTile<float, M, NC> {
  using type = FmaTile<M, NC, false>;
};

// row stride of a chunk buffer
template <typename T> __host__ __device__ constexpr int chunk_ld() { return kc<T>() + pad<T>(); }

// dynamic shared memory of tile_product: the NS chunk buffers of both
// operands, which the product's float32 result reuses
template <typename T, int M, int NC, int NS> size_t tile_product_smem() {
  const size_t stages = (size_t)NS * (M + NC) * chunk_ld<T>() * sizeof(T);
  const size_t out = (size_t)M * NC * sizeof(float);
  return stages > out ? stages : out;
}

// out (M x NC float32, at the start of shared memory, row stride NC) =
// A (rows a[r * lda + k], zero beyond nr rows) times B^T (rows b[c * ldb + k],
// zero beyond nc rows) over a reduction of K, with NS chunk buffers. Ends
// with the block synchronised.
template <typename T, int M, int NC, int NS>
__device__ __forceinline__ void tile_product(float4* smem, const T* __restrict__ a, size_t lda,
                                             int nr, const T* __restrict__ b, size_t ldb, int nc,
                                             int K) {
  constexpr int KC = kc<T>(), ld = chunk_ld<T>();
  T* abuf = reinterpret_cast<T*>(smem);
  T* bbuf = abuf + (size_t)NS * M * ld;
  typename RowTile<T, M, NC>::type acc(ld, ld);
  pipeline<NS>(
      ceil_div(K, KC),
      [&](int c, int buf) {
        copy_rows<T>(abuf + (size_t)buf * M * ld, ld, a, lda, M, nr, c * KC, KC, K, true);
        copy_rows<T>(bbuf + (size_t)buf * NC * ld, ld, b, ldb, NC, nc, c * KC, KC, K, true);
      },
      [&](int c, int buf) {
        acc.template chunk<KC>(abuf + (size_t)buf * M * ld, bbuf + (size_t)buf * NC * ld);
      });
  acc.store(reinterpret_cast<float*>(smem), NC);
  __syncthreads();
}

}  // namespace tile
}  // namespace scan
