// Device code of the grid-wide scan kernels (lstm_scan.cu: K4/K5): a block of
// a cooperative grid owns a group of batch rows and a slice of the units, keeps
// its slice of the recurrent weights in shared memory, and meets the other
// blocks of its row group at a software barrier once a step.
//
// - `product`: one block-wide matrix product out = A.B^T with A's rows read
//   from global memory (L2) in chunks of KC along the reduction, B either
//   resident in shared memory for the whole sweep or staged per chunk. bf16 on
//   tensor cores (mma.sync m16n8k16, float32 accumulator), float32 on FMA
//   (exact float32, no TF32). Sums in a fixed order: no atomics in any sum.
// - `group_arrive`/`group_wait`: a counter per row group in global memory,
//   zeroed by the caller, with release/acquire semantics at GPU scope; it
//   only grows, so a wait names the count it needs.

#pragma once

#include <cstdint>

#include "scan_common.cuh"

namespace scan {
namespace grid {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int TPW = 8;         // bf16: 16x8 output tiles per warp, at most
constexpr int TPT = 2;         // float32: 4x4 output tiles per thread, at most
constexpr int MAX_OUT = NW * TPW * 128;  // outputs of one product (= NT*TPT*16)
static_assert(MAX_OUT == NT * TPT * 16, "both product routes hold as many outputs");

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int ceil_div(int v, int m) { return (v + m - 1) / m; }

// elements added to every row in shared memory: 16 bytes, which spreads the
// rows of a fragment or a float4 load over the banks
template <typename T> __host__ __device__ constexpr int pad() { return 16 / (int)sizeof(T); }

// float32 scratch of the split-reduction partial sums, in floats
template <typename T> __host__ __device__ constexpr int part_floats();
template <> __host__ __device__ constexpr int part_floats<__nv_bfloat16>() { return NW * 128; }
template <> __host__ __device__ constexpr int part_floats<float>() { return NT * 16; }

// The one tensor-core instruction: D += A.B on a 16x8x16 tile, bf16 operands
// in the fragment layout of the PTX ISA, float32 accumulator. A host compiler
// (the CPU emulation under tests/cuda_emulation) supplies a warp-collective
// stand-in with the same layout.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
#ifdef __CUDACC__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
  mma_bf16_m16n8k16_standin(d, a, b);
#endif
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes from global to shared memory without a register, cached in L2
// only (src may have been written by another block of this grid since the
// last barrier); zeros where !valid. Asynchronous: cp_async_wait<n>() waits
// until at most n committed groups are in flight. A host compiler has
// synchronous stand-ins.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
#ifdef __CUDACC__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
#else
  cp_async16_standin(dst, src, valid);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int n> __device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
#endif
}

// dst[c * ldd + k - k0] = src[c * lds + k] for c < crows, k0 <= k < k0 + kc,
// zero where c >= cvalid or k >= K (K a multiple of 16 bytes' worth of
// elements), as asynchronous 16-byte copies (one group, committed)
template <typename T>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst, int ldd, const T* __restrict__ src,
                                           size_t lds, int crows, int cvalid, int k0, int kc,
                                           int K) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = kc / V, n = crows * vpr;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int c = i / vpr, k = k0 + (i % vpr) * V;
    const bool valid = c < cvalid && k < K;
    cp_async16(dst + (size_t)c * ldd + (k - k0), valid ? src + c * lds + k : src, valid);
  }
  cp_async_commit();
}

// The block's gate columns of R (N, 4N), as rows: dst[c * ldd + k - k0] =
// R[k, gate * N + u0 + j] for c = gate * US + j, zero where j >= nu or k >= N.
// R is an input of the kernel (never written), so plain loads.
template <typename T>
__device__ __forceinline__ void stage_gate_cols(T* __restrict__ dst, int ldd,
                                                const T* __restrict__ R, int N, int u0, int US,
                                                int nu, int k0, int kc) {
  constexpr int U = 8;  // loads in flight per thread
  const int nc = 4 * US, n = nc * kc;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * NT) {
    T v[U];
#pragma unroll
    for (int x = 0; x < U; ++x) {
      const int i = i0 + x * NT, k = k0 + i / nc, c = i % nc, j = c % US;
      v[x] = (i < n && j < nu && k < N) ? R[(size_t)k * 4 * N + (c / US) * N + u0 + j]
                                        : from_f<T>(0.0f);
    }
#pragma unroll
    for (int x = 0; x < U; ++x) {
      const int i = i0 + x * NT;
      if (i < n) dst[(size_t)(i % nc) * ldd + i / nc] = v[x];
    }
  }
}

// Accumulators of one block-wide product out (M x nc) = A (M x K) . B^T, with
// both operands in shared memory as rows along the reduction (A[r][k],
// B[c][k]); `chunk` adds kc more of the reduction. M is a multiple of 16, nc
// of 8, kc of 16. Where the output has fewer tiles than the block has
// workers, the reduction is split among them (interleaved in steps of 16 or
// 4) and the parts are added in a fixed order by `finish`.
template <typename T> struct TileProduct;

template <> struct TileProduct<__nv_bfloat16> {
  using T = __nv_bfloat16;
  int mt, tiles, ksplit, items, kq;
  float acc[TPW][4];

  __device__ __forceinline__ TileProduct(int M, int nc) {
    mt = M / 16;
    tiles = mt * (nc / 8);
    ksplit = tiles >= NW ? 1 : NW / tiles;
    items = tiles * ksplit;
    kq = (threadIdx.x / 32) / tiles;  // the warp's part of a split reduction
#pragma unroll
    for (int i = 0; i < TPW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  }

  // NI tiles of this warp: the tile offsets are worked out once a chunk, so
  // the loop over the reduction is loads and mma only (NI is a template
  // parameter, so no instruction of an absent tile is issued); a warp whose
  // tiles share their rows (the usual case: NW is a multiple of M/16) loads
  // A's fragment once
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
      bo[i] = ((tile / mt) * 8 + g) * ldb + 2 * q;
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
        const T* br = b + bo[i] + ks;
        const uint32_t bf[2] = {ld32(br), ld32(br + 8)};
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

  // out[r * ldo + c] = the product; ends with the block synchronised
  __device__ __forceinline__ void finish(float* __restrict__ out, int ldo,
                                         float* __restrict__ part) {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, q = lane & 3;
    if (ksplit == 1) {
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int it = w + i * NW;
        if (it < items) {
          const int m0 = (it % mt) * 16, n0 = (it / mt) * 8;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            out[(size_t)(m0 + g + (e >> 1) * 8) * ldo + n0 + 2 * q + (e & 1)] = acc[i][e];
        }
      }
    } else {
      if (w < items) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(size_t)w * 128 + lane * 4 + e] = acc[0][e];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < tiles * 128; i += NT) {
        const int tile = i / 128, l = (i % 128) / 4, e = i % 4;
        float s = 0.0f;
        for (int p = 0; p < ksplit; ++p) s += part[(size_t)(p * tiles + tile) * 128 + (i % 128)];
        const int m0 = (tile % mt) * 16, n0 = (tile / mt) * 8;
        out[(size_t)(m0 + (l >> 2) + (e >> 1) * 8) * ldo + n0 + 2 * (l & 3) + (e & 1)] = s;
      }
    }
    __syncthreads();
  }
};

template <> struct TileProduct<float> {
  using T = float;
  int nq, ttiles, ksplit, items, kq;
  float acc[TPT][4][4];

  __device__ __forceinline__ TileProduct(int M, int nc) {
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

  // NI tiles of this thread: rows 4*tr .. 4*tr+3, columns tc + j*nq
  // (neighbouring threads read neighbouring rows of B); offsets worked out
  // once a chunk
  template <int NI>
  __device__ __forceinline__ void chunk_n(const T* __restrict__ a, int lda,
                                          const T* __restrict__ b, int ldb, int kc) {
    const int tid = threadIdx.x;
    const int bstep = nq * ldb;
    int ao[NI], bo[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int tt = (tid + i * NT) % ttiles;
      ao[i] = 4 * (tt / nq) * lda;
      bo[i] = (tt % nq) * ldb;
    }
    for (int ks = kq * 4; ks < kc; ks += 4 * ksplit) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float4 av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          av[r] = *reinterpret_cast<const float4*>(a + ao[i] + r * lda + ks);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bv[c] = *reinterpret_cast<const float4*>(b + bo[i] + c * bstep + ks);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float s = acc[i][r][c];
            s = fmaf(av[r].x, bv[c].x, s);
            s = fmaf(av[r].y, bv[c].y, s);
            s = fmaf(av[r].z, bv[c].z, s);
            s = fmaf(av[r].w, bv[c].w, s);
            acc[i][r][c] = s;
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
#pragma unroll
            for (int c = 0; c < 4; ++c)
              out[(size_t)(4 * tr + r) * ldo + tc + c * nq] = acc[i][r][c];
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
        out[(size_t)(4 * (tt / nq) + r) * ldo + tt % nq + c * nq] = s;
      }
    }
    __syncthreads();
  }
};

// out (M x nc, row stride ldo) = A . B^T over a reduction of K:
// A[r][k] = a_src[r * lda + k] for r < mvalid (else 0), staged per chunk of
// KC into a_s, or alternately into a_s and a_s2 (if not null), so that the
// copy of the next chunk runs under the product of this one; B[c][k] =
// bres[c * ldb + k] if bres (resident for the whole sweep), else staged
// into b_s per chunk by stage_b(dst, ldd, k0, kc). Starts with the block
// synchronised and ends so.
template <typename T, class StageB>
__device__ __forceinline__ void product(const T* __restrict__ a_src, size_t lda, int M, int mvalid,
                                        int K, int nc, const T* bres, int ldb, StageB stage_b,
                                        T* a_s, T* a_s2, T* __restrict__ b_s, int KC,
                                        float* __restrict__ part, float* __restrict__ out,
                                        int ldo) {
  TileProduct<T> acc(M, nc);
  const int Kp = round_up(K, 16);
  const int ld = KC + pad<T>();
  const int chunks = ceil_div(Kp, KC);
  auto buf = [&](int c) { return a_s2 && (c & 1) ? a_s2 : a_s; };
  auto issue = [&](int c) {
    stage_rows<T>(buf(c), ld, a_src, lda, M, mvalid, c * KC, min(KC, Kp - c * KC), K);
  };
  issue(0);
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * KC, kc = min(KC, Kp - k0);
    if (a_s2 && c + 1 < chunks) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (!bres) stage_b(b_s, ld, k0, kc);
    __syncthreads();
    if (bres)
      acc.chunk(buf(c), ld, bres + k0, ldb, kc);
    else
      acc.chunk(buf(c), ld, b_s, ld, kc);
    __syncthreads();
    if (!a_s2 && c + 1 < chunks) issue(c + 1);
  }
  acc.finish(out, ldo, part);
}

// release add / acquire load of a group counter at GPU scope (a host
// compiler, as for the mma, has stand-ins)
__device__ __forceinline__ void red_release_add(int* p, int v) {
#ifdef __CUDACC__
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
#else
  red_release_add_standin(p, v);
#endif
}

__device__ __forceinline__ int ld_acquire(const int* p) {
#ifdef __CUDACC__
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
#else
  return ld_acquire_standin(p);
#endif
}

// the block's writes of this step are released to the group with one
// arrival on the group's counter
__device__ __forceinline__ void group_arrive(int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) red_release_add(counter, 1);
}

// wait until the group's counter reaches `target` arrivals, acquiring what
// they released
__device__ __forceinline__ void group_wait(const int* counter, int target) {
  if (threadIdx.x == 0)
    while (ld_acquire(counter) < target) {
    }
  __syncthreads();
}

}  // namespace grid
}  // namespace scan
