// Stand-in for <cuda_runtime.h> that lets a host C++20 compiler build the
// port's kernels (csrc/lstm_step.cu, csrc/lstm_scan.cu, csrc/teacher_scan.cu,
// csrc/teacher_bwd.cu, csrc/decode_step.cu, csrc/decode_loop.cu) and run them
// on the CPU. A launch runs on the OS thread that makes it, each CUDA thread
// a fiber (<ucontext.h>) on a pooled stack above a guard page (emu.cpp); a
// fiber runs until it reaches a barrier or spins on a counter, then yields to
// the launch's scheduler. One fiber barrier stands in for __syncthreads (and
// __syncthreads_or) over the block and for __syncwarp, the warp shuffles, and
// the bf16 tensor-core instruction and ldmatrix, which exchange through
// per-warp buffers. The scheduler resumes a block's threads in ascending
// order in one phase of its block barrier and in descending order in the
// next, so that a read of another thread's write that lacks its barrier
// finds the poisoned shared memory or scratch in one of the two orders on
// every run. A round of the scheduler in which no fiber starts, arrives at
// or passes a barrier, adds to a counter or returns is a deadlock: the
// launch stops, names the waiting threads on stderr, and fails with
// cudaErrorLaunchTimeout (the return of cudaLaunchCooperativeKernel, or of
// the next cudaGetLastError() after a `<<<...>>>` launch). The blocks of a
// `<<<...>>>` launch run one after another; the blocks of a cooperative
// launch (cudaLaunchCooperativeKernel) all at once, on a card of
// EMU_SM_COUNT SMs that holds one block per SM, so that blocks can wait on
// each other through a counter in global memory (release adds, acquire
// loads, and loads that bypass L1 of what the other blocks wrote). It knows
// only the constructs those sources use. The launch syntax `kernel<<<grid,
// threads, smem, stream>>>(args)` and the `extern __shared__` declaration
// are rewritten by tests/test_torch_kernel_emulation.py (to emu::launch and
// emu::smem) before compiling.
#pragma once

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <tuple>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

using std::max;
using std::min;

struct emu_dim3 { int x = 0, y = 0, z = 0; };
extern thread_local emu_dim3 threadIdx, blockIdx;

struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchTimeout = 702,  // a deadlocked launch
  cudaErrorCooperativeLaunchTooLarge = 720
};
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
constexpr int EMU_MAX_SMEM = 232448;  // what a Hopper block can opt in to
// few SMs, so that the tests' grids have several row groups and unit slices
// with few fibers
constexpr int EMU_SM_COUNT = 6;

template <class F> cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes <= EMU_MAX_SMEM ? cudaSuccess : cudaErrorInvalidValue;
}
namespace emu {
extern thread_local cudaError_t last_error;  // of a `<<<...>>>` launch
}
inline cudaError_t cudaGetLastError() { return std::exchange(emu::last_error, cudaSuccess); }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated CUDA error"; }
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? EMU_SM_COUNT : EMU_MAX_SMEM;
  return cudaSuccess;
}
// one block per SM, if its shared memory fits
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t smem) {
  *n = smem <= (size_t)EMU_MAX_SMEM ? 1 : 0;
  return cudaSuccess;
}

// cp.async of 16 bytes, done at once (the waits are no-ops)
inline void cp_async16_standin(void* dst, const void* src, bool valid) {
  if (valid)
    std::memcpy(dst, src, 16);
  else
    std::memset(dst, 0, 16);
}

namespace emu {
void released();  // a counter moved: the launch makes progress
void spin();      // yields the fiber that spins to the scheduler
}
// the release add and acquire load (red.release.gpu / ld.acquire.gpu) of a
// counter in global memory shared between blocks
inline void red_release_add_standin(int* p, int v) {
  std::atomic_ref<int>(*p).fetch_add(v, std::memory_order_release);
  emu::released();
}
inline int ld_acquire_standin(const int* p) {
  emu::spin();  // a spinning block lets the others run
  return std::atomic_ref<int>(*const_cast<int*>(p)).load(std::memory_order_acquire);
}

// ld.global.cg: a load from L2, past a possibly stale L1 (here: memory)
template <class V> V ld_cg_standin(const V* p) {
  V v;
  std::memcpy(&v, p, sizeof(V));
  return v;
}

namespace emu {

// a barrier over `count` fibers: arrive, then yield until `gen` moves on
struct Barrier {
  int count = 0, arrived = 0;
  unsigned gen = 0;
  void arrive_and_wait();
};

struct Block {
  Barrier bar;                      // __syncthreads
  std::vector<Barrier> wbar;        // one per warp
  std::vector<uint32_t> xch;        // shuffle exchange, one word per thread
  std::vector<uint32_t> mma;        // mma fragments, 6 words per thread
  std::vector<const void*> rows;    // ldmatrix row addresses, one per thread
  std::vector<float4> smem;         // dynamic shared memory
  int vote = 0;                     // __syncthreads_or
};
extern thread_local Block* cur;

inline float4* smem() { return cur->smem.data(); }

// blocks [b0, b1) of a grid, all at once, each of nt fibers that call
// body(arg); cudaErrorLaunchTimeout where they deadlock
cudaError_t run_blocks(int b0, int b1, int nt, size_t smem_bytes, void (*body)(void*), void* arg);

template <class Body> cudaError_t run_blocks(int b0, int b1, int nt, size_t smem_bytes, Body body) {
  return run_blocks(b0, b1, nt, smem_bytes, [](void* f) { (*static_cast<Body*>(f))(); }, &body);
}

template <class K, class... A>
void launch(int grid, int nt, size_t smem_bytes, K kernel, A... args) {
  for (int b = 0; b < grid; ++b) {
    const cudaError_t err = run_blocks(b, b + 1, nt, smem_bytes, [&] { kernel(args...); });
    if (err != cudaSuccess) {
      last_error = err;
      return;
    }
  }
}

}  // namespace emu

// every block of the grid runs concurrently, or the launch is refused
template <class... A>
cudaError_t cudaLaunchCooperativeKernel(void (*kernel)(A...), int grid, int nt, void** args,
                                        size_t smem_bytes, cudaStream_t) {
  if (grid > EMU_SM_COUNT || smem_bytes > (size_t)EMU_MAX_SMEM) return cudaErrorCooperativeLaunchTooLarge;
  auto call = [&]<size_t... I>(std::index_sequence<I...>) {
    kernel(*static_cast<std::remove_reference_t<A>*>(args[I])...);
  };
  return emu::run_blocks(0, grid, nt, smem_bytes, [&] { call(std::index_sequence_for<A...>{}); });
}

inline void __syncthreads() { emu::cur->bar.arrive_and_wait(); }

// bar.red.or: a barrier over the block that returns non-zero where any
// thread's predicate is
inline int __syncthreads_or(int pred) {
  emu::Block* b = emu::cur;
  b->bar.arrive_and_wait();  // every thread has read the last vote
  if (threadIdx.x == 0) b->vote = 0;
  b->bar.arrive_and_wait();
  if (pred) b->vote = 1;
  b->bar.arrive_and_wait();
  return b->vote;
}

// every lane of the warp must call it, as the kernels do
inline void __syncwarp(unsigned = 0xffffffffu) { emu::cur->wbar[threadIdx.x / 32].arrive_and_wait(); }

inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

// every lane of the warp must call it, as the kernels do
template <class V> V __shfl_xor_sync(unsigned, V v, int lane_mask) {
  static_assert(sizeof(V) == 4, "32-bit values only");
  emu::Block* b = emu::cur;
  const int t = threadIdx.x, w = t / 32;
  std::memcpy(&b->xch[t], &v, 4);
  b->wbar[w].arrive_and_wait();
  V r;
  std::memcpy(&r, &b->xch[t ^ lane_mask], 4);
  b->wbar[w].arrive_and_wait();
  return r;
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 for the warp, in the
// PTX ISA's fragment layout (groupID = lane / 4, q = lane % 4): A (16x16)
// a[0] row g, k 2q..2q+1; a[1] row g+8; a[2] row g, k 2q+8..; a[3] row g+8,
// k 2q+8..; B (16x8) b[0] k 2q..2q+1, column g; b[1] k 2q+8..; D (16x8) d[0..1]
// row g, columns 2q..2q+1, d[2..3] row g+8. The lower half of a word holds the
// element of the lower index. Every lane of the warp must call it.
inline float emu_bf16_half(uint32_t word, int hi) {
  const uint32_t u = (hi ? word >> 16 : word & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline void mma_bf16_m16n8k16_standin(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  emu::Block* blk = emu::cur;
  const int t = threadIdx.x, w = t / 32, lane = t % 32, base = w * 32;
  uint32_t* mine = &blk->mma[(size_t)t * 6];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b[0];
  mine[5] = b[1];
  blk->wbar[w].arrive_and_wait();
  auto A = [&](int r, int k) {
    const int l = (r % 8) * 4 + (k % 8) / 2, reg = (r >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0);
    return emu_bf16_half(blk->mma[(size_t)(base + l) * 6 + reg], k % 2);
  };
  auto B = [&](int k, int c) {
    const int l = c * 4 + (k % 8) / 2, reg = 4 + (k >= 8 ? 1 : 0);
    return emu_bf16_half(blk->mma[(size_t)(base + l) * 6 + reg], k % 2);
  };
  const int g = lane / 4, q = lane % 4;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + (e >> 1) * 8, c = 2 * q + (e & 1);
    float s = d[e];
    for (int k = 0; k < 16; ++k) s = std::fma(A(r, k), B(k, c), s);
    out[e] = s;
  }
  blk->wbar[w].arrive_and_wait();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}

// ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 for the warp: lanes 0-7 name
// the rows (8 consecutive 16-bit values each) of matrix 0, lanes 8-15 those of
// matrix 1; lane l receives in r[i] the elements (row 2*(l%4), column l/4)
// and (row 2*(l%4)+1, column l/4) of matrix i, the first in the lower half.
// Every lane of the warp must call it.
inline void ldmatrix_x2_trans_standin(uint32_t (&r)[2], const void* row) {
  emu::Block* blk = emu::cur;
  const int t = threadIdx.x, w = t / 32, lane = t % 32, base = w * 32;
  blk->rows[t] = row;
  blk->wbar[w].arrive_and_wait();
  const int g = lane / 4, q = lane % 4;
  uint32_t out[2];
  for (int i = 0; i < 2; ++i) {
    uint16_t lo, hi;
    std::memcpy(&lo, static_cast<const uint16_t*>(blk->rows[base + 8 * i + 2 * q]) + g, 2);
    std::memcpy(&hi, static_cast<const uint16_t*>(blk->rows[base + 8 * i + 2 * q + 1]) + g, 2);
    out[i] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  blk->wbar[w].arrive_and_wait();
  r[0] = out[0];
  r[1] = out[1];
}

// ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16 for the warp: lanes 8m ..
// 8m+7 name the rows of matrix m; lane l receives in r[m] the elements (row
// l/4, columns 2*(l%4), 2*(l%4)+1) of matrix m, or with `trans` (rows
// 2*(l%4), 2*(l%4)+1, column l/4), the first in the lower half. Every lane of
// the warp must call it.
inline void ldmatrix_x4_standin(uint32_t (&r)[4], const void* row, bool trans) {
  emu::Block* blk = emu::cur;
  const int t = threadIdx.x, w = t / 32, lane = t % 32, base = w * 32;
  blk->rows[t] = row;
  blk->wbar[w].arrive_and_wait();
  const int g = lane / 4, q = lane % 4;
  uint32_t out[4];
  for (int m = 0; m < 4; ++m) {
    uint16_t lo, hi;
    const void* rows[8];
    for (int i = 0; i < 8; ++i) rows[i] = blk->rows[base + 8 * m + i];
    if (trans) {
      std::memcpy(&lo, static_cast<const uint16_t*>(rows[2 * q]) + g, 2);
      std::memcpy(&hi, static_cast<const uint16_t*>(rows[2 * q + 1]) + g, 2);
    } else {
      std::memcpy(&lo, static_cast<const uint16_t*>(rows[g]) + 2 * q, 2);
      std::memcpy(&hi, static_cast<const uint16_t*>(rows[g]) + 2 * q + 1, 2);
    }
    out[m] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  blk->wbar[w].arrive_and_wait();
  for (int m = 0; m < 4; ++m) r[m] = out[m];
}
