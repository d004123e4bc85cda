// Stand-in for <cuda_runtime.h> that lets a host C++20 compiler build the
// port's scan kernels (csrc/lstm_scan.cu, csrc/teacher_scan.cu) and run them on
// the CPU: one OS thread per CUDA thread, __syncthreads as a barrier over the
// block, warp shuffles through a per-warp exchange buffer, the blocks of a grid
// one after another. It knows only the constructs those sources use. The
// launch syntax `kernel<<<grid, threads, smem, stream>>>(args)` and the
// `extern __shared__` declaration are rewritten by tests/test_torch_kernel_emulation.py
// (to emu::launch and emu::smem) before compiling.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)

using std::max;
using std::min;

struct emu_dim3 { int x = 0, y = 0, z = 0; };
extern thread_local emu_dim3 threadIdx, blockIdx;

struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
constexpr int EMU_MAX_SMEM = 232448;  // what a Hopper block can opt in to

template <class F> cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes <= EMU_MAX_SMEM ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = EMU_MAX_SMEM; return cudaSuccess; }

namespace emu {

struct Block {
  std::unique_ptr<std::barrier<>> bar;                 // __syncthreads
  std::vector<std::unique_ptr<std::barrier<>>> wbar;   // one per warp
  std::vector<uint32_t> xch;                           // shuffle exchange, one word per thread
  std::vector<float4> smem;                            // dynamic shared memory
};
extern thread_local Block* cur;

inline float4* smem() { return cur->smem.data(); }

template <class K, class... A>
void launch(int grid, int nt, size_t smem_bytes, K kernel, A... args) {
  for (int b = 0; b < grid; ++b) {
    Block blk;
    blk.bar = std::make_unique<std::barrier<>>(nt);
    for (int w = 0; w < nt / 32; ++w) blk.wbar.push_back(std::make_unique<std::barrier<>>(32));
    blk.xch.assign(nt, 0);
    // poisoned, so that a read of scratch that was never written shows
    blk.smem.assign(smem_bytes / sizeof(float4) + 1, float4{NAN, NAN, NAN, NAN});
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        cur = &blk;
        kernel(args...);
      });
    for (auto& t : threads) t.join();
  }
}

}  // namespace emu

inline void __syncthreads() { emu::cur->bar->arrive_and_wait(); }

// every lane of the warp must call it, as the kernels do
template <class V> V __shfl_xor_sync(unsigned, V v, int lane_mask) {
  static_assert(sizeof(V) == 4, "32-bit values only");
  emu::Block* b = emu::cur;
  const int t = threadIdx.x, w = t / 32;
  std::memcpy(&b->xch[t], &v, 4);
  b->wbar[w]->arrive_and_wait();
  V r;
  std::memcpy(&r, &b->xch[t ^ lane_mask], 4);
  b->wbar[w]->arrive_and_wait();
  return r;
}
