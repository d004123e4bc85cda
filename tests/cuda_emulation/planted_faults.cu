// Kernels with planted faults, for the emulation's own tests
// (tests/test_torch_kernel_emulation.py): a read of a neighbour's
// shared-memory write with or without the barrier between them, and barriers
// or a counter that some thread never reaches. Built only against the
// stand-in headers in this directory.
#include <cuda_runtime.h>

namespace {

// thread t writes x[t] to shared memory after `phase` barriers, then reads
// its neighbour's slot t + offset, after a barrier where SYNC
template <bool SYNC>
__global__ void neighbour_read(const float* x, float* y, int n, int phase, int offset) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x;
  for (int p = 0; p < phase; ++p) __syncthreads();
  s[t] = x[t];
  if (SYNC) __syncthreads();
  const int u = t + offset;
  y[t] = u >= 0 && u < n ? s[u] : 0.f;
}

// thread `skip` of every block of NT threads passes the barrier by
template <int NT>
__global__ void skipped_barrier(float* y, int skip) {
  const int t = threadIdx.x;
  if (t != skip) __syncthreads();
  y[blockIdx.x * NT + t] = 1.f;
}

// every block waits for an arrival of the block after it, which never comes
// from the last
__global__ void unreached_counter(int* counter, int grid) {
  if (threadIdx.x == 0) {
    if (blockIdx.x > 0) red_release_add_standin(&counter[blockIdx.x - 1], 1);
    while (ld_acquire_standin(&counter[blockIdx.x]) < 1) {
    }
  }
  __syncthreads();
}

}  // namespace

extern "C" {

// n threads in one block; returns cudaGetLastError()
int planted_neighbour_read(const float* x, float* y, int n, int phase, int offset, int sync) {
  const size_t bytes = n * sizeof(float);
  if (sync)
    neighbour_read<true><<<1, n, bytes, 0>>>(x, y, n, phase, offset);
  else
    neighbour_read<false><<<1, n, bytes, 0>>>(x, y, n, phase, offset);
  return (int)cudaGetLastError();
}

// blocks of 64 threads, one after another (`<<<...>>>`) or all at once
// (cooperative); the launch's error
int planted_skipped_barrier(float* y, int grid, int skip, int cooperative) {
  if (!cooperative) {
    skipped_barrier<64><<<grid, 64, 0, 0>>>(y, skip);
    return (int)cudaGetLastError();
  }
  void* params[] = {&y, &skip};
  return (int)cudaLaunchCooperativeKernel(skipped_barrier<64>, grid, 64, params, 0, 0);
}

int planted_unreached_counter(int* counter, int grid) {
  void* params[] = {&counter, &grid};
  return (int)cudaLaunchCooperativeKernel(unreached_counter, grid, 64, params, 0, 0);
}

}  // extern "C"
