// The emulation's runtime (see cuda_runtime.h in this directory): a launch's
// CUDA threads as fibers on the OS thread that makes it, their scheduler, and
// the barrier they meet at.
#include "cuda_runtime.h"

#include <sys/mman.h>
#include <ucontext.h>
#include <unistd.h>

#include <cstdio>
#include <cstdlib>

thread_local emu_dim3 threadIdx, blockIdx;

namespace emu {

thread_local Block* cur = nullptr;
thread_local cudaError_t last_error = cudaSuccess;

namespace {

// the kernels' frames take at most ~1 KiB each (g++ -O1 -fstack-usage)
constexpr size_t STACK_BYTES = 128 << 10;

struct Fiber {
  ucontext_t ctx;
  Block* block;
  int b, t;
  const unsigned* gen = nullptr;  // the generation of the barrier it waits at
  unsigned seen = 0;              // ... while it is this
  bool spinning = false, done = false;
};

struct Launch {
  ucontext_t sched;
  std::vector<Fiber> fibers;
  Fiber* running = nullptr;
  void (*body)(void*) = nullptr;
  void* arg = nullptr;
  long progress = 0;  // starts, arrivals, passed barriers, release adds, returns
};

thread_local Launch* launch_ = nullptr;

// fiber stacks, each above a guard page, kept for the next launch of the
// thread
char* stack(size_t i) {
  thread_local std::vector<char*> pool;
  static const size_t page = (size_t)sysconf(_SC_PAGESIZE);
  while (pool.size() <= i) {
    void* m = mmap(nullptr, page + STACK_BYTES, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE | MAP_STACK, -1, 0);
    if (m == MAP_FAILED || mprotect(m, page, PROT_NONE) != 0) {
      std::perror("emulated CUDA: fiber stack");
      std::abort();
    }
    pool.push_back(static_cast<char*>(m) + page);
  }
  return pool[i];
}

void fiber_main() {
  Launch& L = *launch_;
  L.body(L.arg);
  L.running->done = true;
  ++L.progress;
}  // to L.sched, the context's uc_link

void yield(Fiber& f) { swapcontext(&f.ctx, &launch_->sched); }

// every unfinished fiber waits: name them on stderr
void report_deadlock(const Launch& L, int nb, int nt) {
  std::fprintf(stderr, "emulated CUDA: the launch deadlocked, no thread can go on\n");
  for (int k = 0; k < nb; ++k) {
    const Fiber* first = nullptr;
    int waiting = 0, spinning = 0, returned = 0;
    for (int t = 0; t < nt; ++t) {
      const Fiber& f = L.fibers[(size_t)k * nt + t];
      if (f.done) {
        ++returned;
        continue;
      }
      f.spinning ? ++spinning : ++waiting;
      if (!first) first = &f;
    }
    if (!first) continue;
    std::fprintf(stderr, "  block %d: thread %d %s (of %d threads: %d wait at barriers, %d spin, %d returned)\n",
                 first->b, first->t,
                 first->spinning                        ? "spins on a counter"
                 : first->gen == &first->block->bar.gen ? "waits at __syncthreads"
                                                        : "waits at a warp barrier",
                 nt, waiting, spinning, returned);
  }
}

}  // namespace

void Barrier::arrive_and_wait() {
  Fiber& f = *launch_->running;
  ++launch_->progress;
  f.gen = &gen;
  f.seen = gen;
  if (++arrived == count) {
    arrived = 0;
    ++gen;
  }
  yield(f);  // the last to arrive too, so that the next phase runs in order
}

void released() { ++launch_->progress; }

void spin() {
  Fiber& f = *launch_->running;
  f.spinning = true;
  yield(f);
}

cudaError_t run_blocks(int b0, int b1, int nt, size_t smem_bytes, void (*body)(void*), void* arg) {
  const int nb = b1 - b0;
  std::vector<Block> blocks(nb);
  for (Block& blk : blocks) {
    blk.bar.count = nt;
    blk.wbar.assign(nt / 32, Barrier{32});
    blk.xch.assign(nt, 0);
    blk.mma.assign((size_t)nt * 6, 0);
    blk.rows.assign(nt, nullptr);
    // poisoned, so that a read of scratch that was never written shows
    blk.smem.assign(smem_bytes / sizeof(float4) + 1, float4{NAN, NAN, NAN, NAN});
  }
  Launch L;
  L.body = body;
  L.arg = arg;
  L.fibers.resize((size_t)nb * nt);
  for (size_t i = 0; i < L.fibers.size(); ++i) {
    Fiber& f = L.fibers[i];
    f.block = &blocks[i / nt];
    f.b = b0 + (int)(i / nt);
    f.t = (int)(i % nt);
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = stack(i);
    f.ctx.uc_stack.ss_size = STACK_BYTES;
    f.ctx.uc_link = &L.sched;
    makecontext(&f.ctx, fiber_main, 0);
  }
  launch_ = &L;
  cudaError_t err = cudaSuccess;
  std::vector<Fiber*> ready;
  for (size_t left = L.fibers.size(); left > 0;) {
    const long before = L.progress;
    for (int k = 0; k < nb; ++k) {
      // the threads that can go on as the round reaches the block: ascending
      // in even phases of its barrier, descending in odd ones
      const bool down = blocks[k].bar.gen % 2;
      ready.clear();
      for (int j = 0; j < nt; ++j) {
        Fiber& f = L.fibers[(size_t)k * nt + (down ? nt - 1 - j : j)];
        if (!f.done && (!f.gen || *f.gen != f.seen)) ready.push_back(&f);
      }
      for (Fiber* f : ready) {
        if (!f->spinning) ++L.progress;  // starts, or passes its barrier
        f->gen = nullptr;
        f->spinning = false;
        threadIdx.x = f->t;
        blockIdx.x = f->b;
        cur = f->block;
        L.running = f;
        swapcontext(&L.sched, &f->ctx);
        left -= f->done;
      }
    }
    if (left > 0 && L.progress == before) {
      report_deadlock(L, nb, nt);
      err = cudaErrorLaunchTimeout;
      break;
    }
  }
  launch_ = nullptr;
  cur = nullptr;
  return err;
}

}  // namespace emu
