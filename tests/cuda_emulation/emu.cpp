// The emulation's thread-local state (see cuda_runtime.h in this directory).
#include "cuda_runtime.h"

thread_local emu_dim3 threadIdx, blockIdx;
thread_local emu::Block* emu::cur = nullptr;
