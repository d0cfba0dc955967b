// grid_flags.cuh -- flag words that one block publishes and another block
// of the same launch acquires: the cross-block step of the one-launch
// kernels (filter_fold.cuh's in-kernel combine of the blocks' partials,
// tiled_flatmap.cuh's decoupled look-back).
//
// A flag is one 64-bit word in device memory.  Its high half holds the
// launch's epoch (EPOCH_BITS bits) above a 2-bit state; its low half holds
// a 32-bit value (an int count, or a float's bits).  One thread writes a
// word with st.release.gpu and others read it with ld.acquire.gpu; each
// word has one writer per launch, so nothing takes an atomic.  The host
// advances the epoch on every launch (kernels/grid_flags.py), so a word
// left by an earlier launch reads as EMPTY: the buffer is zeroed once when
// it is allocated (and when the epoch wraps), never per call.
//
// A block that waits on another block's word spins.  The wait ends only if
// that block runs at the same time, so every kernel that waits goes out
// through launch() below, cudaLaunchCooperativeKernel, which refuses a
// grid that cannot be resident all at once instead of letting it hang.
// (cooperative_groups' grid.sync() is not used: its barrier takes atomics.)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gflags {

constexpr int EPOCH_BITS = 30;
constexpr uint32_t EMPTY = 0u;      // not published in this launch
constexpr uint32_t AGGREGATE = 1u;  // a block's or tile's own value
constexpr uint32_t INCLUSIVE = 2u;  // the prefix through this tile

__host__ __device__ constexpr uint64_t word(uint32_t epoch, uint32_t state,
                                           uint32_t value) {
  return ((uint64_t)((epoch << 2) | state) << 32) | value;
}

// The word's state in launch `epoch`: EMPTY unless it was written in it.
__device__ __forceinline__ uint32_t state_of(uint64_t w, uint32_t epoch) {
  const uint32_t hi = (uint32_t)(w >> 32);
  return (hi >> 2) == epoch ? (hi & 3u) : EMPTY;
}

__device__ __forceinline__ uint32_t value_of(uint64_t w) {
  return (uint32_t)w;
}

__device__ __forceinline__ void publish(uint64_t* flag, uint64_t w) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;\n" ::"l"(flag), "l"(w)
               : "memory");
}

__device__ __forceinline__ uint64_t peek(const uint64_t* flag) {
  uint64_t w;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];\n"
               : "=l"(w)
               : "l"(flag)
               : "memory");
  return w;
}

// Spin until `flag` holds a word of launch `epoch` in a state of `mask`
// (bit s for state s); returns the word.  A wait that never ends (a fault:
// a word no block of the launch writes) traps after 2^22 reads, seconds,
// so the launch fails instead of hanging; a real wait takes microseconds.
__device__ __forceinline__ uint64_t wait(const uint64_t* flag,
                                         uint32_t epoch, uint32_t mask) {
  for (uint32_t tries = 0;; ++tries) {
    if (tries == (1u << 22)) __trap();
    const uint64_t w = peek(flag);
    if ((mask >> state_of(w, epoch)) & 1u) return w;
  }
}

constexpr uint32_t ANY = (1u << AGGREGATE) | (1u << INCLUSIVE);

// Launch `kernel` cooperatively on `ctas` blocks (all resident at once, or
// the launch is refused); returns a CUDA error code.
template <typename Kernel>
inline int launch(Kernel kernel, int ctas, int threads, int smem,
                  cudaStream_t stream, void** args) {
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(ctas), dim3(threads), args, (size_t)smem,
      stream);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace gflags
