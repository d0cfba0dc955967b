// fused_dag.cuh -- hand-written template of the fused pipeline megakernel.
//
// Replaces the Pallas TPU kernel lower_fused_dag / _lower_fused_dag_body
// (src/repro/core/codegen_pallas.py): one kernel per fused pipeline DAG,
// producer stages kept on chip, fold / CAM / write-once Map terminals.
//
// codegen_cuda.py instantiates this template once per DAG and plan: it
// writes the per-pattern bodies as __device__ functions, the plan's
// constants (block, depth, grid, buffer offsets) and the kernel's main
// loop, which calls the helpers below.
//
// What bounds it on the card: main-memory bytes.  Every pipeline input is
// read once and only the outputs are written; the bodies do a few
// operations per byte (at most ~10 for gda's outer product), far below the
// H100's ~20 fp32 FLOP per byte of HBM bandwidth.  The design therefore
// keeps every intermediate in shared memory and writes one partial per
// block instead of a revisited output:
//
//  * The TPU grid runs in order, so the Pallas kernel seeds its fold and
//    CAM outputs at g == 0 and revisits them.  Here the grid is persistent
//    (a few blocks per SM); block c walks steps g = c, c + gridDim.x, ...,
//    keeps its fold accumulators in registers and its CAM tables in shared
//    memory across its steps, and writes one partial at the end.
//    combine_partials sums the partials in a fixed block order.
//  * External tiles and stage outputs rotate through DEPTH shared-memory
//    slots (slot = step % DEPTH), the bytes memory.plan_memory charges.
//    The copies are synchronous in this first version; cp.async/TMA
//    prefetch into the spare slots is later work.
//  * CAM keys outside [0, K) are dropped (jax.nn.one_hot drops them).
//
// The hand-written kernels that replace the other revisited-output TPU
// kernels (filter_fold.cuh, groupby_fold.cuh, fused_kmeans.cuh) reuse the
// same pieces: cam_add, block_sum and combine_partials (launch_combine).
#pragma once

#include "tile_copy.cuh"

namespace fdag {

__device__ __forceinline__ void zero(float* dst, int64_t words) {
  for (int64_t e = threadIdx.x; e < words; e += blockDim.x) dst[e] = 0.0f;
}

// Sum of v over the block; the result is valid in thread 0.  `scratch`
// holds at least 32 floats of shared memory no thread still reads.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? scratch[threadIdx.x] : 0.0f;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Add one row's (key, value[ew]) into a shared (k, ew) table.  Keys outside
// [0, k) are dropped.  Lanes start at different columns so that the lanes
// of a warp, which mostly share a few keys, hit different addresses.
__device__ __forceinline__ void cam_add(float* table, int key, int k,
                                        const float* v, int ew) {
  if (key < 0 || key >= k) return;
  float* row = table + (int64_t)key * ew;
  int c = threadIdx.x % ew;
  for (int j = 0; j < ew; ++j) {
    atomicAdd(row + c, v[c]);
    c = (c + 1 == ew) ? 0 : c + 1;
  }
}

// out[j] = init[j] + sum over blocks c, in order, of partials[c][j].
__global__ void combine_partials(const float* __restrict__ partials,
                                 const float* __restrict__ init,
                                 float* __restrict__ out, int ctas,
                                 int width) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  float s = init[j];
  for (int c = 0; c < ctas; ++c) s += partials[(int64_t)c * width + j];
  out[j] = s;
}

// Launch combine_partials over `width` words; returns cudaGetLastError().
inline int launch_combine(const float* partials, const float* init,
                          float* out, int ctas, int width,
                          cudaStream_t stream) {
  if (width == 0) return 0;
  combine_partials<<<(width + 255) / 256, 256, 0, stream>>>(
      partials, init, out, ctas, width);
  return (int)cudaGetLastError();
}

}  // namespace fdag
