// groupby_fold.cuh -- hand-written kernel of the dense keyed sum:
// out[key] += values[i] over the rows i with key = keys[i] in [0, K).
//
// Replaces the Pallas TPU kernel groupby_fold / _gbf_kernel
// (src/repro/kernels/groupby_fold.py), which pushes each tile's one-hot
// key matrix through the MXU into a revisited (K, E) output block.
//
// What bounds it on the card: main-memory bytes in principle (4 + 4E read
// per row, E adds), but in this first version the shared-memory atomics:
// the rows of a warp mostly share a few keys, so their adds to a key's row
// serialise.
//
//  * The TPU grid revisits its (K, E) output across the sequential grid.
//    Here a few persistent blocks per SM walk the block_t-row steps g =
//    blockIdx.x, + gridDim.x, ...; each block adds its rows into its own
//    (K, E) table in shared memory with fdag::cam_add (shared atomics,
//    lanes starting at different columns), writes the table out as one
//    partial, and fdag::combine_partials adds the partials in block order.
//    A block's table, K * E * 4 bytes, must fit its shared memory.
//  * Keys outside [0, K) are dropped, as jax.nn.one_hot drops them.
//  * Loads are scalar, so the inputs need no alignment beyond a word's.
#pragma once

#include "fused_dag.cuh"

namespace gbf {

// Dynamic shared memory: the (num_keys, ew) table.
__global__ void __launch_bounds__(tcopy::THREADS)
groupby_fold_kernel(const int* __restrict__ keys,
                    const float* __restrict__ values, int num_keys, int ew,
                    int block_t, long long steps,
                    float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* const table = reinterpret_cast<float*>(smem4);
  const int width = num_keys * ew;
  fdag::zero(table, width);
  __syncthreads();
  for (long long g = blockIdx.x; g < steps; g += gridDim.x)
    for (int r = threadIdx.x; r < block_t; r += blockDim.x) {
      const long long row = g * block_t + r;
      fdag::cam_add(table, keys[row], num_keys, values + row * ew, ew);
    }
  __syncthreads();
  float* const part = partials + (long long)blockIdx.x * width;
  for (int e = threadIdx.x; e < width; e += blockDim.x) part[e] = table[e];
}

}  // namespace gbf
