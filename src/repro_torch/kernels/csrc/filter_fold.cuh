// filter_fold.cuh -- hand-written kernels of the TPC-H Q6 filter-fold:
// the float32 sum over i of (lo <= x[i] < hi ? x[i] * w[i] : 0).
//
// Replaces two Pallas TPU kernels that compute the same value:
//  * filter_reduce / _fr_kernel (src/repro/kernels/filter_reduce.py), the
//    predicate fused into the reduction: filter_fold_kernel<false>;
//  * fused_filter_fold / _ff_kernel (src/repro/kernels/fused_filter_fold.py),
//    a filter stage writing each tile's contributions into VMEM scratch
//    and a fold stage summing that scratch: filter_fold_kernel<true>.
//
// What bounds it on the card: main-memory bytes, 8 read per row for 4
// operations.
//
//  * The TPU grid runs its block_t-row steps in order and adds each into
//    one revisited (1, 1) output.  Here a few persistent blocks per SM walk
//    the steps g = blockIdx.x, + gridDim.x, ...; each thread keeps its sum
//    in a register, each block writes one partial, and
//    fdag::combine_partials adds the partials in block order.
//  * The staged kernel keeps the two stages apart: the filter stage writes
//    the step's block_t contributions into shared memory (the scratch the
//    TPU kernel keeps in VMEM), and after a barrier the fold stage reads
//    them back.  block_t * 4 bytes must fit a block's shared memory.
//  * The contribution is a select, not a multiply by a 0/1 mask, so a row
//    that fails the predicate adds 0 even where x * w is NaN or inf; the
//    product is rounded on its own (no contraction into the sum), as the
//    staged kernel stores it.  The bounds arrive as float, so they compare
//    as the reference's float32 bounds do.
//  * Loads are scalar, neighbouring threads on neighbouring words, so the
//    inputs need no alignment beyond a float's.
#pragma once

#include "fused_dag.cuh"

namespace ffold {

__device__ __forceinline__ float contribution(float x, float w, float lo,
                                              float hi) {
  return (x >= lo && x < hi) ? __fmul_rn(x, w) : 0.0f;
}

// Dynamic shared memory: block_t floats when STAGED, else 32 floats of
// reduction scratch.
template <bool STAGED>
__global__ void __launch_bounds__(tcopy::THREADS)
filter_fold_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float lo, float hi, int block_t, long long steps,
                   float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* const stage = reinterpret_cast<float*>(smem4);
  float acc = 0.0f;
  for (long long g = blockIdx.x; g < steps; g += gridDim.x) {
    const float* const xg = x + g * block_t;
    const float* const wg = w + g * block_t;
    if (STAGED) {
      for (int r = threadIdx.x; r < block_t; r += blockDim.x)
        stage[r] = contribution(xg[r], wg[r], lo, hi);  // filter stage
      __syncthreads();
      for (int r = threadIdx.x; r < block_t; r += blockDim.x)
        acc += stage[r];                                 // fold stage
      __syncthreads();
    } else {
      for (int r = threadIdx.x; r < block_t; r += blockDim.x)
        acc += contribution(xg[r], wg[r], lo, hi);
    }
  }
  const float s = fdag::block_sum(acc, stage);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

}  // namespace ffold
