// fused_dag.cuh -- hand-written template of the fused pipeline megakernel.
//
// Replaces the Pallas TPU kernel lower_fused_dag / _lower_fused_dag_body
// (src/repro/core/codegen_pallas.py): one kernel per fused pipeline DAG,
// producer stages kept on chip, fold / CAM / write-once Map terminals.
//
// codegen_cuda.py instantiates this template once per DAG and plan: it
// writes the per-pattern bodies as __device__ functions, the plan's
// constants (block, depth, grid, buffer offsets, each CAM terminal's form)
// and the kernel's main loop, which calls the helpers below.
//
// What bounds it on the card: main-memory bytes.  Every pipeline input is
// read once and only the outputs are written; the bodies do a few
// operations per byte (at most ~10 for gda's outer product), far below the
// H100's ~20 fp32 FLOP per byte of HBM bandwidth.  The design therefore
// keeps every intermediate on chip and writes one partial per block
// instead of a revisited output:
//
//  * The TPU grid runs in order, so the Pallas kernel seeds its fold and
//    CAM outputs at g == 0 and revisits them.  Here the grid is persistent
//    (a few blocks per SM); block c walks steps g = c, c + gridDim.x, ...,
//    keeps its fold and CAM accumulators across its steps, and writes one
//    partial at the end.  combine_partials sums the partials in a fixed
//    block order.
//  * The metapipeline: external tiles rotate through the DEPTH shared
//    slots that memory.plan_memory charges, filled by 16-byte cp.async
//    (copy_async) DEPTH - 1 steps ahead of use.  Step s waits for its own
//    group (cp.async.wait_group DEPTH - 2), then one __syncthreads makes
//    every thread's copies of step s visible AND proves that every thread
//    has finished step s - 1; only after it is slot (s - 1) % DEPTH, the
//    slot step s - 1 read, refilled for step s + DEPTH - 1.  So no step
//    reads a slot before its copy landed, and no copy overwrites a slot a
//    body still reads.  Stage outputs rotate through their own DEPTH slots
//    (written and read inside one step, a __syncthreads after each stage).
//    Steps past GRID issue no copy but still commit an (empty) group, so
//    the wait count holds to the end.  Preloads stay synchronous.
//  * CAM terminals (keyed folds) take no atomics and sum in one fixed
//    order, the TPU kernel's one_hot(keys)^T . values on FADD: every warp
//    owns a whole private table and each of its cells has one owner lane
//    per row group.  A lane adds a row's value into accumulator j under
//    key == j, j unrolled over K (keys outside [0, K) match no j and are
//    dropped, as jax.nn.one_hot drops them).  In the register form that
//    is K x ew adds per row, below the row's bytes for every CAM the repo
//    drives (gda: 288 adds for 36 bytes, 0.036 ms of FFMA issue at
//    4,194,304 rows against 0.045 ms of bytes); a terminal whose K x ew
//    adds outweigh its bytes would be bound by them.  The register limit
//    (codegen_cuda.CAM_REG_WORDS) sends large tables to the shared form,
//    which adds each row into its own key's cells only: ew adds per row.
//    The warp's 32 lanes split as P column slots x R = 32 / P row groups
//    (codegen_cuda.cam_forms picks P):
//      - register form: a lane holds the K x ceil(ew / P) cells of its
//        slot in registers, as scalars the generator names one by one
//        (ptxas keeps an accumulator array in local memory even where
//        unrolling leaves only constant indices).  P == 1
//        needs no exchange: each lane adds its own row.  For P > 1 each
//        lane writes its row's values into a per-warp staging, P columns
//        (one piece) at a time, stage[slot][lane] with rows 32 + R words
//        apart, __syncwarp, and lane (slot, group) reads rows group,
//        group + R, ... of its column: both sides hit 32 distinct banks.
//        Staging beats shuffles here: a shuffle broadcasts one register
//        of one lane, and a warp transpose by shuffles would index the
//        row's values by the lane, which puts them on the stack.  Keys
//        travel by shuffle, once per 32 rows.  At the end a fixed
//        shuffle tree adds the R row groups.
//      - shared form, for tables too large for registers: P = 32, R = 1,
//        and each warp's table lives in its own shared region; lane l owns
//        columns l, l + 32, ... and adds into them (a plain read-modify-
//        write by one lane, no atomic).
//    At the end of the walk the warps add their tables into the block's
//    shared table in warp order (a __syncthreads between turns), and the
//    table is the block's partial: one order from row to output, so two
//    calls are bitwise equal.  The staging (and shared-form tables) sit
//    after the charged buffers: DagSpec.smem_bytes = charge + staging.
//
// The hand-written kernels that replace the other revisited-output TPU
// kernels reuse block_sum (filter_fold.cuh, groupby_fold.cuh,
// fused_kmeans.cuh) and combine_partials (launch_combine; the keyed two:
// filter_fold.cuh adds its partials in the same launch, grid_flags.cuh);
// groupby_fold.cuh and fused_kmeans.cuh take this CAM's register form
// (codegen_cuda.cam_struct_c) or a shared form of their own, and
// filter_fold.cuh and tiled_flatmap.cuh fill their rings by copy_async.
// No kernel of the port takes atomics.
#pragma once

#include "hopper.cuh"
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

// Issue the 16-byte cp.async copies of `words` floats (a multiple of 4,
// both ends 16-byte aligned); the caller commits the group.
__device__ __forceinline__ void copy_async(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int64_t words) {
  for (int64_t e = threadIdx.x; e < words / 4; e += blockDim.x)
    hop::cp_async<16>(dst + 4 * e, src + 4 * e, 16);
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

// Record `event` (a timing cudaEvent_t the caller made; null: nothing)
// on `stream`.  The launch entry points record a pair right around their
// kernel, so the pair's time is the kernel's alone.
inline int record(void* event, cudaStream_t stream) {
  return event ? (int)cudaEventRecord((cudaEvent_t)event, stream) : 0;
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
