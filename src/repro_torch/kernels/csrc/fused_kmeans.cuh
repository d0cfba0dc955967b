// fused_kmeans.cuh -- hand-written megakernel of one k-means step: each
// point's nearest centroid, then the per-centroid sums of its points and
// their counts.
//
// Replaces the Pallas TPU kernel fused_kmeans_step / _km_kernel
// (src/repro/kernels/fused_kmeans.py): the assign -> {sum, count} DAG as
// one kernel with two outputs, the assignment kept in VMEM scratch.
//
// What bounds it on the card: in principle main-memory bytes (4d read per
// point for about 3kd operations); in this first version the k * d
// distance terms per point and the d + 1 shared atomics per point.
//
//  * The TPU grid revisits both outputs across its sequential steps.  Here
//    a few persistent blocks per SM walk the block_n-point steps g =
//    blockIdx.x, + gridDim.x, ...; each block adds into its own (k, d) sums
//    and (k,) counts in shared memory (fdag::cam_add and shared atomics),
//    writes them out as one partial of k * d + k words, and
//    fdag::combine_partials adds the partials in block order.
//  * The centroids are copied into shared memory once per block (the
//    Pipe-0 preload).  Each step copies its points tile into shared memory
//    once (rows padded to an odd stride, so a warp reading one word of 32
//    rows hits 32 banks); the assign stage writes each point's nearest
//    centroid into a shared block_n int32 buffer (the fan-out
//    intermediate, computed once per tile), and after a barrier both
//    terminals read it.
//  * The squared distance is summed over d in index order, one multiply
//    and one add per term, no fused multiply-add, as the port's kmeans
//    bodies and references sum it: the kernel, its plain version and the
//    reference agree bitwise on the assignment.  Ties go to the lowest
//    index, as argmin gives.
//  * Loads are scalar, so the inputs need no alignment beyond a float's.
#pragma once

#include "fused_dag.cuh"

namespace fkm {

// Dynamic shared memory, in words: centroids k*d, sums k*d, counts k, the
// points tile block_n*(d | 1), the assignment block_n (fused_kmeans.py's
// smem_bytes).
__global__ void __launch_bounds__(tcopy::THREADS)
fused_kmeans_kernel(const float* __restrict__ points,
                    const float* __restrict__ cents, int k, int d,
                    int block_n, long long steps,
                    float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  const int stride = d | 1;
  float* const c_s = reinterpret_cast<float*>(smem4);   // [k][d]
  float* const sums = c_s + k * d;                      // [k][d]
  float* const counts = sums + k * d;                   // [k]
  float* const tile = counts + k;                       // [block_n][stride]
  int* const assign =                                  // [block_n]
      reinterpret_cast<int*>(tile + (long long)block_n * stride);

  tcopy::copy_scalar(c_s, cents, (int64_t)k * d);
  fdag::zero(sums, (int64_t)k * d + k);
  __syncthreads();
  for (long long g = blockIdx.x; g < steps; g += gridDim.x) {
    const float* const pg = points + g * block_n * d;
    for (int e = threadIdx.x; e < block_n * d; e += blockDim.x) {
      const int r = e / d;
      tile[r * stride + (e - r * d)] = pg[e];
    }
    __syncthreads();
    // stage: the nearest centroid of each point of the tile
    for (int r = threadIdx.x; r < block_n; r += blockDim.x) {
      const float* const p = tile + r * stride;
      float best = INFINITY;
      int arg = 0;
      for (int c = 0; c < k; ++c) {
        float s = 0.0f;
        for (int a = 0; a < d; ++a) {
          const float t = c_s[c * d + a] - p[a];
          s = __fadd_rn(s, __fmul_rn(t, t));
        }
        if (s < best) {  // first minimum
          best = s;
          arg = c;
        }
      }
      assign[r] = arg;
    }
    __syncthreads();
    // terminals: both read the assignment
    for (int r = threadIdx.x; r < block_n; r += blockDim.x) {
      const int c = assign[r];
      fdag::cam_add(sums, c, k, tile + r * stride, d);
      atomicAdd(counts + c, 1.0f);
    }
    __syncthreads();
  }
  float* const part = partials + (long long)blockIdx.x * (k * d + k);
  for (int e = threadIdx.x; e < k * d + k; e += blockDim.x) part[e] = sums[e];
}

}  // namespace fkm
