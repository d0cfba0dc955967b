// tile_copy.cuh -- block shape, persistent block count and tile copies
// shared by the persistent kernels (fused_dag.cuh, tiled_map.cuh,
// tiled_flatmap.cuh and the hand-written filter_fold.cuh, groupby_fold.cuh,
// fused_kmeans.cuh).
//
// Each block copies its tiles from device memory into shared memory with
// all its threads, neighbouring threads on neighbouring words.  The 16-byte
// copy needs both ends 16-byte aligned: the generators emit it only where
// the tile's offsets are multiples of 4 words and the shared slot starts
// on a 16-byte boundary, and the wrappers refuse inputs that do not start
// on one (codegen_cuda._aligned).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tcopy {

constexpr int THREADS = 256;
constexpr int MAX_CTAS_PER_SM = 4;

// Opt `kernel` into the largest dynamic shared memory a block may use on
// this card.  Returns a CUDA error code.
template <typename Kernel>
int opt_in(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
}

// Blocks of `kernel` one SM holds at THREADS threads and `smem` dynamic
// shared bytes, at most MAX_CTAS_PER_SM, into *per_sm (after opt_in).
// Returns a CUDA error code.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int smem, int* per_sm) {
  int e = opt_in(kernel);
  if (e != 0) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                         THREADS, smem);
  if (e != 0) return e;
  if (*per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (*per_sm > MAX_CTAS_PER_SM) *per_sm = MAX_CTAS_PER_SM;
  return 0;
}

// Copy `words` floats (a multiple of 4, both ends 16-byte aligned).
__device__ __forceinline__ void copy_vec4(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int64_t words) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll 4
  for (int64_t e = threadIdx.x; e < words / 4; e += blockDim.x) d[e] = s[e];
}

// Copy `words` contiguous floats, any alignment.
__device__ __forceinline__ void copy_scalar(float* __restrict__ dst,
                                            const float* __restrict__ src,
                                            int64_t words) {
  for (int64_t e = threadIdx.x; e < words; e += blockDim.x) dst[e] = src[e];
}

}  // namespace tcopy
