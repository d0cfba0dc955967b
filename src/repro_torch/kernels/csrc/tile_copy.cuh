// tile_copy.cuh -- block shape and tile copies shared by the persistent
// templates (fused_dag.cuh, tiled_map.cuh, tiled_flatmap.cuh).
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
