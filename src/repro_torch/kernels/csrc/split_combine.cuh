// split_combine.cuh -- split ranges and the combine of split-key attention,
// shared by flash_attention.cuh (decode with few tiles) and paged_decode.cuh
// (flash-decoding over a request's pages).
//
// A row's keys are cut into `splits` contiguous parts of chunks; each part
// writes float32 partials (m, l, acc) of an online softmax, and
// combine_kernel merges them in split order: m = max m_i, l = sum l_i
// e^(m_i - m), acc likewise, out = acc / l (l == 0 -> 1).  A part with no
// key (m = -1e30, l = 0, acc = 0) adds exactly 0 beside a part that saw
// one; a row every part of which saw no key keeps each part's weight 1.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace splitk {

constexpr int DMAX = 128;           // the widest row the combine takes

struct Span {
  int first, count;                 // chunks [first, first + count)
};

// Part `split` of `splits` of the n chunks from `first`: the same cut as
// kernels/flash_attention.py:live_chunks and codegen_cuda.pd_split_range.
__host__ __device__ __forceinline__ Span part(int first, int n, int split,
                                              int splits) {
  const int b = first + (int)((int64_t)split * n / splits);
  const int e = first + (int)((int64_t)(split + 1) * n / splits);
  return {b, e - b};
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The split partials of each row merged in split order: one warp a row,
// lanes over the columns.  pm, pl: (splits, rows); pacc: (splits, rows, d);
// m in the natural log.
template <typename T>
__global__ void __launch_bounds__(128)
combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
               const float* __restrict__ pacc, T* __restrict__ out,
               int64_t rows, int d, int splits) {
  const int64_t row = (int64_t)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float mx = pm[row];
  for (int s = 1; s < splits; ++s) mx = fmaxf(mx, pm[s * rows + row]);
  float l = 0.0f, acc[DMAX / 32];
#pragma unroll
  for (int j = 0; j < DMAX / 32; ++j) acc[j] = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const int64_t p = s * rows + row;
    const float a = expf(pm[p] - mx);
    l += pl[p] * a;
#pragma unroll
    for (int j = 0; j < DMAX / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < d) acc[j] += pacc[p * d + c] * a;
    }
  }
  const float denom = l == 0.0f ? 1.0f : l;
#pragma unroll
  for (int j = 0; j < DMAX / 32; ++j) {
    const int c = lane + 32 * j;
    if (c < d) put(out + row * d + c, acc[j] / denom);
  }
}

// Launch on `stream`; returns a CUDA error code (d <= DMAX).
template <typename T>
int launch_combine(const float* pm, const float* pl, const float* pacc,
                   void* out, int64_t rows, int d, int splits,
                   cudaStream_t stream) {
  if (d < 1 || d > DMAX || splits < 1) return (int)cudaErrorInvalidValue;
  combine_kernel<T><<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
      pm, pl, pacc, (T*)out, rows, d, splits);
  return (int)cudaGetLastError();
}

}  // namespace splitk
