// filter_fold.cuh -- hand-written kernels of the TPC-H Q6 filter-fold:
// the float32 sum over i of (lo <= x[i] < hi ? x[i] * w[i] : 0).
//
// Replaces two Pallas TPU kernels that compute the same value:
//  * filter_reduce / _fr_kernel (src/repro/kernels/filter_reduce.py), the
//    predicate fused into the reduction: filter_fold_kernel<false, D>;
//  * fused_filter_fold / _ff_kernel (src/repro/kernels/fused_filter_fold.py),
//    a filter stage writing each tile's contributions into VMEM scratch
//    and a fold stage summing that scratch: filter_fold_kernel<true, D>.
//
// What bounds it on the card: main-memory bytes, 8 read per row for 4
// operations.  So the design keeps bytes in flight and does the whole
// call in one launch:
//
//  * The TPU grid runs its block_t-row steps in order and adds each into
//    one revisited (1, 1) output.  Here persistent blocks (as many as are
//    resident at once) walk the steps g = blockIdx.x, + gridDim.x, ...;
//    each thread keeps its sum in a register across its steps.
//  * x and w stream through a ring of DEPTH shared slots each, the plan's
//    depth, filled by cp.async DEPTH - 1 units ahead (fused_dag.cuh's
//    ring: wait for the unit's group, one __syncthreads, refill the slot
//    the previous unit read).  A unit is a step, or, where DEPTH slots of
//    a whole step do not fit a block, a fixed piece of one (`piece` rows,
//    whole float4 rounds of the block; kernels/filter_reduce.py:
//    ring_form).
//    Rows move as 16-byte copies; where a unit does not start on a
//    16-byte boundary (block_t not a multiple of 4) its head and tail
//    take 4-byte copies and the slot keeps the source's alignment, row a
//    at slot word (a & 3) + (a - start).  Threads read float4s, masking
//    the slot words outside the unit.
//  * The staged kernel keeps the two stages apart: the filter stage of
//    unit u writes its contributions (float4s) into stage slot u % DEPTH,
//    the scratch the TPU kernel keeps in VMEM, and the fold stage sums
//    that slot at unit u + 1, after the barrier that opens it; so one
//    barrier a unit, and the stage's DEPTH slots are the bytes the
//    pipeline plan charges for the intermediate.
//  * The combine is in the kernel: each block adds its threads' sums by
//    fdag::block_sum and publishes the result as a grid_flags word; block
//    0 acquires every block's word and adds them in block order, from
//    0.0f, as fdag::combine_partials did in a second launch.  One order
//    from row to output, no atomics: two calls are bitwise equal.  The
//    kernel waits on other blocks, so it goes out cooperatively.
//  * The contribution is a select, not a multiply by a 0/1 mask, so a row
//    that fails the predicate adds 0 even where x * w is NaN or inf; the
//    product is rounded on its own (no contraction into the sum), as the
//    staged kernel stores it.  The bounds arrive as float, so they compare
//    as the reference's float32 bounds do.
#pragma once

#include "fused_dag.cuh"
#include "grid_flags.cuh"

namespace ffold {

__device__ __forceinline__ float contribution(float x, float w, float lo,
                                              float hi) {
  return (x >= lo && x < hi) ? __fmul_rn(x, w) : 0.0f;
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned n;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;\n" : "=r"(n));
  return n;
}

// Issue the copies of rows [a, a + len) of src into slot words
// (a & 3) + [0, len): 16-byte cp.async for the aligned middle, 4-byte for
// a head before it and a tail after it.  The caller commits the group.
__device__ __forceinline__ void fill(float* __restrict__ slot,
                                     const float* __restrict__ src,
                                     long long a, int len) {
  const int shift = (int)(a & 3);
  const int head = min(len, (4 - shift) & 3);
  const int body = (len - head) & ~3;
  float* const dst = slot + shift;
  const float* const from = src + a;
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    hop::cp_async<4>(dst + i, from + i, 4);
  for (int e = threadIdx.x; e < body / 4; e += blockDim.x)
    hop::cp_async<16>(dst + head + 4 * e, from + head + 4 * e, 16);
  for (int i = head + body + threadIdx.x; i < len; i += blockDim.x)
    hop::cp_async<4>(dst + i, from + i, 4);
}

// The contributions of the float4 `e` of a unit's slots; slot words
// outside [lo_w, hi_w) contribute 0.
__device__ __forceinline__ float4 contributions(const float* xs,
                                                const float* ws, int e,
                                                int lo_w, int hi_w, float lo,
                                                float hi) {
  const float4 x = reinterpret_cast<const float4*>(xs)[e];
  const float4 w = reinterpret_cast<const float4*>(ws)[e];
  const int p = 4 * e;
  float4 c;
  c.x = (p >= lo_w && p < hi_w) ? contribution(x.x, w.x, lo, hi) : 0.0f;
  c.y = (p + 1 >= lo_w && p + 1 < hi_w) ? contribution(x.y, w.y, lo, hi)
                                        : 0.0f;
  c.z = (p + 2 >= lo_w && p + 2 < hi_w) ? contribution(x.z, w.z, lo, hi)
                                        : 0.0f;
  c.w = (p + 3 >= lo_w && p + 3 < hi_w) ? contribution(x.w, w.w, lo, hi)
                                        : 0.0f;
  return c;
}

struct Unit {
  long long a;  // first row
  int len;      // rows
};

__device__ __forceinline__ float add4(float acc, float4 c) {
  return acc + ((c.x + c.y) + (c.z + c.w));
}

// One block's walk.  Dynamic shared memory: x's DEPTH slots, w's DEPTH
// slots and, when STAGED, the stage's DEPTH slots, each `slot_words`
// floats, and at least a float per block (block 0 gathers the partials
// there).  Writes the sum to *out.
template <bool STAGED, int DEPTH>
__global__ void __launch_bounds__(tcopy::THREADS)
filter_fold_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float lo, float hi, int block_t, int piece,
                   int slot_words, long long steps,
                   uint64_t* __restrict__ flags, unsigned epoch,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const xs = smem;
  float* const ws = smem + DEPTH * slot_words;
  float* const stage = smem + 2 * DEPTH * slot_words;
  if (threadIdx.x == 0 &&
      ((unsigned)(4 * (STAGED ? 3 : 2) * DEPTH * slot_words) >
           dynamic_smem_bytes() ||
       4 * gridDim.x > dynamic_smem_bytes()))
    __trap();  // the host's layout and this one disagree
  const int pieces = (block_t + piece - 1) / piece;
  const long long mine =
      blockIdx.x < steps ? (steps - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long units = mine * pieces;

  // unit u of this block: rows [a, a + len) of step blockIdx.x + k * G
  auto unit = [&](long long u) {
    const long long k = u / pieces;
    const int j = (int)(u - k * pieces);
    const long long g = blockIdx.x + k * gridDim.x;
    return Unit{g * block_t + (long long)j * piece,
                min(piece, block_t - j * piece)};
  };
  auto issue = [&](long long u) {
    if (u < units) {
      const Unit n = unit(u);
      const int slot = (int)(u % DEPTH) * slot_words;
      fill(xs + slot, x, n.a, n.len);
      fill(ws + slot, w, n.a, n.len);
    }
    hop::cp_async_commit();
  };
  // the fold stage: sum the stage slot of unit u
  float acc = 0.0f;
  auto fold = [&](long long u) {
    const Unit n = unit(u);
    const float4* const s =
        reinterpret_cast<const float4*>(stage + (int)(u % DEPTH) * slot_words);
    const int n4 = ((int)(n.a & 3) + n.len + 3) >> 2;
#pragma unroll 4
    for (int e = threadIdx.x; e < n4; e += blockDim.x) acc = add4(acc, s[e]);
  };

#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) issue(s);
  for (long long u = 0; u < units; ++u) {
    hop::cp_async_wait<DEPTH - 2>();  // this thread's copies of unit u
    __syncthreads();  // everyone's landed; unit u - 1's slots are free
    issue(u + DEPTH - 1);
    const Unit n = unit(u);
    const int off = (int)(u % DEPTH) * slot_words;
    const int lo_w = (int)(n.a & 3), hi_w = lo_w + n.len;
    const int n4 = (hi_w + 3) >> 2;
    if (STAGED) {
      if (u > 0) fold(u - 1);  // written before this unit's barrier
      float4* const st = reinterpret_cast<float4*>(stage + off);
#pragma unroll 4
      for (int e = threadIdx.x; e < n4; e += blockDim.x)
        st[e] = contributions(xs + off, ws + off, e, lo_w, hi_w, lo, hi);
    } else {
#pragma unroll 4
      for (int e = threadIdx.x; e < n4; e += blockDim.x)
        acc = add4(acc, contributions(xs + off, ws + off, e, lo_w, hi_w, lo,
                                      hi));
    }
  }
  hop::cp_async_wait<0>();
  if (STAGED && units > 0) {
    __syncthreads();
    fold(units - 1);
  }

  // the combine: block sums published, block 0 adds them in block order
  const float s = fdag::block_sum(acc, smem);  // valid in thread 0
  if (blockIdx.x != 0) {
    if (threadIdx.x == 0)
      gflags::publish(flags + blockIdx.x,
                      gflags::word(epoch, gflags::AGGREGATE,
                                   __float_as_uint(s)));
    return;
  }
  __syncthreads();  // block_sum's scratch is read; smem holds the partials
  if (threadIdx.x < 32) {
    for (unsigned c = 1 + threadIdx.x; c < gridDim.x; c += 32)
      smem[c] = __uint_as_float(
          gflags::value_of(gflags::wait(flags + c, epoch, gflags::ANY)));
    __syncwarp();
    if (threadIdx.x == 0) {
      float t = 0.0f + s;
      for (unsigned c = 1; c < gridDim.x; ++c) t += smem[c];
      *out = t;
    }
  }
}

}  // namespace ffold
