// nearest_dag.cuh -- hand-written template of a fused DAG whose producer
// stage is an argmin over the rows of a table too large to stage whole
// (k-means' assignment at MNIST8m's 256 x 784 centroids: 803 KB), and of
// the keyed sum of rows it feeds when that table is wider than a block's
// shared memory.
//
// codegen_cuda.nearest_source instantiates it once per DAG and plan
// (memory.nearest_layout: BM query rows a grid step, KT table rows a
// tile, a TM x TN block of distances a thread, DEPTH ring slots) and
// writes the DAG's other terminals (fused_dag.cuh's CAM forms) into the
// assignment kernel's epilogue.
//
// What bounds it on the card: operations.  A step of the source's shape
// does 2 * n * K * D = 3.25e12 multiply-adds' worth of FLOP on 25.4 GB
// of points, 48.7 ms at the float32 (FFMA) rate against 7.6 ms of bytes.
// The design:
//
//  * assign_kernel, persistent (a block per SM): for each grid step of BM
//    query rows, the table in tiles of KT rows (the paper's strip-mined
//    inner fold); for each tile, D in slabs of SLAB dimensions.  Each
//    (tile, slab) pair of the block's whole walk is one ring step: the
//    query rows' slab and the tile's slab, 16-byte cp.async copies into
//    one of DEPTH slots, DEPTH - 1 steps ahead (fused_dag.cuh sets out
//    why one wait and one __syncthreads a step make the ring safe).
//    Rows past the table or dimensions past D are zero-filled.
//  * The distance is ||c||^2 - 2 x.c (||x||^2 is the same for every c, so
//    the argmin does without it), float32 throughout, no tensor cores.  A
//    thread holds TM x TN dot products in registers, query rows ty + i*TY
//    and table rows tx + q*TX of the tile; it loads four dimensions of a
//    row per LDS.128, so TM + TN shared loads feed 4 * TM * TN FFMA (1 per
//    16 at 8 x 8).  Rows are padded by PAD words: the eight lanes of an
//    LDS.128 phase hit distinct banks.
//  * The table's row norms are computed once per block into shared memory
//    (a warp a row, its lanes' partial sums added by a fixed shuffle tree).
//  * After a tile, each thread takes its TN scores' first minimum per row
//    (in increasing table row), the TX lanes sharing the row take the
//    smallest (score, row) pair by a shuffle tree, and the tile's winner
//    replaces the running one only if strictly smaller: ties go to the
//    first row, whatever the tiling.  The key lands in the stage slot
//    (and, for the fold, in a global array), then the epilogue runs the
//    DAG's other terminals over the step's rows.
//  * fold_kernel: the keyed sum of rows by (row chunk x column slice)
//    units, persistent blocks of COLS threads walking units in a fixed
//    order.  A unit's table slice (K x COLS words) lives in shared memory;
//    lane l of warp w owns column 32 w + l of every key, so no two threads
//    touch one cell and no atomic is needed.  Rows and their keys stream
//    through a ring of FROWS rows, as deep as fits (a streaming pass
//    needs its bytes in flight); each lane adds its column of 16 rows at
//    a time: it loads the cells of the batch's distinct keys at once and
//    adds a row of a key already seen in the batch onto that row's sum
//    (one lane a batch finds the links, a ballot and shuffles hand them
//    on; a batch of distinct keys skips them), so each cell takes its
//    rows in row order and only rows of one key wait on each other,
//    however skewed the clusters.  A unit writes its slice of chunk's partial
//    table; combine_partials adds the chunks in order.  So every sum has
//    one order from row to output, and two calls are bitwise equal.
#pragma once

#include <math.h>

#include "fused_dag.cuh"

namespace ndag {

constexpr int THREADS = 256;   // memory.NEAREST_THREADS
constexpr int FROWS = 64;      // memory.FOLD_ROWS

// Four consecutive words (16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

template <int BM, int KT, int TM, int TN, int DEPTH, int K, int D,
          int SLAB, int PAD>
struct Assign {
  static constexpr int TX = KT / TN, TY = BM / TM;
  static constexpr int AS = SLAB + PAD;             // staged row stride
  static constexpr int SLOT = (BM + KT) * AS;       // words of a ring slot
  static constexpr int TILES = (K + KT - 1) / KT;
  static constexpr int SLABS = (D + SLAB - 1) / SLAB;
  static constexpr int SUB = TILES * SLABS;         // ring steps a grid step
  static constexpr int NORMS = TILES * KT;
  // ring, row norms, the stage's keys
  static constexpr int WORDS = DEPTH * SLOT + NORMS + BM;
  static_assert(TX * TY == THREADS, "a thread per TM x TN block");
  static_assert(TX <= 32 && (TX & (TX - 1)) == 0, "a row's lanes in a warp");
  static_assert(D % 4 == 0 && SLAB % 4 == 0, "16-byte rows");
  static_assert((AS / 4) % 2 == 1, "rows an odd number of 16-byte pieces");

  // Issue the copies of ring step (grid step g, sub-step u) into `slot`.
  static __device__ __forceinline__ void issue(float* slot,
                                               const float* __restrict__ x,
                                               const float* __restrict__ c,
                                               long long g, int u) {
    const int t = u / SLABS, d0 = (u % SLABS) * SLAB;
    constexpr int Q = SLAB / 4;   // 16-byte pieces of a slab row
    for (int e = threadIdx.x; e < (BM + KT) * Q; e += THREADS) {
      const int r = e / Q, a = d0 + (e % Q) * 4;
      const bool table = r >= BM;
      const long long row = table ? (long long)t * KT + (r - BM)
                                  : g * BM + r;
      const bool ok = a < D && (!table || row < K);
      const float* src = (table ? c : x) + (ok ? row * D + a : 0);
      hop::cp_async<16>(slot + r * AS + (e % Q) * 4, src, ok ? 16 : 0);
    }
  }

  // ||c||^2 of every table row into norms[0, NORMS) (0 past K).
  static __device__ void row_norms(const float* __restrict__ c,
                                   float* norms) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < NORMS; r += THREADS / 32) {
      float s = 0.0f;
      if (r < K)
        for (int a = lane; a < D; a += 32) s = fmaf(c[(long long)r * D + a],
                                                    c[(long long)r * D + a],
                                                    s);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) norms[r] = s;
    }
  }

  // The block's walk over its grid steps: each step's keys into `keys`
  // (shared, BM words) and, if given, `keys_out` (global), then
  // epilogue(g) with every thread past a __syncthreads.
  template <typename Epilogue>
  static __device__ __forceinline__ void walk(const float* __restrict__ x,
                              const float* __restrict__ c, float* smem,
                              long long grid, float* __restrict__ keys_out,
                              Epilogue&& epilogue) {
    float* const norms = smem + DEPTH * SLOT;
    float* const keys = norms + NORMS;
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
    const long long steps =
        blockIdx.x < grid ? (grid - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const long long total = steps * SUB;
    auto issue_at = [&](long long j) {
      issue(smem + (j % DEPTH) * SLOT, x, c,
            blockIdx.x + (j / SUB) * gridDim.x, (int)(j % SUB));
    };
#pragma unroll
    for (int s = 0; s < DEPTH - 1; ++s) {
      if (s < total) issue_at(s);
      hop::cp_async_commit();
    }
    row_norms(c, norms);
    long long j = 0;
    for (long long gi = 0; gi < steps; ++gi) {
      const long long g = blockIdx.x + gi * gridDim.x;
      float best[TM];
      int arg[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        best[i] = INFINITY;
        arg[i] = 0;
      }
      for (int t = 0; t < TILES; ++t) {
        float acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q) acc[i][q] = 0.0f;
        for (int s = 0; s < SLABS; ++s, ++j) {
          hop::cp_async_wait<DEPTH - 2>();  // this thread's copies of j
          __syncthreads();  // everyone's landed; j - 1's slot is free
          if (j + DEPTH - 1 < total) issue_at(j + DEPTH - 1);
          hop::cp_async_commit();
          const float* xs = smem + (j % DEPTH) * SLOT;
          const float* cs = xs + BM * AS;
#pragma unroll
          for (int kk = 0; kk < SLAB; kk += 4) {
            float a[TM][4], b[TN][4];
#pragma unroll
            for (int i = 0; i < TM; ++i) load4(xs + (ty + i * TY) * AS + kk,
                                               a[i]);
#pragma unroll
            for (int q = 0; q < TN; ++q) load4(cs + (tx + q * TX) * AS + kk,
                                               b[q]);
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int q = 0; q < TN; ++q)
                  acc[i][q] = fmaf(a[i][e], b[q][e], acc[i][q]);
          }
        }
        // the tile's first minimum per row, then the running one
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float bs = INFINITY;
          int bc = 0x7fffffff;
#pragma unroll
          for (int q = 0; q < TN; ++q) {
            const int r = t * KT + tx + q * TX;
            const float sc = fmaf(-2.0f, acc[i][q], norms[r]);
            if (r < K && sc < bs) {
              bs = sc;
              bc = r;
            }
          }
#pragma unroll
          for (int o = 1; o < TX; o <<= 1) {
            const float os = __shfl_xor_sync(0xffffffffu, bs, o);
            const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
            if (os < bs || (os == bs && oc < bc)) {
              bs = os;
              bc = oc;
            }
          }
          if (bs < best[i]) {
            best[i] = bs;
            arg[i] = bc;
          }
        }
      }
      if (tx == 0)
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          keys[ty + i * TY] = (float)arg[i];
          if (keys_out) keys_out[g * BM + ty + i * TY] = (float)arg[i];
        }
      __syncthreads();
      epilogue(g, keys);
    }
    hop::cp_async_wait<0>();
  }
};

template <int K, int D, int COLS, int DEPTH, int CHUNKS>
struct Fold {
  static constexpr int SLICES = (D + COLS - 1) / COLS;
  static constexpr int UNITS = CHUNKS * SLICES;
  static constexpr int SLOT = FROWS * COLS + FROWS;   // rows, then keys
  static constexpr int WORDS = K * COLS + DEPTH * SLOT;
  static_assert(COLS % 32 == 0 && COLS <= 128, "a warp per 32 columns");
  static_assert(D % 4 == 0, "16-byte rows");

  // Rows of a chunk: whole ring slots, the last chunk ragged.
  static __host__ __device__ long long chunk_rows(long long n) {
    const long long per = (n + CHUNKS - 1) / CHUNKS;
    return (per + FROWS - 1) / FROWS * FROWS;
  }

  // Issue the copies of rows [r0, r0 + FROWS) (those below r1) of
  // columns [c0, c0 + cw) and of their keys into `slot`.  FULL: cw == COLS,
  // so the piece's row and column are shifts.
  template <bool FULL>
  static __device__ __forceinline__ void issue(float* slot,
                                               const float* __restrict__ x,
                                               const float* __restrict__ keys,
                                               long long r0, long long r1,
                                               int c0, int cw) {
    const int q = FULL ? COLS / 4 : cw / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < FROWS * q; e += COLS) {
      const int r = e / q, a = (e % q) * 4;
      const bool ok = r0 + r < r1;
      hop::cp_async<16>(slot + r * COLS + a,
                        x + (ok ? (r0 + r) * D + c0 + a : 0), ok ? 16 : 0);
    }
    for (int e = threadIdx.x; e < FROWS / 4; e += COLS) {
      const bool ok = r0 + 4 * e < r1;   // r0 and r1 are multiples of 4
      hop::cp_async<16>(slot + FROWS * COLS + 4 * e,
                        keys + (ok ? r0 + 4 * e : 0), ok ? 16 : 0);
    }
  }

  // A slot's keys as table rows, -1 for a row past `live` or a key
  // outside [0, K).
  static __device__ __forceinline__ int key_of(const float* ks, int r,
                                               int live) {
    const int k = (int)ks[r];
    return (r < live && (unsigned)k < (unsigned)K) ? k : -1;
  }

  // Add rows [0, live) of a slot into the table: each lane its column
  // (the whole warp calls; a lane past the unit's columns adds nothing),
  // BATCH rows at a time, every cell taking its rows in row order.  Lane
  // b < FROWS / BATCH first finds, for each row i of batch b, the latest
  // earlier row of the batch with the same key (i itself where none: 4
  // bits a row, packed in two words); a ballot tells every lane which
  // batches repeat a key, and shuffles hand it those batches' words.  A
  // batch loads the cells of its keys' first rows at once and adds its
  // rows, a repeated key's row onto the earlier row's sum, so only rows of
  // one key wait on each other; it stores in row order, a key's last row
  // last.
  static constexpr int BATCH = 16;
  static __device__ __forceinline__ void add_rows(float* table,
                                                  const float* rows,
                                                  const float* ks, int live,
                                                  int col, bool mine) {
    static_assert(FROWS % BATCH == 0 && FROWS / BATCH <= 32 && BATCH == 16,
                  "a lane per batch, 4 bits a row");
    const int lane = threadIdx.x & 31;
    unsigned links[2] = {0u, 0u};   // rows 0-7, 8-15 of the lane's batch
    bool dup = false;
    if (lane < FROWS / BATCH) {
      int key[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        key[i] = key_of(ks, BATCH * lane + i, live);
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        unsigned prev = i;
#pragma unroll
        for (int p = 0; p < i; ++p)
          if (key[i] >= 0 && key[p] == key[i]) prev = p;
        dup |= prev != (unsigned)i;
        links[i / 8] |= prev << (4 * (i % 8));
      }
    }
    const unsigned dups = __ballot_sync(0xffffffffu, dup);
#pragma unroll 1
    for (int b = 0; b < FROWS; b += BATCH) {
      int key[BATCH];
      float cell[BATCH];
      if (!((dups >> (b / BATCH)) & 1u)) {   // warp-uniform: distinct keys
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          key[i] = mine ? key_of(ks, b + i, live) : -1;
          cell[i] = key[i] >= 0 ? table[key[i] * COLS + col] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) cell[i] += rows[(b + i) * COLS + col];
      } else {
        const unsigned w[2] = {
            __shfl_sync(0xffffffffu, links[0], b / BATCH),
            __shfl_sync(0xffffffffu, links[1], b / BATCH)};
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          key[i] = mine ? key_of(ks, b + i, live) : -1;
          const int prev = (w[i / 8] >> (4 * (i % 8))) & 15;
          cell[i] = (key[i] >= 0 && prev == i) ? table[key[i] * COLS + col]
                                               : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          const int prev = (w[i / 8] >> (4 * (i % 8))) & 15;   // uniform
          if (prev != i) {
#pragma unroll
            for (int p = 0; p < i; ++p)
              if (prev == p) cell[i] = cell[p];
          }
          cell[i] += rows[(b + i) * COLS + col];
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        if (key[i] >= 0) table[key[i] * COLS + col] = cell[i];
    }
  }

  // partials[chunk][key][column] for every unit the block walks.
  static __device__ void walk(const float* __restrict__ x,
                              const float* __restrict__ keys, long long n,
                              float* __restrict__ partials, float* smem) {
    float* const table = smem;
    float* const ring = smem + K * COLS;
    const long long per = chunk_rows(n);
    const int col = threadIdx.x;
    for (int unit = blockIdx.x; unit < UNITS; unit += gridDim.x) {
      const int chunk = unit / SLICES, c0 = (unit % SLICES) * COLS;
      const int cw = D - c0 < COLS ? D - c0 : COLS;
      const long long r0 = chunk * per;
      const long long r1 = r0 + per < n ? r0 + per : n;
      const long long steps = r1 > r0 ? (r1 - r0 + FROWS - 1) / FROWS : 0;
      for (int e = threadIdx.x; e < K * COLS; e += COLS) table[e] = 0.0f;
      const bool full = cw == COLS;
      auto issue_at = [&](long long st) {
        float* slot = ring + st % DEPTH * SLOT;
        if (full)
          issue<true>(slot, x, keys, r0 + st * FROWS, r1, c0, cw);
        else
          issue<false>(slot, x, keys, r0 + st * FROWS, r1, c0, cw);
      };
#pragma unroll
      for (int s = 0; s < DEPTH - 1; ++s) {
        if (s < steps) issue_at(s);
        hop::cp_async_commit();
      }
      for (long long st = 0; st < steps; ++st) {
        hop::cp_async_wait<DEPTH - 2>();
        __syncthreads();
        if (st + DEPTH - 1 < steps) issue_at(st + DEPTH - 1);
        hop::cp_async_commit();
        const float* rows = ring + st % DEPTH * SLOT;
        const float* ks = rows + FROWS * COLS;
        const long long left = r1 - (r0 + st * FROWS);
        const int live = left < FROWS ? (int)left : FROWS;
        if (32 * (col / 32) < cw)   // warp-uniform
          add_rows(table, rows, ks, live, col, col < cw);
      }
      hop::cp_async_wait<0>();
      __syncthreads();
      float* part = partials + (long long)chunk * K * D + c0;
      if (col < cw)
        for (int k = 0; k < K; ++k) part[(long long)k * D + col] =
            table[k * COLS + col];
      __syncthreads();
    }
  }
};

}  // namespace ndag
