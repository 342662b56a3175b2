// K2 and K4 on Hopper: the coverage matvec pair of the kind and packed
// power iterations, both partitions and both directions of a step in
// one launch; and, for kind_precision="int8", a launch that finds a
// window's quantization scales (`quantize_amax`), off the main path: the
// set-up's launch writes the first step's scales (csrc/rank_setup.cu,
// its kScales instances) and the power-iteration step's kernel every
// later step's (csrc/power_step.cu, in its own pass).
//
// Replaces device programs that XLA wrote for the TPU in
// microrank_tpu/rank_backends/jax_tpu.py (`_partition_setup`):
//   K2, the kind branch's `cov_pair` (544-576): M is the 0/1 coverage
//       pattern [V, K] over the kind-collapsed columns, which XLA held as
//       int8 and cast once to f32 or bf16 (558-576), or kept in int8 and
//       multiplied with int8-quantized operands, summing in int32
//       (544-556, `quantize_i8` 96-109: K2-int8);
//   K4, the packed branch's coverage pair (419-480): M is the coverage
//       bitmap uint8 [V, ceil(T/8)], unpacked once per program into a
//       dense f32 / bf16 [V, T] matrix (`unpack_bits`, 112-123).
// K8, the packed_blocked branch (605-646, `_blocked_bits_matvecs` 208),
// is K4's function in f32 on windows whose unpacked matrices exceed the
// dense budget: XLA streamed column blocks of the bitmap so as never to
// hold the whole unpacked matrix. It has a kernel of its own below
// (`pattern_pair_blocked`), made for those shapes: thousands of rows,
// hundreds of thousands of columns, about 0.2% of bits set.
// All compute, per partition,
//   y_fwd[r] = sum_c M[r, c] * op(rv[c] * w_len[c])    (p_sr @ rv)
//   y_bwd[c] = sum_r op(sv[r] * w_cov[r]) * M[r, c]    (p_rs @ sv)
// with op, by precision:
//   f32:  the identity, f32 sums;
//   bf16: round-to-nearest-even to bf16 of the f32 product, as JAX's
//         `.astype(bfloat16)` does (kind_precision="bf16", packed_bf16),
//         f32 sums;
//   int8: q = clip(rint(x / scale), -127, 127) with the operand's scale
//         (`quantize_amax` below), int32 sums, and the sum turned back
//         into f32 once per output: y = scale * f32(sum).
// The packed branch also needs op(sv * w_out) for its call-graph term;
// the row folds write it as a side output (`x_ss`), which K1 then reads.
//
// One layout. Every pattern reaches this kernel as a big-endian bitmap
// (np.packbits order: column c is bit 7 - (c & 7) of byte c >> 3) whose
// rows are padded with zero bytes to a multiple of 16 bytes: the kind
// build's `cov_bits` and the packed build's are the same bitmap, and
// ops/pattern.py `pattern_group` copies each into this row layout.
//
// What bounds it on the card: bytes and latency, not the tensor cores.
// M is 0/1, so a product is a select and each cell costs at most one add;
// a matrix-vector product gives `wgmma` or the int8 `mma` no reuse to
// work with. The bytes are the bitmap (2.9 MB at the uncollapsed config-5
// shapes, 48 KB for the collapsed kind pattern) plus the vectors: about
// 1 us at 3.35 TB/s. What is left is latency: one global round trip for
// the tile, one for the operands, a fence and an atomic, one round trip
// per batch of a fold. int8 adds, per operand, a flush compare and one
// division, and no launch of its own: the scales come with the set-up's
// and the step's launches.
//
// The grid: one block of 256 threads per tile of kTileRows = 128 rows x
// kTileCols = 512 columns (64 bytes of each row, 8 KB), the tiles of both
// partitions in one grid. A block
//   1. loads its tile with two 16-byte loads per thread into shared
//      memory, turning each word into column order (bit i of word w is
//      column 32w + i of the tile);
//   2. computes its 512 column operands op(rv * w_len) and its 128 row
//      operands op(sv * w_cov) once, into shared memory;
//   3. fwd partial: warp w takes rows w, w + 8, ...; lane l sums the
//      tile's columns 16l .. 16l + 15 in ascending order, then the shuffle
//      tree 16, 8, 4, 2, 1 (K1's) gives the row's tile sum;
//   4. bwd partial: thread t sums columns 2t and 2t + 1 over the tile's
//      rows in ascending order;
//   5. stores its partials; a block-level last-arriver fold (K1's, and
//      CUDA's threadFenceReduction sample) then finishes them: the last
//      block of a row stripe folds the stripe's column-tile partials left
//      to right and writes y_fwd (and x_ss); the last block of a column
//      stripe folds the row-tile partials top to bottom and writes y_bwd.
//      A stripe of one tile writes its result directly.
// Every order depends on the column index (fwd) or the row index (bwd)
// alone, so equal pattern rows give bitwise-equal y_fwd and equal columns
// bitwise-equal y_bwd; the plain version in ops/pattern.py repeats it.
// (int8 sums are exact, so their order does not matter at all.) There are
// no float atomics. Each block reads exactly one tile once, so there is
// no later load for an asynchronous copy (cp.async, TMA) to overlap
// with: the block's loads are all issued before its first use. (K8's
// kernel walks many tiles a block, and does overlap them.)
//
// Stacked windows (a group of B windows padded to one shape, as
// run(batch_windows=True) and dispatch_batch_windows rank them): the
// grid's y dimension is the window. Each window has its own pattern,
// vectors, outputs, tile partials and stripe counters (int8: its own two
// scales a part), at a fixed stride from the previous window's
// (`window_part`), so its last-arriver folds count and fold its own
// tiles only and its bits are those of the window launched alone. One
// launch a step for the whole group, in every precision; K8's two
// launches and `quantize_amax` take the window axis the same way.
//
// The int8 scales (`quantize_amax`): scale = amax > 0 ? amax / 127 : 1
// with amax = max |x * w| over each of the step's four weighted operands
// (both partitions, both directions), as JAX's `quantize_i8`; a
// subnormal product counts as 0 there and in the quantization, and a
// subnormal quotient amax / 127 gives scale 0 (its operands then
// quantize to +-127, a 0 operand to 0), as XLA's CPU flushes both
// (`flush_subnormal`). A NaN amax
// fails `amax > 0` and gives 1, as there. One launch covers the four
// vectors: each block takes a strided slice of one vector, reduces the
// bit patterns of |x * w| (non-negative floats order as their unsigned
// bits; a NaN's bits exceed every number's, so it wins as jnp.max's NaN
// does) and folds them in with an integer atomicMax, which is exact and
// order-free; the last block to arrive turns the four maxima into
// scales and resets the scratch for the next launch. A stacked group's
// launch takes every window's four operands, a maximum and a scale per
// operand and window (JAX's `quantize_i8` under vmap), so a window's NaN
// or zeros reach its own scales only. The main path no longer launches
// it: the set-up's one launch folds the same keys of the start vectors
// it writes (csrc/rank_setup.cu `amax_key`, `scale_of`, integer maxima
// through its tree's barriers or its grid barrier, no scratch to reset),
// the step kernel every later step's. It stays as ops/pattern.py
// `quantize_scales` for the tests and the set-up's turns in chip_smoke.
//
// __fmul_rn / __fadd_rn / __fdiv_rn keep the compiler from contracting
// into FMAs or approximating the division, so the plain version repeats
// this arithmetic exactly; rintf rounds half to even, as jnp.round and
// torch.round do. Adding a product of a 0 cell would add +0.0 (or 0),
// which leaves a sum's bits unchanged (a float sum that starts at +0.0
// is never -0.0), so selecting 0 gives the same bits.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/pattern.py build_command; no --use_fast_math, and nvcc's default
// -prec-div=true); bound with ctypes (plain C interface).

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kTileRows = 128;                       // ops/pattern.py TILE_R
constexpr int kTileCols = 512;                       // ops/pattern.py TILE_C
constexpr int kChunk = 16;                           // bytes per load; ROW_ALIGN
constexpr int kTileWords = kTileCols / 32;           // 32-bit words of a tile row
constexpr int kChunksPerRow = kTileCols / 8 / kChunk;
constexpr int kLaneCols = kTileCols / kWarp;         // fwd columns per lane
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kColsPerThread = kTileCols / kThreads; // bwd columns per thread
constexpr int kLoadsPerThread = kTileRows * kChunksPerRow / kThreads;
constexpr int kRowBatch = 8;                         // fwd rows a warp sums side by side
constexpr int kFoldBatch = 16;                       // partials a fold loads together
constexpr int kMaxParts = 2;
constexpr int kMaxVecs = 2 * kMaxParts;              // int8 operands per step
constexpr int kAmaxItems = 8;                        // elements per thread per block slice
constexpr int kAmaxMaxBlocks = 64;                   // blocks per vector, at most
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTileRows <= kThreads, "a fold thread per tile row");

// Floats per row of K8's fwd partials: n_ct rounded up to 4, so that
// every row starts 16-byte aligned (ops/pattern.py blocked_ld).
__host__ __device__ __forceinline__ int32_t blocked_ld(int32_t n_ct) { return (n_ct + 3) & ~3; }
static_assert(kColsPerThread == 2, "bwd partials are stored as pairs");
static_assert(kTileRows * kChunksPerRow % kThreads == 0, "whole loads per thread");
static_assert(kRowsPerWarp % kRowBatch == 0, "whole row batches per warp");

// Operand precisions (ops/pattern.py PRECISIONS, in order).
enum Prec { kF32 = 0, kBf16 = 1, kI8 = 2 };

// What a step sums in: f32, or exact int32 for the int8 operands.
template <int kPrec>
using Acc = typename std::conditional<kPrec == kI8, int32_t, float>::type;

template <typename T> struct Two;
template <> struct Two<float> { using type = float2; };
template <> struct Two<int32_t> { using type = int2; };

// One partition's pattern, vectors and scratch (ops/pattern.py
// PatternPart / pattern_pair_group).
struct Part {
  const uint8_t* pat;     // [n_rows, stride] bitmap rows
  const float* rv;        // [n_cols]
  const float* w_len;     // [n_cols]
  const float* sv;        // [n_rows]
  const float* w_cov;     // [n_rows]
  const float* w_out;     // [n_rows], or null: no x_ss
  const float* scale;     // int8: [2], the fwd and bwd operands' scales; else null
  int32_t scale_step;     // int8: floats from a window's scales to the next's (2 per part)
  float* y_fwd;           // [n_rows]
  float* y_bwd;           // [n_cols]
  float* x_ss;            // [n_rows], or null
  float* fwd_part;        // [n_ct, n_rt * kTileRows] row sums of each column tile
  float* bwd_part;        // [n_rt, n_ct * kTileCols] column sums of each row tile
  int32_t* row_count;     // [n_rt] arrivals per row stripe, 0 between launches
  int32_t* col_count;     // [n_ct] arrivals per column stripe, 0 between launches
  int64_t stride;         // bytes per pattern row, a multiple of kChunk
  int32_t n_rows;
  int32_t n_cols;
  int32_t n_rt;           // row tiles (>= 1)
  int32_t n_ct;           // column tiles (>= 1)
  int32_t blocks;         // n_rt * n_ct (K8: n_ct * groups)
  int32_t rows_per_block; // K8: row tiles a block walks
  int32_t groups;         // K8: blocks a column tile, ceil(n_rt / rows_per_block)
};

struct Args {
  Part p[kMaxParts];
};

template <typename T>
struct alignas(16) Smem {
  uint32_t bits[kTileRows][kTileWords];  // bit i of word w: column 32w + i
  T a[kTileCols];                        // op(rv * w_len), 0 past n_cols
  T b[kTileRows];                        // op(sv * w_cov), 0 past n_rows
  T y_rows[kTileRows];                   // the tile's fwd sum of each row
  int last[2];                           // last arriver of the row / column stripe
};

// A subnormal as +0, as XLA's CPU flushes it where JAX's `quantize_i8`
// runs (an explicit compare: the library is not built with -ftz, which
// would change every other kernel in it). NaN fails the compare and
// stays NaN.
__device__ __forceinline__ float flush_subnormal(float p) {
  return fabsf(p) < FLT_MIN ? 0.0f : p;
}

// op(x * w) in the precision's operand type; `scale` is read for int8
// only (the product flushed first).
template <int kPrec>
__device__ __forceinline__ Acc<kPrec> operand(float x, float w, float scale) {
  const float p = __fmul_rn(x, w);
  if constexpr (kPrec == kBf16) {
    return __bfloat162float(__float2bfloat16_rn(p));
  } else if constexpr (kPrec == kI8) {
    // A 0 operand is q 0 on every scale: on a flushed (0) scale 0 / 0
    // would be NaN, which fmaxf would turn into -127 (XLA's int8 cast
    // gives 0), and every other operand goes to +-127 there.
    const float f = flush_subnormal(p);
    if (f == 0.0f) return 0;
    return static_cast<int32_t>(fminf(fmaxf(rintf(__fdiv_rn(f, scale)), -127.0f), 127.0f));
  } else {
    return p;
  }
}

// A sum back in f32: int8 sums are scaled once, here.
template <int kPrec>
__device__ __forceinline__ float finish(Acc<kPrec> y, float scale) {
  if constexpr (kPrec == kI8) {
    return __fmul_rn(scale, __int2float_rn(y));
  } else {
    return y;
  }
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) { return a + b; }

// A loaded word of big-endian bytes in column order: bit 8k + j of the
// result is bit 7 - j of byte k (column 8k + j).
__device__ __forceinline__ uint32_t column_order(uint32_t w) {
  return __brev(__byte_perm(w, 0u, 0x0123u));
}

// Adds b to acc when bit k of m is set. A select, not a branch: a
// branch per cell would keep the compiler from issuing later loads
// ahead of it. Adding zero leaves the sum's bits unchanged.
template <typename T>
__device__ __forceinline__ T add_if(T acc, uint32_t m, int k, T b) {
  return add(acc, ((m >> k) & 1u) ? b : T(0));
}

// Folds n partials p[0], p[step], ... left to right from 0, loading a
// batch at a time from L2 (L1 is not coherent across SMs): one row's
// column-tile sums (fwd).
template <typename T>
__device__ __forceinline__ T fold(const T* p, int64_t step, int32_t n) {
  T y = T(0);
  for (int32_t j0 = 0; j0 < n; j0 += kFoldBatch) {
    T v[kFoldBatch];
#pragma unroll
    for (int i = 0; i < kFoldBatch; ++i) v[i] = __ldcg(p + min(j0 + i, n - 1) * step);
#pragma unroll
    for (int i = 0; i < kFoldBatch; ++i) {
      if (j0 + i < n) y = add(y, v[i]);
    }
  }
  return y;
}

// The same for two columns' row-tile sums (bwd).
template <typename T, typename T2 = typename Two<T>::type>
__device__ __forceinline__ T2 fold2(const T2* p, int64_t step, int32_t n) {
  T2 y;
  y.x = T(0);
  y.y = T(0);
  for (int32_t j0 = 0; j0 < n; j0 += kFoldBatch) {
    T2 v[kFoldBatch];
#pragma unroll
    for (int i = 0; i < kFoldBatch; ++i) v[i] = __ldcg(p + min(j0 + i, n - 1) * step);
#pragma unroll
    for (int i = 0; i < kFoldBatch; ++i) {
      if (j0 + i < n) {
        y.x = add(y.x, v[i].x);
        y.y = add(y.y, v[i].y);
      }
    }
  }
  return y;
}

template <int kPrec>
__device__ __forceinline__ void write_row(const Part& P, int32_t r, Acc<kPrec> y, float sc) {
  if (r >= P.n_rows) return;
  P.y_fwd[r] = finish<kPrec>(y, sc);
  if (P.x_ss != nullptr) {  // packed only: never int8 (mr_pattern_pair checks)
    P.x_ss[r] = operand<kPrec == kBf16 ? kBf16 : kF32>(__ldg(P.sv + r), __ldg(P.w_out + r), 1.0f);
  }
}

template <int kPrec, typename T2 = typename Two<Acc<kPrec>>::type>
__device__ __forceinline__ void write_cols(const Part& P, int32_t c, T2 y, float sr) {
  if (c < P.n_cols) P.y_bwd[c] = finish<kPrec>(y.x, sr);
  if (c + 1 < P.n_cols) P.y_bwd[c + 1] = finish<kPrec>(y.y, sr);
}

// One tile of one partition. Every branch before the last __syncthreads
// is block-uniform.
template <int kPrec>
__device__ __forceinline__ void tile(const Part& P, int32_t block, Smem<Acc<kPrec>>& s) {
  using T = Acc<kPrec>;
  using T2 = typename Two<T>::type;
  const int t = static_cast<int>(threadIdx.x);
  const int32_t rt = block / P.n_ct;
  const int32_t ct = block - rt * P.n_ct;
  const int32_t r0 = rt * kTileRows;
  const int32_t c0 = ct * kTileCols;
  float sc = 1.0f, sr = 1.0f;  // the fwd and bwd operands' scales (int8)
  if constexpr (kPrec == kI8) {
    sc = __ldg(P.scale);
    sr = __ldg(P.scale + 1);
  }

  // 1-2. Issue the tile's loads and the operands' loads, then store them.
  uint4 chunk[kLoadsPerThread];
#pragma unroll
  for (int i = 0; i < kLoadsPerThread; ++i) {
    const int idx = t + i * kThreads;
    const int32_t r = r0 + idx / kChunksPerRow;
    const int64_t byte = static_cast<int64_t>(c0) / 8 + (idx % kChunksPerRow) * kChunk;
    chunk[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r < P.n_rows && byte < P.stride) {
      chunk[i] = __ldg(reinterpret_cast<const uint4*>(
          P.pat + static_cast<int64_t>(r) * P.stride + byte));
    }
  }
  T a[kColsPerThread];
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) {
    const int32_t c = c0 + t + i * kThreads;
    a[i] = c < P.n_cols ? operand<kPrec>(__ldg(P.rv + c), __ldg(P.w_len + c), sc) : T(0);
  }
  T b = T(0);
  if (t < kTileRows && r0 + t < P.n_rows) {
    b = operand<kPrec>(__ldg(P.sv + r0 + t), __ldg(P.w_cov + r0 + t), sr);
  }
#pragma unroll
  for (int i = 0; i < kLoadsPerThread; ++i) {
    const int idx = t + i * kThreads;
    *reinterpret_cast<uint4*>(&s.bits[idx / kChunksPerRow][(idx % kChunksPerRow) * 4]) =
        make_uint4(column_order(chunk[i].x), column_order(chunk[i].y),
                   column_order(chunk[i].z), column_order(chunk[i].w));
  }
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) s.a[t + i * kThreads] = a[i];
  if (t < kTileRows) s.b[t] = b;
  __syncthreads();

  // 3. fwd: warp w, rows w, w + 8, ...; lane l, columns 16l .. 16l + 15.
  // kRowBatch rows go side by side: their sums are independent chains,
  // so one row's adds and shuffles fill the others' latency. Each row's
  // order is unchanged.
  {
    const int lane = t % kWarp;
    const int warp = t / kWarp;
    T al[kLaneCols];
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) al[j] = s.a[lane * kLaneCols + j];
    const uint16_t* halves = reinterpret_cast<const uint16_t*>(&s.bits[0][0]);
#pragma unroll
    for (int i0 = 0; i0 < kRowsPerWarp; i0 += kRowBatch) {
      uint32_t m[kRowBatch];
      T acc[kRowBatch];
#pragma unroll
      for (int q = 0; q < kRowBatch; ++q) {
        m[q] = halves[(warp + kWarps * (i0 + q)) * kTileWords * 2 + lane];
        acc[q] = T(0);
      }
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
#pragma unroll
        for (int q = 0; q < kRowBatch; ++q) acc[q] = add_if(acc[q], m[q], j, al[j]);
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {  // the tree 16, 8, 4, 2, 1
#pragma unroll
        for (int q = 0; q < kRowBatch; ++q) {
          acc[q] = add(acc[q], __shfl_down_sync(kFull, acc[q], off));
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kRowBatch; ++q) s.y_rows[warp + kWarps * (i0 + q)] = acc[q];
      }
    }
  }

  // 4. bwd: thread t, columns 2t and 2t + 1, rows in ascending order.
  T2 col;
  col.x = T(0);
  col.y = T(0);
  {
    const int word = (kColsPerThread * t) / 32;
    const int shift = (kColsPerThread * t) % 32;
#pragma unroll 16
    for (int row = 0; row < kTileRows; ++row) {
      const uint32_t m = s.bits[row][word] >> shift;
      const T br = s.b[row];
      col.x = add_if(col.x, m, 0, br);
      col.y = add_if(col.y, m, 1, br);
    }
  }
  __syncthreads();  // s.y_rows complete

  // 5. A stripe of one tile writes its result; else publish the partial.
  // The scratch holds T: f32, or int32 in the same 4 bytes.
  T* fwd_part = reinterpret_cast<T*>(P.fwd_part);
  T* bwd_part = reinterpret_cast<T*>(P.bwd_part);
  const int32_t c = c0 + kColsPerThread * t;
  if (P.n_ct == 1) {
    if (t < kTileRows) write_row<kPrec>(P, r0 + t, s.y_rows[t], sc);
  } else if (t < kTileRows) {
    __stcg(fwd_part + static_cast<int64_t>(ct) * P.n_rt * kTileRows + r0 + t, s.y_rows[t]);
  }
  if (P.n_rt == 1) {
    write_cols<kPrec>(P, c, col, sr);
  } else {
    __stcg(reinterpret_cast<T2*>(bwd_part + static_cast<int64_t>(rt) * P.n_ct * kTileCols + c),
           col);
  }
  const bool fold_rows = P.n_ct > 1;
  const bool fold_cols = P.n_rt > 1;
  if (!fold_rows && !fold_cols) return;
  __threadfence();  // release this block's partials
  __syncthreads();
  if (t == 0) {
    s.last[0] = fold_rows && atomicAdd(P.row_count + rt, 1) == P.n_ct - 1;
    s.last[1] = fold_cols && atomicAdd(P.col_count + ct, 1) == P.n_rt - 1;
  }
  __syncthreads();
  const bool last_row = s.last[0] != 0;
  const bool last_col = s.last[1] != 0;
  if (!last_row && !last_col) return;
  __threadfence();  // acquire the other blocks' partials
  if (last_row) {
    // The row stripe's column tiles, left to right.
    if (t < kTileRows) {
      write_row<kPrec>(
          P, r0 + t,
          fold(fwd_part + r0 + t, static_cast<int64_t>(P.n_rt) * kTileRows, P.n_ct), sc);
    }
    if (t == 0) P.row_count[rt] = 0;  // ready for the next launch on this scratch
  }
  if (last_col) {
    // The column stripe's row tiles, top to bottom.
    const int64_t step = static_cast<int64_t>(P.n_ct) * kTileCols / 2;  // pairs per row tile
    write_cols<kPrec>(P, c, fold2<T>(reinterpret_cast<const T2*>(bwd_part + c), step, P.n_rt),
                      sr);
    if (t == 0) P.col_count[ct] = 0;
  }
}

// Floats of one window's K8 scratch: the fwd partials (n_ct > 1), then
// the bwd partials (groups > 1); ops/pattern.py `_scratch`.
__host__ __device__ __forceinline__ int64_t blocked_scratch(const Part& P) {
  return (P.n_ct > 1 ? static_cast<int64_t>(P.n_rt) * kTileRows * blocked_ld(P.n_ct) : 0) +
         (P.groups > 1 ? static_cast<int64_t>(P.n_rt) * P.n_ct * kTileCols : 0);
}

// Part P of window w of a stacked group: each window's pattern, vectors,
// outputs, scales and scratch follow the previous window's, so every
// pointer moves by its per-window stride (the window's rows, columns,
// scales, tiles or stripes; K8's scratch by `blocked_scratch`, and K8
// has no counters).
template <bool kBlocked>
__device__ __forceinline__ Part window_part(const Part& P, int32_t w) {
  Part q = P;
  const int64_t rows = static_cast<int64_t>(w) * P.n_rows;
  const int64_t cols = static_cast<int64_t>(w) * P.n_cols;
  const int64_t scratch =
      static_cast<int64_t>(w) * (kBlocked ? blocked_scratch(P)
                                          : static_cast<int64_t>(P.n_rt) * P.n_ct *
                                                (kTileRows + kTileCols));
  q.pat += rows * P.stride;
  q.rv += cols;
  q.w_len += cols;
  q.sv += rows;
  q.w_cov += rows;
  q.y_fwd += rows;
  q.y_bwd += cols;
  if (P.w_out != nullptr) q.w_out += rows;
  if (P.x_ss != nullptr) q.x_ss += rows;
  if (P.scale != nullptr) q.scale += static_cast<int64_t>(w) * P.scale_step;
  q.fwd_part += scratch;
  q.bwd_part += scratch;
  if constexpr (!kBlocked) {
    q.row_count += static_cast<int64_t>(w) * (P.n_rt + P.n_ct);
    q.col_count += static_cast<int64_t>(w) * (P.n_rt + P.n_ct);
  }
  return q;
}

// Blocks in order: the tiles of part 0, then of part 1 (an absent part
// has 0 blocks); blockIdx.y is the window of a stacked group. The
// branches are block-uniform; a single window's call names its part
// statically, so the argument struct is read from parameter space and
// never copied (a stacked window's part is a copy with its strides
// applied, `window_part`).
template <int kPrec>
__global__ void __launch_bounds__(kThreads) pattern_pair(Args args) {
  __shared__ Smem<Acc<kPrec>> s;
  const int32_t b = static_cast<int32_t>(blockIdx.x);
  const int32_t w = static_cast<int32_t>(blockIdx.y);
  if (gridDim.y == 1) {
    if (b < args.p[0].blocks) {
      tile<kPrec>(args.p[0], b, s);
    } else {
      tile<kPrec>(args.p[1], b - args.p[0].blocks, s);
    }
  } else if (b < args.p[0].blocks) {
    tile<kPrec>(window_part<false>(args.p[0], w), b, s);
  } else {
    tile<kPrec>(window_part<false>(args.p[1], w), b - args.p[0].blocks, s);
  }
}

// ---- K8: the packed_blocked pair (f32), per set bit -------------------
//
// Replaces jax_tpu.py `packed_blocked` (605-646) and its
// `_blocked_bits_matvecs` (208): K4's function in f32, x_ss included.
// At bench.py's giant tier (2,048 rows, 262,144 columns a partition,
// about 4 of 2,048 bits set per column: 0.2%) the tile kernel above
// spends a select and an add on every cell in each direction, about
// 99.8% of them on zeros, and writes and re-reads 2 x 21 MB of tile
// partials. The bound is the bitmap's bytes (134 MB of 141 MB at 3.35
// TB/s). This kernel works per set bit and keeps the bwd sums in
// registers; beside the bytes it moves its fwd partials (2 x 4 MB).
// What holds it above that is not measured apart: the copies (a block
// reads 64 bytes of each of 128 rows 32 KB apart) and the instructions
// and latency of each row tile.
//
// Two launches. `pattern_pair_blocked`: a block per column tile of a
// partition walks its row tiles top to bottom (all of them, unless the
// partition has few column tiles: see the adaptations below). Per row
// tile:
//   fwd: warp w takes rows 16w .. 16w + 15, two threads a row (thread
//        2i + p: words 8p .. 8p + 7 of row 16w + i). The warp lists its
//        non-zero words in (row, word) order (a prefix sum of the
//        threads' counts) and its lanes take the list 32 items at a
//        time. A lane sums the set bits of each half (16 columns) of its
//        word in ascending column order (__ffs, m &= m - 1; or the tile
//        kernel's select over all 16 bits when more than kWalkMax are
//        set: the same adds less the +0.0s). The tile kernel's row sum
//        is the shuffle tree 16, 8, 4, 2, 1 over the 32 half sums; a half
//        of zeros adds +0.0 in it, which changes no bits (a sum that
//        starts at +0.0 is never -0.0, and the card's NaN is canonical).
//        So a row of no set bit sums to +0.0, a row whose set bits lie in
//        one or two halves to that half's sum or the two halves' sum
//        (fadd is commutative): one lane, or two neighbours, settle those.
//        Any other row (about 8% at 0.2% density) is hard: lane l sums
//        half l and the tree runs as in the tile kernel. The row's tile
//        sum goes to the fwd partials, row-major ([row][column tile]).
//   bwd: each listed word's set bits count themselves into their
//        columns (a shared-memory atomicAdd) and leave their rows in two
//        slots, in any order; thread t (columns 2t, 2t + 1) then sums a
//        column of one or two set bits from the slots in ascending row
//        order (about 20% of a tile's columns have one at 0.2% density,
//        2.5% two), and a column of more by walking the rows whose word
//        is non-zero (row masks by shared atomicOr) in order. The tile
//        sums fold into registers top to bottom, so y_bwd is written at
//        the end of the walk: no bwd partials, no counters.
//   The next kStages - 1 row tiles' 8 KB of bitmap, sv and w_cov are
//   copied into shared memory by cp.async while the current one is
//   summed (a ring of kStages buffers).
// `fold_blocked` (where a partition has more than one column tile, or
// more than one group): a block per 32 rows folds each row's partials
// left to right (coalesced loads through shared memory, the next chunk's
// loads in flight during the fold) and writes y_fwd and x_ss; a block
// per 256 columns folds the groups' row-tile sums top to bottom. A fold
// in the last block to arrive at each row tile (the tile kernel's way)
// was tried first: that block fell behind and so arrived last at every
// later row tile too, and the folds ran one after another (0.865 ms a
// step at the giant-2M shapes on an H100, twice the tile kernel's time).
// The sums and their orders are the tile kernel's (ops/pattern.py
// fwd_plain / bwd_plain), so the two give the same bits in f32 at every
// shape and density. A stacked group runs both launches with the window
// as the grid's y dimension (`window_part<true>`): each window's fwd
// and bwd partials at a stride of `blocked_scratch` floats from the
// previous window's, so no two windows' partials overlap.
// Scratch: the fwd partials, n_rt * kTileRows rows of ldp = n_ct rounded
// up to 4 floats (when n_ct > 1): 2 x 4 MB at the giant-2M shapes,
// against the tile kernel's 2 x 21 MB.
// Two adaptations, neither of which changes a bit. Few column tiles
// (few traces, many operations) would leave SMs idle, so a column tile's
// row tiles may be cut into groups of rows_per_block (ops/pattern.py
// sizes it for about two blocks per SM): each block then stores its row
// tiles' column sums (the bwd partials, n_rt x n_cols floats), and
// fold_blocked folds them top to bottom. And a row tile whose
// predecessor listed more than a quarter of its words non-zero runs
// dense: every row by the tree, and the tile kernel's bwd over every
// row, with no atomics. At 2% density this kernel is still slower than
// the tile kernel (0.58 against 0.43 ms a step at the giant-2M shapes on
// an H100): it is made for the sparse bitmaps of windows of many short
// traces.

constexpr int kHalfCols = 16;                        // columns of a half (kLaneCols)
constexpr int kRowWords = kTileWords / 2;            // words a fwd thread reads of its row
constexpr int kWarpRows = kWarp / 2;                 // 16 rows a warp, two threads a row
constexpr int kWalkMax = 6;                          // set bits a walk takes; past it, select
constexpr int kStages = 2;                           // row tiles in shared memory, in flight
constexpr int kDenseWords = kWarpRows * kTileWords / 4;  // a warp's listed words past which
                                                         // it sums every row by the tree
// Blocks an SM holds: caps the registers at 64 a thread (uncapped, the
// compiler took 69, and only three blocks fit).
constexpr int kBlockedMinBlocks = 4;
constexpr int kFoldRows = 32;                        // rows a fold block
constexpr int kFoldCols = 128;                       // partials a fold chunk holds per row
constexpr int kFoldLoads = kFoldRows * kFoldCols / kThreads;
static_assert(kLaneCols == kHalfCols, "a lane's columns are one half");
static_assert(kWarps * kWarpRows == kTileRows, "two fwd threads per row");
static_assert(kRowWords == 8, "a fwd thread reads two 16-byte chunks");
static_assert(2 * kTileRows == kThreads, "one thread stages each of sv and w_cov");
static_assert(kFoldRows == kWarp, "one warp folds");

struct alignas(16) BlockedSmem {
  uint32_t raw[kStages][kTileRows][kTileWords];  // bitmap bytes as stored (big-endian bits)
  float vec[kStages][2][kTileRows];              // sv, w_cov of the tile's rows (0 past n_rows)
  float a[kTileCols];                            // rv * w_len, 0 past n_cols
  float b[kTileRows];                            // sv * w_cov
  // Per word of a tile row and warp w: bit i set when that word of row
  // 16w + i is non-zero (two sets, by row tile parity).
  uint32_t wmask[2][kTileWords][kWarps];
  uint16_t items[kWarps][kWarpRows * kTileWords];  // a warp's non-zero words: row << 4 | word
  // Per column of the row tile: its set bits, and the rows of the first
  // two in arrival order (0 between row tiles).
  int32_t col_cnt[kTileCols];
  uint8_t col_row[kTileCols][2];
  int n_listed[2];  // the row tile's listed words (two, by row tile parity)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (or zeros when !ok) global -> shared, bypassing L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Waits until at most kStages - 1 groups (the next tiles') are in flight.
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Issues the copies of row tile rt into buffer `buf`: two 16-byte
// chunks of bitmap and one float of sv or w_cov per thread.
__device__ __forceinline__ void stage_tile(const Part& P, int32_t rt, int32_t c0, int buf,
                                          BlockedSmem& s) {
  const int t = static_cast<int>(threadIdx.x);
  const int32_t r0 = rt * kTileRows;
#pragma unroll
  for (int i = 0; i < kLoadsPerThread; ++i) {
    const int idx = t + i * kThreads;
    const int32_t r = r0 + idx / kChunksPerRow;
    const int64_t byte = static_cast<int64_t>(c0) / 8 + (idx % kChunksPerRow) * kChunk;
    const bool ok = r < P.n_rows && byte < P.stride;
    cp_async16(&s.raw[buf][idx / kChunksPerRow][(idx % kChunksPerRow) * 4],
               ok ? P.pat + static_cast<int64_t>(r) * P.stride + byte : P.pat, ok);
  }
  const int which = t / kTileRows;  // 0: sv, 1: w_cov
  const int32_t r = r0 + t % kTileRows;
  const bool ok = r < P.n_rows;
  const float* src = which == 0 ? P.sv : P.w_cov;
  cp_async4(&s.vec[buf][which][t % kTileRows], ok ? src + r : src, ok);
  cp_async_commit();
}

// One half's sum: a[j] for each set bit j of m (16 bits), ascending.
__device__ __forceinline__ float half_sum(uint32_t m, const float* a) {
  float acc = 0.0f;
  if (__popc(m) > kWalkMax) {
#pragma unroll
    for (int j = 0; j < kHalfCols; ++j) acc = add_if(acc, m, j, a[j]);
  } else {
    for (; m != 0u; m &= m - 1u) acc = add(acc, a[__ffs(m) - 1]);
  }
  return acc;
}

// A row's tile sum: to the fwd partials, or, for a partition of one
// column tile, straight to y_fwd (and x_ss).
__device__ __forceinline__ void put_row(const Part& P, int32_t r, int32_t ct, int32_t ldp,
                                        float y) {
  if (P.n_ct == 1) {
    write_row<kF32>(P, r, y, 1.0f);
  } else if (r < P.n_rows) {
    __stcg(P.fwd_part + static_cast<int64_t>(r) * ldp + ct, y);
  }
}

// The fwd half of one row tile (buffer `buf`, first row r0), and, in
// the sparse mode (`!dense`), the bwd's per-column counts and slots and
// row masks (`wm`, zero before). Warp w takes rows 16w .. 16w + 15;
// thread 2i + p reads words 8p .. 8p + 7 of row 16w + i. The warp's
// non-zero words go to a list in (row, word) order, and the lanes take
// its items 32 at a time. A row of one item holds at most two non-zero
// halves, a row of two items of one half each two: those sum without
// the tree (see the note above); any other row is hard, and so is every
// row of a warp with more than kDenseWords listed words.
__device__ __forceinline__ void blocked_fwd(const Part& P, int32_t r0, int32_t ct, int32_t ldp,
                                            int buf, bool dense, uint32_t (*wm)[kWarps],
                                            int* n_listed, BlockedSmem& s) {
  const int t = static_cast<int>(threadIdx.x);
  const int lane = t % kWarp;
  const int warp = t / kWarp;
  const int pr = lane & 1;     // which half of the row's words
  const int wrow = lane / 2;   // the row, within the warp's
  const int32_t wr0 = r0 + warp * kWarpRows;
  const uint32_t* rows = &s.raw[buf][warp * kWarpRows][0];
  const uint4* q = reinterpret_cast<const uint4*>(rows + wrow * kTileWords + kRowWords * pr);
  const uint4 q0 = q[0], q1 = q[1];
  const uint32_t w[kRowWords] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  uint32_t nzw = 0u;  // bit j: word 8 pr + j is non-zero
#pragma unroll
  for (int j = 0; j < kRowWords; ++j) nzw |= static_cast<uint32_t>(w[j] != 0u) << j;
  // The list: this thread's words at the exclusive prefix of the counts.
  const int cnt = __popc(nzw);
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  const int n_items = __shfl_sync(kFull, incl, kWarp - 1);
  if (lane == 0) atomicAdd(n_listed, n_items);
  const bool tree = n_items > kDenseWords;  // warp-uniform: every row by the tree
  // A row of no set bit sums to +0.0.
  const int row_cnt = cnt + __shfl_xor_sync(kFull, cnt, 1);
  if (pr == 0 && row_cnt == 0) put_row(P, wr0 + wrow, ct, ldp, 0.0f);
  uint32_t hard = tree ? __ballot_sync(kFull, pr == 0 && row_cnt != 0) : 0u;  // bit 2i: row i
  if (!tree || !dense) {
    uint16_t* items = s.items[warp];
    for (int pos = incl - cnt, m = static_cast<int>(nzw); m != 0; m &= m - 1) {
      items[pos++] = static_cast<uint16_t>((wrow << 4) | (kRowWords * pr + __ffs(m) - 1));
    }
    __syncwarp();
    for (int base = 0; base < n_items; base += kWarp) {
      const int idx = base + lane;
      const bool live = idx < n_items;
      const int it = live ? items[idx] : 0;
      const int irow = it >> 4;
      const int word = it & 15;
      const uint32_t cw = column_order(rows[irow * kTileWords + word]);
      if (live && !dense) {
        atomicOr(&wm[word][warp], 1u << irow);
        for (uint32_t m = cw; m != 0u; m &= m - 1u) {  // the bwd's set bits, any order
          const int c = 32 * word + __ffs(m) - 1;
          const int slot = atomicAdd(&s.col_cnt[c], 1);
          if (slot < 2) s.col_row[c][slot] = static_cast<uint8_t>(warp * kWarpRows + irow);
        }
      }
      if (tree) continue;  // warp-uniform
      const int next1 = idx + 1 < n_items ? items[idx + 1] >> 4 : -1;
      const int next2 = idx + 2 < n_items ? items[idx + 2] >> 4 : -1;
      const bool first = live && (idx == 0 || (items[idx - 1] >> 4) != irow);
      const uint32_t lo = cw & 0xffffu, hi = cw >> 16;
      const int nh = (lo != 0u) + (hi != 0u);
      const bool one = first && next1 != irow;  // the row's only item
      const bool two = first && next1 == irow && next2 != irow && nh == 1;
      float v = 0.0f;
      if (one || (live && !first) || two) {
        const float* a = s.a + 2 * kHalfCols * word;
        if (lo != 0u) v = half_sum(lo, a);
        if (hi != 0u) {
          v = lo != 0u ? add(v, half_sum(hi, a + kHalfCols)) : half_sum(hi, a + kHalfCols);
        }
      }
      const float nv = __shfl_down_sync(kFull, v, 1);
      const int nn = __shfl_down_sync(kFull, nh, 1);
      const bool pair = two && nn == 1 && lane < kWarp - 1;  // the next item is the row's other
      if (one) put_row(P, wr0 + irow, ct, ldp, v);
      if (pair) put_row(P, wr0 + irow, ct, ldp, add(v, nv));
      const uint32_t h = __ballot_sync(kFull, first && !one && !pair);
      for (uint32_t m = h; m != 0u; m &= m - 1u) {
        hard |= 1u << (2 * __shfl_sync(kFull, irow, __ffs(m) - 1));
      }
    }
  }
  // Hard rows: the warp, a lane a half, as the tile kernel's tree.
  for (; hard != 0u; hard &= hard - 1u) {
    const int hrow = (__ffs(hard) - 1) / 2;
    const uint32_t m =
        (column_order(rows[hrow * kTileWords + lane / 2]) >> (kHalfCols * (lane & 1))) & 0xffffu;
    float acc = half_sum(m, s.a + kHalfCols * lane);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {  // the tree 16, 8, 4, 2, 1
      acc = add(acc, __shfl_down_sync(kFull, acc, off));
    }
    if (lane == 0) put_row(P, wr0 + hrow, ct, ldp, acc);
  }
}

// One column tile of one partition and its group of row tiles. Every
// branch around a __syncthreads is block-uniform.
__device__ __forceinline__ void blocked_column(const Part& P, int32_t b, BlockedSmem& s) {
  const int t = static_cast<int>(threadIdx.x);
  const int32_t ct = b / P.groups;
  const int32_t rt0 = (b - ct * P.groups) * P.rows_per_block;
  const int32_t rt1 = min(P.n_rt, rt0 + P.rows_per_block);
  const int32_t c0 = ct * kTileCols;
  const int32_t ldp = blocked_ld(P.n_ct);  // fwd partials per row
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (rt0 + i < rt1) {
      stage_tile(P, rt0 + i, c0, i, s);
    } else {
      cp_async_commit();  // empty groups keep the wait below uniform
    }
  }
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) {
    const int32_t c = c0 + t + i * kThreads;
    s.a[t + i * kThreads] =
        c < P.n_cols ? operand<kF32>(__ldg(P.rv + c), __ldg(P.w_len + c), 1.0f) : 0.0f;
  }
  // bwd: columns 2t, 2t + 1 of word `word`.
  const int word = kColsPerThread * t / 32;
  const int shift = kColsPerThread * t % 32;
  float tot[kColsPerThread] = {0.0f, 0.0f};
  *reinterpret_cast<int2*>(&s.col_cnt[kColsPerThread * t]) = make_int2(0, 0);
  if (t < 2) s.n_listed[t] = 0;
  bool dense = false;  // the mode of this row tile, from the last one's listed words
  for (int32_t rt = rt0; rt < rt1; ++rt) {
    const int i = rt - rt0;
    const int buf = i % kStages;
    if (rt + kStages - 1 < rt1) {  // into the buffer row tile rt - 1 used
      stage_tile(P, rt + kStages - 1, c0, (i + kStages - 1) % kStages, s);
    } else {
      cp_async_commit();
    }
    uint32_t(*wm)[kWarps] = s.wmask[i & 1];  // last read two row tiles ago
    if (t < kTileWords * kWarps) wm[t / kWarps][t % kWarps] = 0u;
    if (t == 0) s.n_listed[i & 1] = 0;       // last read one row tile ago, before a barrier
    cp_async_wait_stages();
    __syncthreads();  // row tile rt (and, first time round, s.a) in shared memory
    if (t < kTileRows) s.b[t] = __fmul_rn(s.vec[buf][0][t], s.vec[buf][1][t]);
    blocked_fwd(P, rt * kTileRows, ct, ldp, buf, dense, wm, &s.n_listed[i & 1], s);
    __syncthreads();  // s.b, wm, col_cnt, col_row and n_listed complete
    float col[kColsPerThread] = {0.0f, 0.0f};
    if (dense) {
      // The tile kernel's bwd: every row, in order.
      for (int row = 0; row < kTileRows; ++row) {
        const uint32_t m = column_order(s.raw[buf][row][word]) >> shift;
        const float br = s.b[row];
        col[0] = add_if(col[0], m, 0, br);
        col[1] = add_if(col[1], m, 1, br);
      }
    } else {
      const int2 cnt = *reinterpret_cast<const int2*>(&s.col_cnt[kColsPerThread * t]);
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        // The column's tile sum over its rows in ascending order: +0.0
        // for no set bit, one or two rows from the arrival slots, else
        // the rows of non-zero words in order.
        const int c = kColsPerThread * t + j;
        const int n = j == 0 ? cnt.x : cnt.y;
        if (n == 0) continue;
        if (n <= 2) {
          const int ra = s.col_row[c][0];
          const int rb = n == 2 ? s.col_row[c][1] : ra;
          col[j] = add(col[j], s.b[min(ra, rb)]);
          if (n == 2) col[j] = add(col[j], s.b[max(ra, rb)]);
        } else {
          for (int w = 0; w < kWarps; ++w) {
            for (uint32_t m = wm[word][w]; m != 0u; m &= m - 1u) {
              const int row = w * kWarpRows + __ffs(m) - 1;
              col[j] = add_if(col[j], column_order(s.raw[buf][row][word]), c % 32, s.b[row]);
            }
          }
        }
      }
      *reinterpret_cast<int2*>(&s.col_cnt[kColsPerThread * t]) = make_int2(0, 0);
    }
    if (P.groups == 1) {
      tot[0] = add(tot[0], col[0]);
      tot[1] = add(tot[1], col[1]);
    } else {  // the tile's sums, for fold_blocked's fold top to bottom
      __stcg(reinterpret_cast<float2*>(P.bwd_part + static_cast<int64_t>(rt) * P.n_ct * kTileCols +
                                       c0 + kColsPerThread * t),
             make_float2(col[0], col[1]));
    }
    dense = s.n_listed[i & 1] > kDenseWords * kWarps;
    __syncthreads();  // buffer buf and s.b free for the next row tile
  }
  if (P.groups == 1) {
    write_cols<kF32>(P, c0 + kColsPerThread * t, make_float2(tot[0], tot[1]), 1.0f);
  }
}

// Blocks in order: the column tiles of part 0, then of part 1;
// blockIdx.y is the window of a stacked group.
__global__ void __launch_bounds__(kThreads, kBlockedMinBlocks) pattern_pair_blocked(Args args) {
  __shared__ BlockedSmem s;
  const int32_t b = static_cast<int32_t>(blockIdx.x);
  const int32_t w = static_cast<int32_t>(blockIdx.y);
  if (gridDim.y == 1) {
    if (b < args.p[0].blocks) {
      blocked_column(args.p[0], b, s);
    } else {
      blocked_column(args.p[1], b - args.p[0].blocks, s);
    }
  } else if (b < args.p[0].blocks) {
    blocked_column(window_part<true>(args.p[0], w), b, s);
  } else {
    blocked_column(window_part<true>(args.p[1], w), b - args.p[0].blocks, s);
  }
}

// fold_blocked's blocks of a part: 32 rows each for the fwd fold (a
// part of more than one column tile), kThreads columns each for the bwd
// fold (a part of more than one group of row tiles).
__host__ __device__ __forceinline__ int32_t fwd_fold_blocks(const Part& P) {
  return P.n_ct > 1 ? (P.n_rows + kFoldRows - 1) / kFoldRows : 0;
}
__host__ __device__ __forceinline__ int32_t bwd_fold_blocks(const Part& P) {
  return P.groups > 1 ? (P.n_cols + kThreads - 1) / kThreads : 0;
}

// A fwd fold block: warp 0 folds rows r0 .. r0 + 31 left to right; all
// threads load.
__device__ __forceinline__ void fold_rows(const Part& P, int32_t r0,
                                          float (*stage)[kFoldCols + 1]) {
  const int t = static_cast<int>(threadIdx.x);
  const int32_t ldp = blocked_ld(P.n_ct);
  float v[kFoldLoads];
  auto load = [&](int32_t j0) {
#pragma unroll
    for (int i = 0; i < kFoldLoads; ++i) {
      const int idx = t + i * kThreads;
      const int32_t r = r0 + idx / kFoldCols;
      const int32_t c = j0 + idx % kFoldCols;
      v[i] = r < P.n_rows && c < P.n_ct ? __ldcg(P.fwd_part + static_cast<int64_t>(r) * ldp + c)
                                        : 0.0f;
    }
  };
  float y = 0.0f;
  load(0);
  for (int32_t j0 = 0; j0 < P.n_ct; j0 += kFoldCols) {
    __syncthreads();  // the previous chunk folded
#pragma unroll
    for (int i = 0; i < kFoldLoads; ++i) {
      const int idx = t + i * kThreads;
      stage[idx / kFoldCols][idx % kFoldCols] = v[i];
    }
    __syncthreads();
    if (j0 + kFoldCols < P.n_ct) load(j0 + kFoldCols);  // in flight during the fold
    if (t < kFoldRows) {
      // Left to right; past n_ct the chunk holds +0.0, which adds nothing.
#pragma unroll 16
      for (int c = 0; c < kFoldCols; ++c) y = add(y, stage[t][c]);
    }
  }
  if (t < kFoldRows) write_row<kF32>(P, r0 + t, y, 1.0f);
}

// A bwd fold block: thread t folds column c0 + t's row-tile sums top to
// bottom.
__device__ __forceinline__ void fold_cols(const Part& P, int32_t c0) {
  const int32_t c = c0 + static_cast<int32_t>(threadIdx.x);
  if (c >= P.n_cols) return;
  const int64_t step = static_cast<int64_t>(P.n_ct) * kTileCols;
  float y = 0.0f;
  for (int32_t rt = 0; rt < P.n_rt; ++rt) y = add(y, __ldcg(P.bwd_part + rt * step + c));
  P.y_bwd[c] = y;
}

// The folds of both parts: the fwd folds of part 0, of part 1, then the
// bwd folds of part 0, of part 1; blockIdx.y is the window of a stacked
// group. The branches are block-uniform.
__device__ __forceinline__ void fold_parts(const Part& p0, const Part& p1, int32_t b,
                                           float (*stage)[kFoldCols + 1]) {
  const int32_t f0 = fwd_fold_blocks(p0), f1 = fwd_fold_blocks(p1);
  if (b < f0) {
    fold_rows(p0, b * kFoldRows, stage);
  } else if ((b -= f0) < f1) {
    fold_rows(p1, b * kFoldRows, stage);
  } else if ((b -= f1) < bwd_fold_blocks(p0)) {
    fold_cols(p0, b * kThreads);
  } else {
    fold_cols(p1, (b - bwd_fold_blocks(p0)) * kThreads);
  }
}

__global__ void __launch_bounds__(kThreads) fold_blocked(Args args) {
  __shared__ float stage[kFoldRows][kFoldCols + 1];  // +1: a row per bank
  const int32_t b = static_cast<int32_t>(blockIdx.x);
  const int32_t w = static_cast<int32_t>(blockIdx.y);
  if (gridDim.y == 1) {
    fold_parts(args.p[0], args.p[1], b, stage);
  } else {
    fold_parts(window_part<true>(args.p[0], w), window_part<true>(args.p[1], w), b, stage);
  }
}

// The int8 scales of one step's operands x[v] * w[v], v < n_vecs
// (ops/pattern.py quantize_scales), of each of n_windows windows: window
// w's vector v is x[v] + w * n[v] (a stacked group's [B, n] operands).
struct AmaxArgs {
  const float* x[kMaxVecs];
  const float* w[kMaxVecs];
  int64_t n[kMaxVecs];
  float* scale;      // [n_windows, n_vecs]
  uint32_t* amax;    // [n_windows * n_vecs] running maxima (f32 bits), 0 between launches
  uint32_t* count;   // block arrivals, 0 between launches
  int32_t n_vecs;
  int32_t n_windows;
  int32_t per_vec;   // blocks per vector and window
};

__global__ void __launch_bounds__(kThreads) quantize_amax(AmaxArgs args) {
  __shared__ uint32_t warp_max[kWarps];
  __shared__ int last;
  const int t = static_cast<int>(threadIdx.x);
  const int vw = static_cast<int>(blockIdx.x) / args.per_vec;  // window * n_vecs + vector
  const int v = vw % args.n_vecs;
  const int64_t win = vw / args.n_vecs;
  const int64_t j = static_cast<int64_t>(blockIdx.x) - static_cast<int64_t>(vw) * args.per_vec;
  // The vector's fields by a static index (no local copy of the struct).
  const float* x = args.x[0];
  const float* w = args.w[0];
  int64_t n = args.n[0];
#pragma unroll
  for (int i = 1; i < kMaxVecs; ++i) {
    if (v == i) {
      x = args.x[i];
      w = args.w[i];
      n = args.n[i];
    }
  }
  x += win * n;
  w += win * n;
  uint32_t m = 0u;
  const int64_t stride = static_cast<int64_t>(args.per_vec) * kThreads;
  for (int64_t i = j * kThreads + t; i < n; i += stride) {
    m = max(m, __float_as_uint(fabsf(flush_subnormal(__fmul_rn(__ldg(x + i), __ldg(w + i))))));
  }
  m = __reduce_max_sync(kFull, m);
  if (t % kWarp == 0) warp_max[t / kWarp] = m;
  __syncthreads();
  if (t == 0) {
    uint32_t bm = 0u;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) bm = max(bm, warp_max[i]);
    atomicMax(args.amax + vw, bm);
    __threadfence();  // release the maximum before arriving
    last = atomicAdd(args.count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // acquire every block's maximum
  for (int i = t; i < args.n_vecs * args.n_windows; i += kThreads) {
    const float amax = __uint_as_float(atomicExch(args.amax + i, 0u));  // read and reset
    args.scale[i] = amax > 0.0f ? flush_subnormal(__fdiv_rn(amax, 127.0f)) : 1.0f;
  }
  if (t == 0) *args.count = 0u;
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: make it `device` (a no-op after the first call).
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t got = cudaGetDevice(&current);
  if (got == cudaSuccess && current == device) return cudaSuccess;
  return cudaSetDevice(device);
}

enum { kPat, kRv, kWLen, kSv, kWCov, kWOut, kScale, kYFwd, kYBwd, kXSs, kPartBuf,
       kCounters, kPtrs };
enum { kStride, kNRows, kNCols, kInts };
enum { kRowsPerBlock = kInts, kBlockedInts };  // K8's ints: the tile kernel's, then one

// Checks and reads the launch's parts into `args`; returns the grid's
// blocks (one per tile, or with `blocked` one per column tile and group
// of row tiles), or -1.
int64_t read_parts(const void* const* ptrs, const int64_t* ints, int32_t n_parts,
                   int32_t precision, bool blocked, Args& args) {
  const int n_ints = blocked ? kBlockedInts : kInts;
  if (n_parts < 1 || n_parts > kMaxParts || precision < kF32 || precision > kI8) return -1;
  int64_t blocks = 0;
  for (int i = 0; i < n_parts; ++i) {
    const void* const* p = ptrs + i * kPtrs;
    const int64_t* n = ints + i * n_ints;
    Part& P = args.p[i];
    if (n[kNRows] < 0 || n[kNCols] < 0 || n[kNRows] > INT32_MAX / 2 ||
        n[kNCols] > INT32_MAX / 2 || (p[kXSs] == nullptr) != (p[kWOut] == nullptr) ||
        n[kStride] < (n[kNCols] + 7) / 8 || n[kStride] % kChunk != 0 ||
        reinterpret_cast<uintptr_t>(p[kPat]) % kChunk != 0 ||
        (blocked && (reinterpret_cast<uintptr_t>(p[kPartBuf]) % kChunk != 0 ||
                     n[kRowsPerBlock] < 1 || n[kRowsPerBlock] > INT32_MAX)) ||
        (precision == kI8 && (p[kScale] == nullptr || p[kXSs] != nullptr))) {
      return -1;
    }
    P.pat = static_cast<const uint8_t*>(p[kPat]);
    P.rv = static_cast<const float*>(p[kRv]);
    P.w_len = static_cast<const float*>(p[kWLen]);
    P.sv = static_cast<const float*>(p[kSv]);
    P.w_cov = static_cast<const float*>(p[kWCov]);
    P.w_out = static_cast<const float*>(p[kWOut]);
    P.scale = static_cast<const float*>(p[kScale]);
    P.scale_step = 2 * n_parts;
    P.y_fwd = static_cast<float*>(const_cast<void*>(p[kYFwd]));
    P.y_bwd = static_cast<float*>(const_cast<void*>(p[kYBwd]));
    P.x_ss = static_cast<float*>(const_cast<void*>(p[kXSs]));
    P.stride = n[kStride];
    P.n_rows = static_cast<int32_t>(n[kNRows]);
    P.n_cols = static_cast<int32_t>(n[kNCols]);
    P.n_rt = P.n_rows > 0 ? (P.n_rows + kTileRows - 1) / kTileRows : 1;
    P.n_ct = P.n_cols > 0 ? (P.n_cols + kTileCols - 1) / kTileCols : 1;
    const int64_t tiles = static_cast<int64_t>(P.n_rt) * P.n_ct;
    if (tiles > INT32_MAX / (kTileRows + kTileCols)) return -1;
    float* part = static_cast<float*>(const_cast<void*>(p[kPartBuf]));
    int32_t* counters = static_cast<int32_t*>(const_cast<void*>(p[kCounters]));
    P.fwd_part = part;
    if (blocked) {
      P.rows_per_block = static_cast<int32_t>(n[kRowsPerBlock]);
      P.groups = (P.n_rt + P.rows_per_block - 1) / P.rows_per_block;
      P.blocks = P.n_ct * P.groups;
      const int64_t fwd = P.n_ct > 1 ? static_cast<int64_t>(P.n_rt) * kTileRows * blocked_ld(P.n_ct)
                                     : 0;
      P.bwd_part = part + fwd;
    } else {
      P.blocks = static_cast<int32_t>(tiles);
      P.row_count = counters;
      P.bwd_part = part + tiles * kTileRows;
      P.col_count = counters + P.n_rt;
    }
    blocks += P.blocks;
  }
  return blocks > INT32_MAX ? -1 : blocks;
}

}  // namespace

extern "C" {

// One launch for `n_parts` (1 or 2) partitions on `stream` (PyTorch's
// current stream of `device`). `ptrs` holds kPtrs device pointers per
// part (order of the enum above; w_out and x_ss may be null together,
// and must be for int8; scale is read for int8 only), `ints` kInts int64
// per part. Each part's scratch holds n_rt * n_ct * (kTileRows +
// kTileCols) 4-byte values (row partials, then column partials) and n_rt
// + n_ct int32 counters (row stripes, then column stripes), with n_rt =
// max(1, ceil(n_rows / kTileRows)), n_ct = max(1, ceil(n_cols /
// kTileCols)). The pattern is a big-endian bitmap with rows of a multiple
// of 16 bytes, 16-byte aligned (ops/pattern.py pads every pattern).
// `precision`: 0 f32, 1 bf16, 2 int8. `n_windows` > 1: a stacked group
// of that many windows of the same shapes, each window's pattern,
// vectors, outputs, partials and counters right after the previous
// window's (the pointers given are window 0's; int8: the scales are
// [n_windows, 2 * n_parts], and each part's pointer is its first in
// window 0); the grid's y dimension is the window. Returns the CUDA
// error code of the
// launch (0 = launched). Allocates nothing and does not synchronize. One
// scratch must not be in flight on two streams at once.
int mr_pattern_pair(const void* const* ptrs, const int64_t* ints,
                    int32_t n_parts, int32_t precision, int32_t n_windows,
                    int device, void* stream) {
  Args args{};
  const int64_t blocks = read_parts(ptrs, ints, n_parts, precision, false, args);
  if (blocks < 0 || n_windows < 1 || n_windows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_windows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (precision == kBf16) {
    pattern_pair<kBf16><<<grid, kThreads, 0, s>>>(args);
  } else if (precision == kI8) {
    pattern_pair<kI8><<<grid, kThreads, 0, s>>>(args);
  } else {
    pattern_pair<kF32><<<grid, kThreads, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8: the packed_blocked pair (f32) for `n_parts` partitions, with
// mr_pattern_pair's `ptrs` (scale and counters ignored) and kBlockedInts
// int64 per part: mr_pattern_pair's three, then the row tiles a block
// walks (rows_per_block >= 1; groups = ceil(n_rt / rows_per_block)
// blocks per column tile). One launch of pattern_pair_blocked, then,
// where a part has more than one column tile or more than one group, one
// launch of fold_blocked. Each part's scratch, 16-byte aligned: the fwd
// partials, n_rt * kTileRows rows of blocked_ld(n_ct) floats (when n_ct
// > 1), then the bwd partials, n_rt rows of n_ct * kTileCols floats
// (when groups > 1). `n_windows` > 1: a stacked group, as for
// mr_pattern_pair, each window's scratch `blocked_scratch` floats after
// the previous window's; both launches take the window as the grid's y
// dimension. Returns the CUDA error code of the launches (0 =
// launched).
int mr_pattern_pair_blocked(const void* const* ptrs, const int64_t* ints, int32_t n_parts,
                            int32_t n_windows, int device, void* stream) {
  Args args{};
  const int64_t blocks = read_parts(ptrs, ints, n_parts, kF32, true, args);
  if (blocks < 0 || n_windows < 1 || n_windows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned win = static_cast<unsigned>(n_windows);
  pattern_pair_blocked<<<dim3(static_cast<unsigned>(blocks), win), kThreads, 0, s>>>(args);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  int64_t folds = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    folds += fwd_fold_blocks(args.p[i]) + bwd_fold_blocks(args.p[i]);
  }
  if (folds == 0) return 0;
  fold_blocked<<<dim3(static_cast<unsigned>(folds), win), kThreads, 0, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// One launch: scale[w][v] = amax > 0 ? amax / 127 (a subnormal quotient
// flushed to 0) : 1, amax = max_i
// |x[v][w][i] * w[v][w][i]|, for v < n_vecs (1 to 4) and w < n_windows
// (each pointer is a [n_windows, ns[v]] array; 1 for one window).
// `ptrs` holds x[0], w[0], x[1], w[1], ...; `ns` the vectors' lengths in
// one window. `scratch` is kMaxVecs * n_windows + 1 int32 (the running
// maxima, then the arrival count), zero before the first launch; the
// last block leaves it zero again. Returns the CUDA error code of the
// launch. Allocates nothing and does not synchronize.
int mr_quantize_amax(const void* const* ptrs, const int64_t* ns, int32_t n_vecs,
                     int32_t n_windows, void* scale, void* scratch, int device, void* stream) {
  if (n_vecs < 1 || n_vecs > kMaxVecs || n_windows < 1 || scale == nullptr ||
      scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AmaxArgs args{};
  int64_t longest = 0;
  for (int v = 0; v < kMaxVecs; ++v) {
    if (v < n_vecs) {
      if (ns[v] < 0 || ptrs[2 * v] == nullptr || ptrs[2 * v + 1] == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      args.x[v] = static_cast<const float*>(ptrs[2 * v]);
      args.w[v] = static_cast<const float*>(ptrs[2 * v + 1]);
      args.n[v] = ns[v];
      longest = ns[v] > longest ? ns[v] : longest;
    }
  }
  const int64_t per = (longest + int64_t{kThreads} * kAmaxItems - 1) / (int64_t{kThreads} * kAmaxItems);
  args.per_vec = static_cast<int32_t>(per < 1 ? 1 : (per > kAmaxMaxBlocks ? kAmaxMaxBlocks : per));
  args.n_vecs = n_vecs;
  args.n_windows = n_windows;
  args.scale = static_cast<float*>(scale);
  args.amax = static_cast<uint32_t*>(scratch);
  args.count = static_cast<uint32_t*>(scratch) + int64_t{kMaxVecs} * n_windows;
  const int64_t blocks = int64_t{n_vecs} * n_windows * args.per_vec;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(blocks));
  quantize_amax<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

const char* mr_pattern_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
