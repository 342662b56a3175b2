// K2 and K4 on Hopper: the coverage matvec pair of the kind and packed
// power iterations, both partitions and both directions of a step in
// one launch; and, for kind_precision="int8", the launch before it that
// finds the step's quantization scales.
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
// K8, the packed_blocked branch (605-646), is K4 in f32 on windows whose
// unpacked matrices exceed the dense budget: XLA streamed column blocks
// of the bitmap so as never to hold the whole unpacked matrix. This
// kernel never unpacks, so it runs packed_blocked as it runs packed.
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
// per batch of a fold. int8 adds a launch per step (the scales) and, per
// operand, one division.
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
// with: the block's loads are all issued before its first use.
//
// The int8 scales (`quantize_amax`): scale = amax > 0 ? amax / 127 : 1
// with amax = max |x * w| over each of the step's four weighted operands
// (both partitions, both directions), as JAX's `quantize_i8`. A NaN amax
// fails `amax > 0` and gives 1, as there. One launch covers the four
// vectors: each block takes a strided slice of one vector, reduces the
// bit patterns of |x * w| (non-negative floats order as their unsigned
// bits; a NaN's bits exceed every number's, so it wins as jnp.max's NaN
// does) and folds them in with an integer atomicMax, which is exact and
// order-free; the last block to arrive turns the four maxima into
// scales and resets the scratch for the next launch. The pair reads the
// scales in stream order. A grid-wide barrier (a cooperative launch)
// would fold this into the pair's launch; two plain launches were
// chosen as the simple kernel that is right.
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
  int32_t blocks;         // n_rt * n_ct
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

// op(x * w) in the precision's operand type; `scale` is read for int8
// only.
template <int kPrec>
__device__ __forceinline__ Acc<kPrec> operand(float x, float w, float scale) {
  const float p = __fmul_rn(x, w);
  if constexpr (kPrec == kBf16) {
    return __bfloat162float(__float2bfloat16_rn(p));
  } else if constexpr (kPrec == kI8) {
    return static_cast<int32_t>(fminf(fmaxf(rintf(__fdiv_rn(p, scale)), -127.0f), 127.0f));
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

// Blocks in order: the tiles of part 0, then of part 1 (an absent part
// has 0 blocks). The branch is block-uniform; each call names its part
// statically, so the argument struct is read from parameter space and
// never copied.
template <int kPrec>
__global__ void __launch_bounds__(kThreads) pattern_pair(Args args) {
  __shared__ Smem<Acc<kPrec>> s;
  const int32_t b = static_cast<int32_t>(blockIdx.x);
  if (b < args.p[0].blocks) {
    tile<kPrec>(args.p[0], b, s);
  } else {
    tile<kPrec>(args.p[1], b - args.p[0].blocks, s);
  }
}

// The int8 scales of one step's operands x[v] * w[v], v < n_vecs
// (ops/pattern.py quantize_scales).
struct AmaxArgs {
  const float* x[kMaxVecs];
  const float* w[kMaxVecs];
  int64_t n[kMaxVecs];
  float* scale;      // [n_vecs]
  uint32_t* amax;    // [kMaxVecs] running maxima (f32 bits), 0 between launches
  uint32_t* count;   // block arrivals, 0 between launches
  int32_t n_vecs;
  int32_t per_vec;   // blocks per vector
};

__global__ void __launch_bounds__(kThreads) quantize_amax(AmaxArgs args) {
  __shared__ uint32_t warp_max[kWarps];
  __shared__ int last;
  const int t = static_cast<int>(threadIdx.x);
  const int v = static_cast<int>(blockIdx.x) / args.per_vec;
  const int64_t j = static_cast<int64_t>(blockIdx.x) - static_cast<int64_t>(v) * args.per_vec;
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
  uint32_t m = 0u;
  const int64_t stride = static_cast<int64_t>(args.per_vec) * kThreads;
  for (int64_t i = j * kThreads + t; i < n; i += stride) {
    m = max(m, __float_as_uint(fabsf(__fmul_rn(__ldg(x + i), __ldg(w + i)))));
  }
  m = __reduce_max_sync(kFull, m);
  if (t % kWarp == 0) warp_max[t / kWarp] = m;
  __syncthreads();
  if (t == 0) {
    uint32_t bm = 0u;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) bm = max(bm, warp_max[i]);
    atomicMax(args.amax + v, bm);
    __threadfence();  // release the maximum before arriving
    last = atomicAdd(args.count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // acquire every block's maximum
  if (t < args.n_vecs) {
    const float amax = __uint_as_float(atomicExch(args.amax + t, 0u));  // read and reset
    args.scale[t] = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
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
// `precision`: 0 f32, 1 bf16, 2 int8. Returns the CUDA error code of the
// launch (0 = launched). Allocates nothing and does not synchronize. One
// scratch must not be in flight on two streams at once.
int mr_pattern_pair(const void* const* ptrs, const int64_t* ints,
                    int32_t n_parts, int32_t precision,
                    int device, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || precision < kF32 || precision > kI8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args{};
  int64_t blocks = 0;
  for (int i = 0; i < n_parts; ++i) {
    const void* const* p = ptrs + i * kPtrs;
    const int64_t* n = ints + i * kInts;
    Part& P = args.p[i];
    if (n[kNRows] < 0 || n[kNCols] < 0 || n[kNRows] > INT32_MAX / 2 ||
        n[kNCols] > INT32_MAX / 2 || (p[kXSs] == nullptr) != (p[kWOut] == nullptr) ||
        n[kStride] < (n[kNCols] + 7) / 8 || n[kStride] % kChunk != 0 ||
        reinterpret_cast<uintptr_t>(p[kPat]) % kChunk != 0 ||
        (precision == kI8 && (p[kScale] == nullptr || p[kXSs] != nullptr))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    P.pat = static_cast<const uint8_t*>(p[kPat]);
    P.rv = static_cast<const float*>(p[kRv]);
    P.w_len = static_cast<const float*>(p[kWLen]);
    P.sv = static_cast<const float*>(p[kSv]);
    P.w_cov = static_cast<const float*>(p[kWCov]);
    P.w_out = static_cast<const float*>(p[kWOut]);
    P.scale = static_cast<const float*>(p[kScale]);
    P.y_fwd = static_cast<float*>(const_cast<void*>(p[kYFwd]));
    P.y_bwd = static_cast<float*>(const_cast<void*>(p[kYBwd]));
    P.x_ss = static_cast<float*>(const_cast<void*>(p[kXSs]));
    P.stride = n[kStride];
    P.n_rows = static_cast<int32_t>(n[kNRows]);
    P.n_cols = static_cast<int32_t>(n[kNCols]);
    P.n_rt = P.n_rows > 0 ? (P.n_rows + kTileRows - 1) / kTileRows : 1;
    P.n_ct = P.n_cols > 0 ? (P.n_cols + kTileCols - 1) / kTileCols : 1;
    const int64_t tiles = static_cast<int64_t>(P.n_rt) * P.n_ct;
    if (tiles > INT32_MAX / (kTileRows + kTileCols)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    P.blocks = static_cast<int32_t>(tiles);
    float* part = static_cast<float*>(const_cast<void*>(p[kPartBuf]));
    P.fwd_part = part;
    P.bwd_part = part + tiles * kTileRows;
    int32_t* counters = static_cast<int32_t*>(const_cast<void*>(p[kCounters]));
    P.row_count = counters;
    P.col_count = counters + P.n_rt;
    blocks += tiles;
  }
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(blocks));
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

// One launch: scale[v] = amax > 0 ? amax / 127 : 1, amax = max_i |x[v][i]
// * w[v][i]|, for v < n_vecs (1 to 4). `ptrs` holds x[0], w[0], x[1],
// w[1], ...; `ns` the vectors' lengths. `scratch` is kMaxVecs + 1 int32
// (the running maxima, then the arrival count), zero before the first
// launch; the last block leaves it zero again. Returns the CUDA error
// code of the launch. Allocates nothing and does not synchronize.
int mr_quantize_amax(const void* const* ptrs, const int64_t* ns, int32_t n_vecs,
                     void* scale, void* scratch, int device, void* stream) {
  if (n_vecs < 1 || n_vecs > kMaxVecs || scale == nullptr || scratch == nullptr) {
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
  args.scale = static_cast<float*>(scale);
  args.amax = static_cast<uint32_t*>(scratch);
  args.count = static_cast<uint32_t*>(scratch) + kMaxVecs;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(n_vecs * args.per_vec));
  quantize_amax<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

const char* mr_pattern_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
