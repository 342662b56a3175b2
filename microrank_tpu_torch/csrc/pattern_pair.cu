// K2 and K4 on Hopper: the coverage matvec pair of the kind and packed
// power iterations, both partitions and both directions of a step in
// one launch.
//
// Replaces device programs that XLA wrote for the TPU in
// microrank_tpu/rank_backends/jax_tpu.py (`_partition_setup`):
//   K2, the kind branch's `cov_pair` (558-576): M is the int8 0/1
//       coverage pattern [V, K] over the kind-collapsed columns,
//       cast once to f32 or bf16 and multiplied twice per step;
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
// with op the identity (f32) or round-to-nearest-even to bf16
// (kind_precision="bf16", packed_bf16) applied to the f32 product, as
// JAX's `.astype(bfloat16)` does, and f32 accumulation. The packed
// branch also needs op(sv * w_out) for its call-graph term; the row
// folds write it as a side output (`x_ss`), which K1 then reads.
//
// One layout. Every pattern reaches this kernel as a big-endian bitmap
// (np.packbits order: column c is bit 7 - (c & 7) of byte c >> 3) whose
// rows are padded with zero bytes to a multiple of 16 bytes: ops/pattern.py
// `pattern_group` packs K2's int8 pattern once per window (nonzero -> 1).
//
// What bounds it on the card: bytes and latency, not the tensor cores.
// M is 0/1, so a product is a select and each cell costs at most one add;
// a matrix-vector product gives `wgmma` no reuse to work with. The bytes
// are the bitmap (2.9 MB at the uncollapsed config-5 shapes, 48 KB for
// the collapsed kind pattern) plus the vectors: about 1 us at 3.35 TB/s.
// What is left is latency: one global round trip for the tile, one for
// the operands, a fence and an atomic, one round trip per batch of a fold.
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
// There are no float atomics. Each block reads exactly one tile once, so
// there is no later load for an asynchronous copy (cp.async, TMA) to
// overlap with: the block's loads are all issued before its first use.
//
// What the previous design of this kernel spent its time on, 29 us per
// step for K4 and 14 us for K2 on an H100 against bounds of 0.94 and
// 0.12 us (PERF.md): (1) each 8-row fwd block recomputed every column
// operand, 57 KB of rv and w_len per block from L2 at 7,168 columns, and
// ran 8 shuffle trees per lane and tile; (2) the bwd was a serial chain
// per thread, a 64-row walk, one atomic per thread and a 48-chunk fold in
// six rounds of L2 loads; (3) K2's int8 pattern took its own load path,
// reading 8x the bytes of a bitmap for a 0/1 matrix.
//
// __fmul_rn / __fadd_rn keep the compiler from contracting into FMAs, so
// the plain version repeats this arithmetic exactly. Adding a product of
// a 0 cell would add +0.0, which leaves a sum's bits unchanged (a sum
// that starts at +0.0 is never -0.0), so selecting 0 gives the same bits.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/pattern.py build_command); bound with ctypes (plain C interface).

#include <cstdint>

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
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTileRows <= kThreads, "a fold thread per tile row");
static_assert(kColsPerThread == 2, "bwd partials are stored as float2");
static_assert(kTileRows * kChunksPerRow % kThreads == 0, "whole loads per thread");
static_assert(kRowsPerWarp % kRowBatch == 0, "whole row batches per warp");

// One partition's pattern, vectors and scratch (ops/pattern.py
// PatternPart / pattern_pair_group).
struct Part {
  const uint8_t* pat;     // [n_rows, stride] bitmap rows
  const float* rv;        // [n_cols]
  const float* w_len;     // [n_cols]
  const float* sv;        // [n_rows]
  const float* w_cov;     // [n_rows]
  const float* w_out;     // [n_rows], or null: no x_ss
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

struct alignas(16) Smem {
  uint32_t bits[kTileRows][kTileWords];  // bit i of word w: column 32w + i
  float a[kTileCols];                    // op(rv * w_len), 0 past n_cols
  float b[kTileRows];                    // op(sv * w_cov), 0 past n_rows
  float y_rows[kTileRows];               // the tile's fwd sum of each row
  int last[2];                           // last arriver of the row / column stripe
};

template <bool kBf16>
__device__ __forceinline__ float op(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// A loaded word of big-endian bytes in column order: bit 8k + j of the
// result is bit 7 - j of byte k (column 8k + j).
__device__ __forceinline__ uint32_t column_order(uint32_t w) {
  return __brev(__byte_perm(w, 0u, 0x0123u));
}

// Adds b to acc when bit k of m is set. A select, not a branch: a
// branch per cell would keep the compiler from issuing later loads
// ahead of it. Adding +0.0 leaves the sum's bits unchanged.
__device__ __forceinline__ float add_if(float acc, uint32_t m, int k, float b) {
  return __fadd_rn(acc, ((m >> k) & 1u) ? b : 0.0f);
}

// Folds n partials p[0], p[step], ... left to right from 0, loading a
// batch at a time from L2 (L1 is not coherent across SMs): one row's
// column-tile sums (fwd), or two columns' row-tile sums (bwd).
__device__ __forceinline__ float fold(const float* p, int64_t step, int32_t n) {
  float y = 0.0f;
  for (int32_t j0 = 0; j0 < n; j0 += kFoldBatch) {
    float v[kFoldBatch];
#pragma unroll
    for (int i = 0; i < kFoldBatch; ++i) v[i] = __ldcg(p + min(j0 + i, n - 1) * step);
#pragma unroll
    for (int i = 0; i < kFoldBatch; ++i) {
      if (j0 + i < n) y = __fadd_rn(y, v[i]);
    }
  }
  return y;
}

__device__ __forceinline__ float2 fold(const float2* p, int64_t step, int32_t n) {
  float2 y = make_float2(0.0f, 0.0f);
  for (int32_t j0 = 0; j0 < n; j0 += kFoldBatch) {
    float2 v[kFoldBatch];
#pragma unroll
    for (int i = 0; i < kFoldBatch; ++i) v[i] = __ldcg(p + min(j0 + i, n - 1) * step);
#pragma unroll
    for (int i = 0; i < kFoldBatch; ++i) {
      if (j0 + i < n) {
        y.x = __fadd_rn(y.x, v[i].x);
        y.y = __fadd_rn(y.y, v[i].y);
      }
    }
  }
  return y;
}

template <bool kBf16>
__device__ __forceinline__ void write_row(const Part& P, int32_t r, float y) {
  if (r >= P.n_rows) return;
  P.y_fwd[r] = y;
  if (P.x_ss != nullptr) P.x_ss[r] = op<kBf16>(__fmul_rn(__ldg(P.sv + r), __ldg(P.w_out + r)));
}

__device__ __forceinline__ void write_cols(const Part& P, int32_t c, float2 y) {
  if (c < P.n_cols) P.y_bwd[c] = y.x;
  if (c + 1 < P.n_cols) P.y_bwd[c + 1] = y.y;
}

// One tile of one partition. Every branch before the last __syncthreads
// is block-uniform.
template <bool kBf16>
__device__ __forceinline__ void tile(const Part& P, int32_t block, Smem& s) {
  const int t = static_cast<int>(threadIdx.x);
  const int32_t rt = block / P.n_ct;
  const int32_t ct = block - rt * P.n_ct;
  const int32_t r0 = rt * kTileRows;
  const int32_t c0 = ct * kTileCols;

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
  float a[kColsPerThread];
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) {
    const int32_t c = c0 + t + i * kThreads;
    a[i] = c < P.n_cols ? op<kBf16>(__fmul_rn(__ldg(P.rv + c), __ldg(P.w_len + c))) : 0.0f;
  }
  float b = 0.0f;
  if (t < kTileRows && r0 + t < P.n_rows) {
    b = op<kBf16>(__fmul_rn(__ldg(P.sv + r0 + t), __ldg(P.w_cov + r0 + t)));
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
    float al[kLaneCols];
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) al[j] = s.a[lane * kLaneCols + j];
    const uint16_t* halves = reinterpret_cast<const uint16_t*>(&s.bits[0][0]);
#pragma unroll
    for (int i0 = 0; i0 < kRowsPerWarp; i0 += kRowBatch) {
      uint32_t m[kRowBatch];
      float acc[kRowBatch];
#pragma unroll
      for (int q = 0; q < kRowBatch; ++q) {
        m[q] = halves[(warp + kWarps * (i0 + q)) * kTileWords * 2 + lane];
        acc[q] = 0.0f;
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
          acc[q] = __fadd_rn(acc[q], __shfl_down_sync(kFull, acc[q], off));
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kRowBatch; ++q) s.y_rows[warp + kWarps * (i0 + q)] = acc[q];
      }
    }
  }

  // 4. bwd: thread t, columns 2t and 2t + 1, rows in ascending order.
  float2 col = make_float2(0.0f, 0.0f);
  {
    const int word = (kColsPerThread * t) / 32;
    const int shift = (kColsPerThread * t) % 32;
#pragma unroll 16
    for (int row = 0; row < kTileRows; ++row) {
      const uint32_t m = s.bits[row][word] >> shift;
      const float br = s.b[row];
      col.x = add_if(col.x, m, 0, br);
      col.y = add_if(col.y, m, 1, br);
    }
  }
  __syncthreads();  // s.y_rows complete

  // 5. A stripe of one tile writes its result; else publish the partial.
  const int32_t c = c0 + kColsPerThread * t;
  if (P.n_ct == 1) {
    if (t < kTileRows) write_row<kBf16>(P, r0 + t, s.y_rows[t]);
  } else if (t < kTileRows) {
    __stcg(P.fwd_part + static_cast<int64_t>(ct) * P.n_rt * kTileRows + r0 + t, s.y_rows[t]);
  }
  if (P.n_rt == 1) {
    write_cols(P, c, col);
  } else {
    __stcg(reinterpret_cast<float2*>(P.bwd_part + static_cast<int64_t>(rt) * P.n_ct * kTileCols + c),
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
      write_row<kBf16>(P, r0 + t,
                       fold(P.fwd_part + r0 + t, static_cast<int64_t>(P.n_rt) * kTileRows, P.n_ct));
    }
    if (t == 0) P.row_count[rt] = 0;  // ready for the next launch on this scratch
  }
  if (last_col) {
    // The column stripe's row tiles, top to bottom.
    const int64_t step = static_cast<int64_t>(P.n_ct) * kTileCols / 2;  // float2s per row tile
    write_cols(P, c, fold(reinterpret_cast<const float2*>(P.bwd_part + c), step, P.n_rt));
    if (t == 0) P.col_count[ct] = 0;
  }
}

// Blocks in order: the tiles of part 0, then of part 1 (an absent part
// has 0 blocks). The branch is block-uniform; each call names its part
// statically, so the argument struct is read from parameter space and
// never copied.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads) pattern_pair(Args args) {
  __shared__ Smem s;
  const int32_t b = static_cast<int32_t>(blockIdx.x);
  if (b < args.p[0].blocks) {
    tile<kBf16>(args.p[0], b, s);
  } else {
    tile<kBf16>(args.p[1], b - args.p[0].blocks, s);
  }
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: make it `device` (a no-op after the first call).
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t got = cudaGetDevice(&current);
  if (got == cudaSuccess && current == device) return cudaSuccess;
  return cudaSetDevice(device);
}

enum { kPat, kRv, kWLen, kSv, kWCov, kWOut, kYFwd, kYBwd, kXSs, kPartBuf,
       kCounters, kPtrs };
enum { kStride, kNRows, kNCols, kInts };

}  // namespace

extern "C" {

// One launch for `n_parts` (1 or 2) partitions on `stream` (PyTorch's
// current stream of `device`). `ptrs` holds kPtrs device pointers per
// part (order of the enum above; w_out and x_ss may be null together),
// `ints` kInts int64 per part. Each part's scratch holds n_rt * n_ct *
// (kTileRows + kTileCols) floats (row partials, then column partials)
// and n_rt + n_ct int32 counters (row stripes, then column stripes), with
// n_rt = max(1, ceil(n_rows / kTileRows)), n_ct = max(1, ceil(n_cols /
// kTileCols)). `bits` must be 1: the pattern is a big-endian bitmap with
// rows of a multiple of 16 bytes, 16-byte aligned (ops/pattern.py packs
// and pads every pattern). `bf16`: round operands to bf16. Returns the
// CUDA error code of the launch (0 = launched). Allocates nothing and
// does not synchronize. One scratch must not be in flight on two streams
// at once.
int mr_pattern_pair(const void* const* ptrs, const int64_t* ints,
                    int32_t n_parts, int32_t bits, int32_t bf16,
                    int device, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || bits != 1) {
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
        reinterpret_cast<uintptr_t>(p[kPat]) % kChunk != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    P.pat = static_cast<const uint8_t*>(p[kPat]);
    P.rv = static_cast<const float*>(p[kRv]);
    P.w_len = static_cast<const float*>(p[kWLen]);
    P.sv = static_cast<const float*>(p[kSv]);
    P.w_cov = static_cast<const float*>(p[kWCov]);
    P.w_out = static_cast<const float*>(p[kWOut]);
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
  if (bf16) {
    pattern_pair<true><<<grid, kThreads, 0, s>>>(args);
  } else {
    pattern_pair<false><<<grid, kThreads, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mr_pattern_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
