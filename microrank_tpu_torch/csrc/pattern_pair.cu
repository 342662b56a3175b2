// K2 and K4 on Hopper: the coverage matvec pair of the kind and packed
// power iterations, both partitions and both directions of a step in
// one launch.
//
// Replaces two device programs that XLA wrote for the TPU in
// microrank_tpu/rank_backends/jax_tpu.py (`_partition_setup`):
//   K2, the kind branch's `cov_pair` (558-576): M is the int8 0/1
//       coverage pattern [V, K] over the kind-collapsed columns,
//       cast once to f32 or bf16 and multiplied twice per step;
//   K4, the packed branch's coverage pair (419-480): M is the coverage
//       bitmap uint8 [V, ceil(T/8)] (np.packbits order: column t is bit
//       7 - (t & 7) of byte t >> 3), unpacked once per program into a
//       dense f32 / bf16 [V, T] matrix (`unpack_bits`, 112-123).
// Both compute, per partition,
//   y_fwd[r] = sum_c M[r, c] * op(rv[c] * w_len[c])    (p_sr @ rv)
//   y_bwd[c] = sum_r op(sv[r] * w_cov[r]) * M[r, c]    (p_rs @ sv)
// with op the identity (f32) or round-to-nearest-even to bf16
// (kind_precision="bf16", packed_bf16) applied to the f32 product, as
// JAX's `.astype(bfloat16)` does, and f32 accumulation. The packed
// branch also needs op(sv * w_out) for its call-graph term; the row
// warps write it as a side output (`x_ss`), which K1 then reads.
//
// What bounds it on the card: bytes and latency. M is 0/1, so a
// product is a select and each matrix cell costs at most one add, far
// below the H100's float rate per byte; tensor cores do not apply to a
// matrix-vector product. The bytes are the pattern (bits: V * T / 8,
// 2.9 MB at the uncollapsed config-5 shapes; int8: V * K, 0.32 MB
// collapsed) plus the vectors. The design never builds the unpacked
// matrix: bits are decoded in registers, so a step reads the pattern
// once per direction, 8x fewer bytes than the dense bf16 matrix JAX
// streams per product.
//
// Columns go in groups of 8 (one bitmap byte, or 8 int8 bytes). Both
// layouts go through `group_mask`, which returns a group's 8 cells of
// one row as bits 0..7 with one unconditional load (the wrapper pads
// int8 rows to whole groups). The walks below are bound by load latency
// at these sizes, so their loops are unrolled to keep several rows' or
// groups' loads in flight.
//
// fwd: one block per 8 rows. The columns go in tiles of 32 groups (256
// columns); warp w takes tiles w, w + 8, ..., lane l the tile's group l.
// A lane reads its 8 operands once for all 8 rows and adds each row's
// set columns in ascending order; the shuffle tree 16, 8, 4, 2, 1 (K1's)
// gives the tile's sum, which the warp adds to its running "slot" sum,
// ((0 + t_w) + t_{w+8}) ...; the block then folds its 8 slot sums in
// slot order through shared memory. The order of every sum depends on
// the column index alone, so two equal pattern rows give bitwise-equal
// sums. (The first design walked a row's 28 tiles in one warp; that
// serial walk took 34 of the 45 us per step at the uncollapsed config-5
// shapes, chip_smoke's sweep.)
//
// bwd: one thread per (row chunk, group). A chunk is kRowChunk rows;
// the thread adds op(sv * w_cov)[r] into 8 column sums, rows in
// ascending order. Chunk sums are stored to L2, counted on an integer
// counter per group, and the last thread to arrive folds the chunks
// left to right, ((0 + c0) + c1) ..., writes y_bwd and resets the
// counter for the next launch: K1's fold, with no float atomics. The
// order depends on the row index alone, so equal columns (traces of one
// kind in the uncollapsed layout) give bitwise-equal sums.
//
// __fmul_rn / __fadd_rn keep the compiler from contracting into FMAs,
// so the plain version in ops/pattern.py repeats this arithmetic
// exactly. Adding a product of a 0 cell would add +0.0, which leaves a
// non-negative sum unchanged, so skipping 0 cells gives the same bits.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/pattern.py build_command); bound with ctypes (plain C interface).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kRowsPerWarp = 8;   // fwd rows per block (<= kThreads)
constexpr int kGroup = 8;        // columns per group (one bitmap byte)
constexpr int kRowChunk = 64;    // ops/pattern.py ROW_CHUNK: it fixes the bits
constexpr int kRowBatch = 16;    // bwd rows whose loads are issued together
constexpr int kFoldBatch = 8;    // partial sums a fold loads together
constexpr int kMaxParts = 2;
constexpr unsigned kFull = 0xffffffffu;

// One partition's pattern, vectors and scratch (ops/pattern.py
// PatternGroup / pattern_pair_group).
struct Part {
  const uint8_t* pat;     // [n_rows, stride] bytes
  const float* rv;        // [n_cols]
  const float* w_len;     // [n_cols]
  const float* sv;        // [n_rows]
  const float* w_cov;     // [n_rows]
  const float* w_out;     // [n_rows], or null: no x_ss
  float* y_fwd;           // [n_rows]
  float* y_bwd;           // [n_cols]
  float* x_ss;            // [n_rows], or null
  float* part;            // [n_chunks * n_groups * kGroup] bwd chunk sums
  int32_t* counters;      // [n_groups] chunk arrivals, 0 between launches
  int64_t stride;         // bytes per pattern row
  int32_t n_rows;
  int32_t n_cols;
  int32_t n_groups;
  int32_t n_tiles;        // fwd column tiles of kWarp groups
  int32_t n_chunks;
  int32_t fwd_blocks;
  int32_t bwd_blocks;
};

struct Args {
  Part p[kMaxParts];
};

template <bool kBf16>
__device__ __forceinline__ float op(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// The 8 cells of group g in row r as bits 0..7 (bit k = column 8g + k),
// columns at or past n_cols cleared.
template <bool kBits>
__device__ __forceinline__ uint32_t group_mask(const Part& P, int32_t r,
                                               int32_t g) {
  const uint8_t* row = P.pat + static_cast<int64_t>(r) * P.stride;
  const int32_t c0 = g * kGroup;
  uint32_t m = 0;
  if constexpr (kBits) {
    // Big-endian in the byte: column c0 + k is bit 7 - k.
    m = __brev(static_cast<uint32_t>(__ldg(row + g))) >> 24;
  } else {
    // The wrapper pads int8 rows to whole, 8-byte aligned groups, so
    // one unconditional 8-byte load reads the group.
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + c0));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      m |= (((v.x >> (8 * k)) & 0xffu) != 0u ? 1u : 0u) << k;
      m |= (((v.y >> (8 * k)) & 0xffu) != 0u ? 1u : 0u) << (k + 4);
    }
  }
  const int32_t live = P.n_cols - c0;
  if (live < kGroup) m &= (1u << live) - 1u;
  return m;
}

__device__ __forceinline__ float warp_tree(float acc) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, off));
  }
  return acc;
}

// Adds b to acc when bit k of m is set. A select, not a branch: a
// branch per cell would keep the compiler from issuing later loads
// ahead of it. Adding +0.0 leaves a non-negative sum's bits unchanged.
__device__ __forceinline__ float add_if(float acc, uint32_t m, int k, float b) {
  return __fadd_rn(acc, ((m >> k) & 1u) ? b : 0.0f);
}

template <bool kBits, bool kBf16>
__device__ __forceinline__ void fwd(const Part& P, int32_t block) {
  __shared__ float slot_sums[kWarpsPerBlock][kRowsPerWarp];
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int32_t r0 = block * kRowsPerWarp;  // block-uniform
  // Warp w takes tiles w, w + 8, ...; lane l the tile's group l. Each
  // round issues every load before its first add (indices clamped into
  // range, their contributions zeroed); the tile's sum of each row comes
  // from the shuffle tree and is added to the warp's running slot sum.
  float slot[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) slot[q] = 0.0f;
#pragma unroll 2
  for (int32_t tile = warp; tile < P.n_tiles; tile += kWarpsPerBlock) {
    const int32_t g = tile * kWarp + lane;
    const bool live_g = g < P.n_groups;
    const int32_t gg = min(g, P.n_groups - 1);
    float a[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int32_t c = min(gg * kGroup + k, P.n_cols - 1);
      a[k] = op<kBf16>(__fmul_rn(__ldg(P.rv + c), __ldg(P.w_len + c)));
    }
    uint32_t m[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      m[q] = group_mask<kBits>(P, min(r0 + q, P.n_rows - 1), gg);
      if (!live_g || r0 + q >= P.n_rows) m[q] = 0u;
    }
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) acc = add_if(acc, m[q], k, a[k]);
      slot[q] = __fadd_rn(slot[q], warp_tree(acc));
    }
  }
  // Lane 0 holds the slot sums; the block folds its 8 slots in order.
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) slot_sums[warp][q] = slot[q];
  }
  __syncthreads();
  const int32_t r = r0 + static_cast<int32_t>(threadIdx.x);
  if (threadIdx.x >= kRowsPerWarp || r >= P.n_rows) return;
  float y = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarpsPerBlock; ++w) y = __fadd_rn(y, slot_sums[w][threadIdx.x]);
  P.y_fwd[r] = y;
  if (P.x_ss != nullptr) {
    P.x_ss[r] = op<kBf16>(__fmul_rn(__ldg(P.sv + r), __ldg(P.w_out + r)));
  }
}

template <bool kBits, bool kBf16>
__device__ __forceinline__ void bwd(const Part& P, int32_t block) {
  const int32_t t = block * kThreads + static_cast<int32_t>(threadIdx.x);
  if (t >= P.n_chunks * P.n_groups) return;
  const int32_t chunk = t / P.n_groups;
  const int32_t g = t - chunk * P.n_groups;
  const int32_t r_begin = chunk * kRowChunk;
  const int32_t r_end = min(P.n_rows, r_begin + kRowChunk);
  float acc[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) acc[k] = 0.0f;
  // Rows in batches: the batch's loads first (rows clamped into range,
  // rows past the chunk zeroed), then its adds in row order.
  for (int32_t rb = r_begin; rb < r_end; rb += kRowBatch) {
    uint32_t m[kRowBatch];
    float b[kRowBatch];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      const int32_t r = min(rb + i, r_end - 1);
      m[i] = group_mask<kBits>(P, r, g);
      b[i] = op<kBf16>(__fmul_rn(__ldg(P.sv + r), __ldg(P.w_cov + r)));
      if (rb + i >= r_end) m[i] = 0u;
    }
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) acc[k] = add_if(acc[k], m[i], k, b[i]);
    }
  }
  const int32_t c0 = g * kGroup;
  if (P.n_chunks == 1) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (c0 + k < P.n_cols) P.y_bwd[c0 + k] = acc[k];
    }
    return;
  }
  // Several chunks: publish this chunk's sums, then count the arrival.
  float4* mine = reinterpret_cast<float4*>(P.part + static_cast<int64_t>(t) * kGroup);
  __stcg(mine, make_float4(acc[0], acc[1], acc[2], acc[3]));
  __stcg(mine + 1, make_float4(acc[4], acc[5], acc[6], acc[7]));
  __threadfence();
  if (atomicAdd(P.counters + g, 1) != P.n_chunks - 1) return;
  __threadfence();  // acquire the other chunks' sums
  // The last arriver folds chunks 0 .. n_chunks-1 left to right, reading
  // from L2 (L1 is not coherent across SMs), a batch of chunks at once.
  float y[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) y[k] = 0.0f;
  const float4* col = reinterpret_cast<const float4*>(P.part) + static_cast<int64_t>(g) * 2;
  const int64_t step = static_cast<int64_t>(P.n_groups) * 2;  // float4s per chunk
  for (int32_t j0 = 0; j0 < P.n_chunks; j0 += kFoldBatch) {
    float4 lo[kFoldBatch], hi[kFoldBatch];
#pragma unroll
    for (int i = 0; i < kFoldBatch; ++i) {
      const int32_t j = min(j0 + i, P.n_chunks - 1);
      lo[i] = __ldcg(col + j * step);
      hi[i] = __ldcg(col + j * step + 1);
    }
#pragma unroll
    for (int i = 0; i < kFoldBatch; ++i) {
      if (j0 + i < P.n_chunks) {
        y[0] = __fadd_rn(y[0], lo[i].x);
        y[1] = __fadd_rn(y[1], lo[i].y);
        y[2] = __fadd_rn(y[2], lo[i].z);
        y[3] = __fadd_rn(y[3], lo[i].w);
        y[4] = __fadd_rn(y[4], hi[i].x);
        y[5] = __fadd_rn(y[5], hi[i].y);
        y[6] = __fadd_rn(y[6], hi[i].z);
        y[7] = __fadd_rn(y[7], hi[i].w);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if (c0 + k < P.n_cols) P.y_bwd[c0 + k] = y[k];
  }
  P.counters[g] = 0;  // ready for the next launch on this scratch
}

// Blocks in order: fwd of part 0, fwd of part 1, bwd of part 0, bwd of
// part 1 (a part that is absent has 0 blocks). The branch is
// block-uniform; each call names its part statically, so the argument
// struct is read from parameter space and never copied.
template <bool kBits, bool kBf16>
__global__ void __launch_bounds__(kThreads)
pattern_pair(Args args) {
  int32_t b = static_cast<int32_t>(blockIdx.x);
  if (b < args.p[0].fwd_blocks) return fwd<kBits, kBf16>(args.p[0], b);
  b -= args.p[0].fwd_blocks;
  if (b < args.p[1].fwd_blocks) return fwd<kBits, kBf16>(args.p[1], b);
  b -= args.p[1].fwd_blocks;
  if (b < args.p[0].bwd_blocks) return bwd<kBits, kBf16>(args.p[0], b);
  b -= args.p[0].bwd_blocks;
  if (b < args.p[1].bwd_blocks) return bwd<kBits, kBf16>(args.p[1], b);
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
// `ints` kInts int64 per part. `bits`: the pattern is a big-endian
// bitmap (else int8 bytes); `bf16`: round operands to bf16. Returns the
// CUDA error code of the launch (0 = launched). Allocates nothing and
// does not synchronize. One scratch (part, counters) must not be in
// flight on two streams at once.
int mr_pattern_pair(const void* const* ptrs, const int64_t* ints,
                    int32_t n_parts, int32_t bits, int32_t bf16,
                    int device, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args{};
  int64_t blocks = 0;
  for (int i = 0; i < n_parts; ++i) {
    const void* const* p = ptrs + i * kPtrs;
    const int64_t* n = ints + i * kInts;
    Part& P = args.p[i];
    P.pat = static_cast<const uint8_t*>(p[kPat]);
    P.rv = static_cast<const float*>(p[kRv]);
    P.w_len = static_cast<const float*>(p[kWLen]);
    P.sv = static_cast<const float*>(p[kSv]);
    P.w_cov = static_cast<const float*>(p[kWCov]);
    P.w_out = static_cast<const float*>(p[kWOut]);
    P.y_fwd = static_cast<float*>(const_cast<void*>(p[kYFwd]));
    P.y_bwd = static_cast<float*>(const_cast<void*>(p[kYBwd]));
    P.x_ss = static_cast<float*>(const_cast<void*>(p[kXSs]));
    P.part = static_cast<float*>(const_cast<void*>(p[kPartBuf]));
    P.counters = static_cast<int32_t*>(const_cast<void*>(p[kCounters]));
    P.stride = n[kStride];
    // int8 rows must hold whole, 8-byte aligned groups (ops/pattern.py
    // pads them), bitmap rows one byte per group.
    const int64_t groups = (n[kNCols] + kGroup - 1) / kGroup;
    if (P.stride < (bits ? groups : groups * kGroup) ||
        (!bits && (P.stride % kGroup != 0 ||
                   reinterpret_cast<uintptr_t>(P.pat) % kGroup != 0))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n[kNRows] < 0 || n[kNCols] < 0 || n[kNRows] > INT32_MAX / 2 ||
        n[kNCols] > INT32_MAX / 2 || (P.x_ss == nullptr) != (P.w_out == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    P.n_rows = static_cast<int32_t>(n[kNRows]);
    P.n_cols = static_cast<int32_t>(n[kNCols]);
    P.n_groups = (P.n_cols + kGroup - 1) / kGroup;
    P.n_tiles = (P.n_groups + kWarp - 1) / kWarp;  // 0 columns: y_fwd = 0
    P.n_chunks = P.n_rows > 0 ? (P.n_rows + kRowChunk - 1) / kRowChunk : 1;
    P.fwd_blocks = (P.n_rows + kRowsPerWarp - 1) / kRowsPerWarp;
    const int64_t bwd_threads =
        static_cast<int64_t>(P.n_chunks) * P.n_groups;
    if (bwd_threads > INT32_MAX - kThreads) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    P.bwd_blocks = static_cast<int32_t>((bwd_threads + kThreads - 1) / kThreads);
    blocks += P.fwd_blocks + P.bwd_blocks;
  }
  if (blocks == 0) return 0;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits && bf16) {
    pattern_pair<true, true><<<grid, kThreads, 0, s>>>(args);
  } else if (bits) {
    pattern_pair<true, false><<<grid, kThreads, 0, s>>>(args);
  } else if (bf16) {
    pattern_pair<false, true><<<grid, kThreads, 0, s>>>(args);
  } else {
    pattern_pair<false, false><<<grid, kThreads, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mr_pattern_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
